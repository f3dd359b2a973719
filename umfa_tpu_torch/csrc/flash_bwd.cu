// Dense flash-attention backward (dQ, then dK/dV) for Hopper, sm_90a.
//
// Replaces umfa_tpu/ops/flash_bwd.py:84 `_dq_kernel` and flash_bwd.py:336
// `_dkv_kernel` (host `flash_attention_backward`, flash_bwd.py:825), with
// their block-sparse walks (a map given: the bodies' SPARSE instantiations;
// dQ walks fetch_kv, dK/dV each query head's row of fetch_q, :369-402,
// unwalked pairs hidden, the bias read only where a tile is not FULL). The host wrapper (ops/flash_bwd.py) computes
// delta = rowsum(dO∘O) − dlse in fp32, gives fully masked rows LSE +1e30
// (their P, and so their gradients, are exactly 0), and casts dO to the
// input type, as the reference does outside its kernels.
//
// What bounds it on this card: at the training shape (B8 Hq16 Hkv8, causal
// S 4096, D 64) the dQ pass does 3 products (S = Q·Kᵀ, dP = dO·Vᵀ,
// dQ = dS·K) and the dK/dV pass 4 (S, dP, dV = Pᵀ·dO, dK = dSᵀ·Q) over the
// visible (query, key) pairs, 2·D flops each: 4.12e11 and 5.5e11 flop,
// against reading Q, K, V and dO once (~0.08 ms of HBM time in bf16). Both
// are compute-bound: bf16, ~0.42 ms and ~0.56 ms of bf16 tensor-core time;
// fp32, three TF32 products for each (below), 2.50 ms and 3.34 ms at the
// 495 TFLOP/s TF32 peak (6.16 and 8.21 ms at the 67 TFLOP/s of fp32 FMAs).
//
// What the design does about it. Both passes are the tensor-core bodies of
// bwd_tc.cuh, which the quantized backward shares, with the load stages of
// bwd_dense.cuh (which the ring backward step shares), stages that
// copy rows by cp.async straight into padded shared-memory tiles, two steps
// ahead into one of three staging buffers, where the products read them.
// Every output tile has one owner and nothing is summed with atomics, so
// both passes are deterministic:
//   * dQ (`dq_tc_kernel<DenseDqLoad>`): one block of 4 warps per (64-row
//     query tile, q head, batch); Q·scale, dO, LSE and δ staged once, then
//     the visible key tiles (bf16: 64 keys at D 64, 32 above; fp32: 32, 16
//     at D 256) in order, nothing converted;
//   * dK/dV (`dkv_tc_kernel<DenseLoad>`): one block of 4 warps (8 at
//     D 256) per (64-key tile, kv head, batch; fp32 D 256: 32 keys) keeps K
//     and V in shared memory and walks the query heads of its GQA group and
//     their visible 32-row query tiles (fp32 D 256: 16 rows); dK reads
//     each tile's raw Q where it landed, and only Q·scale for Sᵀ is
//     converted, one step ahead; the group sum stays in registers, so no
//     per-query-head dK/dV reaches HBM (flash_bwd.py:1144-1170).
// Products by input type:
//   * bf16: mma.sync m16n8k16 bf16 -> fp32 (`Bf16Mma`), head dims up to 256
//     (templates 64, 128, 256; a smaller D is zero-padded to the template
//     width). Reading the staging buffers in place is what fits dK/dV at
//     D 256: 204,800 bytes of shared memory, where a staging buffer beside
//     converted Q, raw Q and dO tiles would need 236,800 (a block may have
//     232,448).
//   * fp32 (fp16 arrives as fp32): fp32 tiles and 3xTF32 (`Tf32x3Mma`,
//     mma.cuh): each operand split into tf32 big and small parts, each
//     product three mma.sync m16n8k8 tf32 -> fp32 into one fp32 accumulator
//     (small·big, big·small, big·big). One TF32 pass would miss the fp32
//     gate of 1e-4 (relerr ~5e-4); the split keeps ~22 bits of every
//     operand, as accurate as fp32 FMAs in another order, which is what the
//     reference's HIGHEST precision for fp32 asks (flash_bwd.py:36-42); P
//     and dS are split from the accumulators, rounded nowhere else. Head
//     dims up to 256 (templates 64, 128, 256): at D 128 the dK/dV block
//     takes 204,288 bytes of shared memory, one block an SM (D 64: 105,728,
//     two); at D 256 the fp32 tiles take their own shapes (bwd_tc.cuh
//     `DkvTile`, `DqTile`, `sum_slices`): 8 warps, each forming Sᵀ and dPᵀ
//     (S and dP) over a slice of the depth and owning that slice's columns
//     of the gradients, the slices' partials added in shared memory; dK/dV
//     32-key blocks and 16-row query tiles (217,600 bytes), dQ 16-key tiles
//     in two staging buffers copied one step ahead (216,832 bytes).
// Head dims above 256 (both input types) run the wide bodies of
// wide_tc.cuh (`dq_wide_kernel`, `dkv_wide_kernel`; no map): the scores
// built up through the depth in chunks, each block one column slice of dQ
// (256 bf16, 128 fp32) or of dK and dV (128), the scores recomputed for
// each slice; same rounding points as below.
// wgmma, TMA and warp specialisation are later work.
//
// Rounding points held to the reference (bf16 inputs; fp32 rounds nowhere):
//   * Q·scale is rounded to the input type before S (flash_bwd.py:52), and
//     dK takes the raw Q with scale on its accumulator (:451-456);
//   * dO arrives in V's type (the wrapper casts it) for dP and dV
//     (:168, :437);
//   * P is rounded to V's type for dV (:437); dS to K's type for dQ (:175)
//     and to Q's type for dK (:452);
//   * scale multiplies the dQ and dK accumulators, not dS (:174, :451);
//   * accumulation is fp32; the store type is the wrapper's grad_dtype.
// Masking: index-hidden pairs (causal, window, KV tail, padded rows) have
// P = 0; a -1e30 bias is not an index mask. Bias: fp32, any broadcast
// shape, four element strides (0 = broadcast dimension, q-broadcast too).
#include "bwd_dense.cuh"
#include "wide_tc.cuh"

using namespace umfa;

namespace {

template <typename Tout, bool SPARSE>
cudaError_t launch_d(const BwdParams& p, bool dkv, bool bf16, cudaStream_t stream) {
  if (!bf16) {
    if (p.D <= 64) return launch_dense<float, Tout, 64, false, SPARSE>(p, dkv, stream);
    if (p.D <= 128) return launch_dense<float, Tout, 128, false, SPARSE>(p, dkv, stream);
    return launch_dense<float, Tout, 256, false, SPARSE>(p, dkv, stream);
  }
  if (p.D <= 64) return launch_dense<__nv_bfloat16, Tout, 64, false, SPARSE>(p, dkv, stream);
  if (p.D <= 128) return launch_dense<__nv_bfloat16, Tout, 128, false, SPARSE>(p, dkv, stream);
  return launch_dense<__nv_bfloat16, Tout, 256, false, SPARSE>(p, dkv, stream);
}

template <typename Tout>
cudaError_t launch_walk(const BwdParams& p, bool dkv, bool bf16, cudaStream_t stream) {
  return p.sm.map ? launch_d<Tout, true>(p, dkv, bf16, stream)
                  : launch_d<Tout, false>(p, dkv, bf16, stream);
}

// The wide bodies (wide_tc.cuh) at D > 256: dense walk only.
cudaError_t launch_wide(const BwdParams& p, bool dkv, bool bf16, bool out_bf16,
                        cudaStream_t stream) {
  WideParams w{};
  w.q = p.q;
  w.k = p.k;
  w.v = p.v;
  w.dout = p.dout;
  w.lse = const_cast<float*>(p.lse);
  w.delta = p.delta;
  w.bias = p.bias;
  w.out0 = p.out0;
  w.out1 = p.out1;
  w.B = p.B;
  w.Hq = p.Hq;
  w.Hkv = p.Hkv;
  w.Sq = p.Sq;
  w.Sk = p.Sk;
  w.D = p.D;
  w.bsb = p.bsb;
  w.bsh = p.bsh;
  w.bsq = p.bsq;
  w.bsk = p.bsk;
  w.scale = p.scale;
  w.left = p.left;
  w.right = p.right;
  w.vec = wide_vec(p.D, bf16 ? 2 : 4, {p.q, p.k, p.v, p.dout});
  w.out_bf16 = out_bf16;
  if (dkv) return bf16 ? launch_dkv_wide<Bf16Mma>(w, stream) : launch_dkv_wide<Tf32x3Mma>(w, stream);
  return bf16 ? launch_dq_wide<Bf16Mma>(w, stream) : launch_dq_wide<Tf32x3Mma>(w, stream);
}

int dispatch(BwdParams p, bool dkv, int in_dtype, int out_dtype, const void* map,
             const void* fetch, int bq, int bk, int nq, int nk, int width, long long msb,
             long long msh, long long fsb, long long fsh, void* stream) {
  if (in_dtype < 0 || in_dtype > 1 || out_dtype < 0 || out_dtype > 1 || p.D < 1 ||
      p.Hkv < 1 || p.Hq % p.Hkv != 0 || (p.D > 256 && map != nullptr) ||
      !sparse_map(&p.sm, map, fetch, bq, bk, nq, nk, width, msb, msh, fsb, fsh))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.D > 256) return launch_wide(p, dkv, in_dtype == 1, out_dtype == 1, st);
  return out_dtype == 0 ? launch_walk<float>(p, dkv, in_dtype == 1, st)
                        : launch_walk<__nv_bfloat16>(p, dkv, in_dtype == 1, st);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. q/dout (B, Hq, Sq, D) and k/v
// (B, Hkv, Sk, D) contiguous in in_dtype (D > 256: the wide bodies of
// wide_tc.cuh, no map); lse, delta (B, Hq, Sq)
// float32; bias float32 with element strides (or null). umfa_flash_bwd_dq
// writes out0 = dQ (B, Hq, Sq, D); umfa_flash_bwd_dkv writes out0 = dK and
// out1 = dV (B, Hkv, Sk, D); both in out_dtype. map (null: no walk): the
// block-sparse map (Bm, Hm, nq, nk) int32 of bq x bk tiles; fetch its
// compacted table, fetch_kv (Bm, Hm, nq, width) for dQ, fetch_q
// (Bm, Hm, nk, width) for dK/dV; the element strides of their batch and
// head (0 = broadcast). Each returns the cudaError_t of its launch.
#define UMFA_BWD_ARGS                                                                        \
  const void *q, const void *k, const void *v, const void *dout, const void *lse,           \
      const void *delta, const void *bias, void *out0, void *out1, int B, int Hq, int Hkv, \
      int Sq, int Sk, int D, long long bsb, long long bsh, long long bsq, long long bsk,    \
      float scale, int left, int right, int in_dtype, int out_dtype, const void *map,        \
      const void *fetch, int bq, int bk, int nq, int nk, int width, long long msb,            \
      long long msh, long long fsb, long long fsh, void *stream
#define UMFA_BWD_PARAMS                                                                       \
  BwdParams {                                                                                 \
    q, k, v, nullptr, nullptr, nullptr, dout, static_cast<const float*>(lse),                 \
        static_cast<const float*>(delta), nullptr, nullptr, nullptr,                          \
        static_cast<const float*>(bias), out0, out1, B, Hq, Hkv, Sq, Sk, D, 0, 0, 0, bsb, bsh, \
        bsq, bsk, scale, left, right                                                          \
  }

extern "C" int umfa_flash_bwd_dq(UMFA_BWD_ARGS) {
  return dispatch(UMFA_BWD_PARAMS, false, in_dtype, out_dtype, map, fetch, bq, bk, nq, nk, width,
                  msb, msh, fsb, fsh, stream);
}

extern "C" int umfa_flash_bwd_dkv(UMFA_BWD_ARGS) {
  return dispatch(UMFA_BWD_PARAMS, true, in_dtype, out_dtype, map, fetch, bq, bk, nq, nk, width,
                  msb, msh, fsb, fsh, stream);
}

// Dynamic shared memory of the dQ (dkv = 0) or dK/dV (dkv = 1) kernel for
// head dim D and input dtype code in_dtype, in bytes (0 if it does not take
// them).
extern "C" int umfa_flash_bwd_smem_bytes(int D, int dkv, int in_dtype) {
  if (in_dtype < 0 || in_dtype > 1) return 0;
  if (D > 256) {
    int plan[5];
    wide_plan(D, dkv ? 2 : 1, in_dtype, plan);
    return plan[4];
  }
  return dense_smem_bytes(D, dkv, in_dtype);
}
