// Ring attention step kernels for Hopper, sm_90a: one launch is one rank's
// work for one ring step.
//
// Replaces umfa_tpu/parallel/ring_pallas.py:99 `_ring_fwd_kernel`
// (`ring_fwd_step`) and ring_pallas.py:529 `_ring_bwd_kernel` (its phase 0,
// `ring_bwd_dkv`, and its phase 1, `ring_bwd_dq`). The TPU kernels also
// move K/V (and dK/dV) between chips with RDMA inside the kernel; here the
// host loop (parallel/ring_pallas.py) launches these kernels per rank and
// step, and a transport (parallel/transport.py) makes the hops between
// them: device copies on a side stream, ordered by CUDA events, on one
// card, or torch.distributed send/recv across processes.
//
// What bounds them on this card: at the full-width ring step (B8 Hq16 Hkv8,
// S_loc 1024, D 64, bf16) a fully visible step does 4·D flops per (query,
// key) pair in the forward (2 products), 8·D in dK/dV (4) and 6·D in dQ
// (3), against reading each operand once: 3.4e10, 6.9e10 and 5.2e10 flop,
// ~35, ~70 and ~52 µs of bf16 tensor-core time, against ~20 µs of HBM time.
// All three are compute-bound.
//
// All three are tensor-core bodies shared with the dense kernels,
// instantiated with RING = true: bf16 inputs by mma.sync m16n8k16 bf16 ->
// fp32 (`Bf16Mma`), fp32 inputs by 3xTF32 (`Tf32x3Mma`), head dims up to
// 256 for both (fp32 at 256 on the bodies' wide fp32 tiles: the forward 8
// warps on 128 query rows and 16-key tiles; dK/dV and dQ 8 warps that
// split each product's depth, 32-key blocks and 16-row query tiles, 16-key
// tiles copied one step ahead). What a step sees comes from the host, which
// reduces the step's global positions to the bodies' band mask (left,
// right) plus a first visible query row q_lo and a key limit k_hi, in local
// indices (ring_pallas.py `_step_mask`): not causal, nothing hidden; the
// diagonal step (src == my) local causal (right = 0; under zigzag too,
// since a chunk's two halves sit in order); contiguous causal with src <
// my, nothing hidden; zigzag with src < my, keys [0, S/2) only; with src >
// my, query rows [S/2, S) only. Tiles past the limits are skipped whole,
// and a block that sees nothing after the first step stores nothing. One
// owner per output tile and no atomics, so every step is deterministic.
// The local chunk S may be any length (the tiles take a ragged tail).
//
// The forward step (`ring_fwd_step`) is the dense forward's body
// (fwd_tc.cuh `fwd_tc_kernel`). Its rounding points, held to the
// reference:
//   * Q is not pre-scaled: s = (q·k) in fp32, times scale, rounded once
//     (ring_pallas.py:321-326); a hidden score is -1e30 and its P is 0
//     (:327-345);
//   * P = exp(s - m) is rounded to V's type for P·V against the running max
//     of block_k groups of local keys, while l sums the unrounded P
//     (:338-355). The body finds each group's max in a K-only pre-pass over
//     the group's visible tiles, then forms P and P·V: with block_k = S_loc
//     (the usual case) one extra Q·Kᵀ over the step;
//   * o_step = acc / l and lse_step = m + log l, a row with l == 0 gets 0
//     and -1e30 (:363-367); then the merge into the previous (o, lse)
//     (:382-390) or, at the rank's first step, a plain write (:392-395); o
//     is stored in its own type after every step.
//
// The backward step (`ring_bwd_dkv`, `ring_bwd_dq`) is the dense
// backward's tensor-core bodies (bwd_tc.cuh `dkv_tc_kernel`,
// `dq_tc_kernel`) with its load stages (bwd_dense.cuh). Tiles, occupancy
// and the cp.async pipeline are those of csrc/flash_bwd.cu, whose header
// gives the rounding points a ring step shares: Q·scale rounded to the
// input type (ring_pallas.py:693); P = exp(s - lse) with the final LSE; dS
// = P∘(dP − δ); dV += round(P)ᵀ·dO, dK += round(dS)ᵀ·Q and dQ +=
// round(dS)·K, dK and dQ times scale. The gradients fold into the
// travelling fp32 dK/dV buffers and the fp32 dQ accumulator: written at
// the rank's first step (:829-837, :912-923), then added, old +
// scale·sum, each rounded once, as the plain versions add.
#include "bwd_dense.cuh"
#include "fwd_tc.cuh"

using namespace umfa;

namespace {

template <typename T>
cudaError_t launch_bwd(const BwdParams& p, bool dkv, cudaStream_t stream) {
  if (p.D <= 64) return launch_dense<T, float, 64, true>(p, dkv, stream);
  if (p.D <= 128) return launch_dense<T, float, 128, true>(p, dkv, stream);
  return launch_dense<T, float, 256, true>(p, dkv, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and o). q and o
// (B, Hq, S, D), k and v (B, Hkv, S, D), S the rank's chunk, contiguous,
// D <= 256; lse (B, Hq, S) float32. What
// the step sees, in local indices: the band (left, right; -1 = unbounded),
// query rows from q_lo and keys below k_hi (parallel/ring_pallas.py
// `_step_mask`); P is rounded against the running max of groups of block_k
// keys (block_k divides S). o and lse are read (unless first) and written.
// Returns the cudaError_t of the launch.
extern "C" int umfa_ring_fwd_step(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int block_k, int B, int Hq, int Hkv, int S, int D,
                                  float scale, int left, int right, int q_lo, int k_hi,
                                  int first, int dtype, void* stream) {
  if ((dtype != 0 && dtype != 1) || D < 1 || D > 256 || Hkv < 1 || Hq % Hkv != 0 || S < 1 ||
      left < -1 || right < -1 || q_lo < 0 || q_lo > S || k_hi < 0 || k_hi > S || block_k < 1 ||
      S % block_k != 0)
    return cudaErrorInvalidValue;
  const int per16 = dtype == 1 ? 8 : 4;  // elements a 16-byte copy
  FwdParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = o;
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Sq = p.Sk = S;
  p.D = D;
  p.scale = scale;
  p.left = left;
  p.right = right;
  p.vec = D % per16 == 0 && aligned({k, v}, 16);
  p.q_lo = q_lo;
  p.k_hi = k_hi;
  p.block_k = block_k;
  p.first = first;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using B16 = __nv_bfloat16;
  if (dtype == 0) {
    if (D <= 64) return launch_fwd_tc<Tf32x3Mma, float, 64, true>(p, st);
    if (D <= 128) return launch_fwd_tc<Tf32x3Mma, float, 128, true>(p, st);
    return launch_fwd_tc<Tf32x3Mma, float, 256, true>(p, st);
  }
  if (D <= 64) return launch_fwd_tc<Bf16Mma, B16, 64, true>(p, st);
  if (D <= 128) return launch_fwd_tc<Bf16Mma, B16, 128, true>(p, st);
  return launch_fwd_tc<Bf16Mma, B16, 256, true>(p, st);
}

// Dynamic shared memory of the ring forward step for head dim D and dtype
// code dtype, in bytes (0 if it does not take them).
extern "C" int umfa_ring_fwd_smem_bytes(int D, int dtype) {
  if ((dtype != 0 && dtype != 1) || D < 1 || D > 256) return 0;
  if (dtype == 0)
    return D <= 64    ? FwdTile<64, Tf32x3Mma, true>::SMEM
           : D <= 128 ? FwdTile<128, Tf32x3Mma, true>::SMEM
                      : FwdTile<256, Tf32x3Mma, true>::SMEM;
  return D <= 64    ? FwdTile<64, Bf16Mma, true>::SMEM
         : D <= 128 ? FwdTile<128, Bf16Mma, true>::SMEM
                    : FwdTile<256, Bf16Mma, true>::SMEM;
}

// q, dout (B, Hq, S, D) and k, v (B, Hkv, S, D) in dtype, contiguous, D <=
// 256; lse, delta (B, Hq, S) float32.
// What the step sees, in local indices: the band (left, right; -1 =
// unbounded), query rows from q_lo and keys below k_hi
// (parallel/ring_pallas.py `_step_mask`). umfa_ring_bwd_dq folds dQ into
// out0 (B, Hq, S, D); umfa_ring_bwd_dkv folds dK into out0 and dV into out1
// (B, Hkv, S, D); all float32, written when first, else added to. Each
// returns the cudaError_t of its launch.
#define UMFA_RING_BWD_ARGS                                                                   \
  const void *q, const void *k, const void *v, const void *dout, const void *lse,           \
      const void *delta, void *out0, void *out1, int B, int Hq, int Hkv, int S, int D,      \
      float scale, int left, int right, int q_lo, int k_hi, int first, int dtype, void *stream

static int ring_bwd(UMFA_RING_BWD_ARGS, bool dkv) {
  if ((dtype != 0 && dtype != 1) || D < 1 || D > 256 || Hkv < 1 || Hq % Hkv != 0 || S < 1 ||
      left < -1 || right < -1 || q_lo < 0 || q_lo > S || k_hi < 0 || k_hi > S ||
      (dkv && out1 == nullptr))
    return cudaErrorInvalidValue;
  BwdParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out0 = out0;
  p.out1 = out1;
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Sq = p.Sk = S;
  p.D = D;
  p.scale = scale;
  p.left = left;
  p.right = right;
  p.q_lo = q_lo;
  p.k_hi = k_hi;
  p.first = first;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_bwd<float>(p, dkv, st) : launch_bwd<__nv_bfloat16>(p, dkv, st);
}

extern "C" int umfa_ring_bwd_dq(UMFA_RING_BWD_ARGS) {
  return ring_bwd(q, k, v, dout, lse, delta, out0, out1, B, Hq, Hkv, S, D, scale, left, right,
                  q_lo, k_hi, first, dtype, stream, false);
}

extern "C" int umfa_ring_bwd_dkv(UMFA_RING_BWD_ARGS) {
  return ring_bwd(q, k, v, dout, lse, delta, out0, out1, B, Hq, Hkv, S, D, scale, left, right,
                  q_lo, k_hi, first, dtype, stream, true);
}

// Dynamic shared memory of the ring backward's dQ (dkv = 0) or dK/dV
// (dkv = 1) kernel for head dim D and dtype code dtype, in bytes (0 if it
// does not take them).
extern "C" int umfa_ring_bwd_smem_bytes(int D, int dkv, int dtype) {
  if (dtype != 0 && dtype != 1) return 0;
  return dense_smem_bytes(D, dkv, dtype);
}
