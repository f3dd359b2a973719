// Dense flash-attention backward (dQ, then dK/dV) for Hopper, sm_90a.
//
// Replaces umfa_tpu/ops/flash_bwd.py:84 `_dq_kernel` and flash_bwd.py:336
// `_dkv_kernel` (host `flash_attention_backward`, flash_bwd.py:825), without
// their block-sparse walks. The host wrapper (ops/flash_bwd.py) computes
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
// bwd_tc.cuh, which the quantized backward shares, with load stages that
// copy rows by cp.async straight into padded shared-memory tiles, two steps
// ahead into one of three staging buffers, where the products read them.
// Every output tile has one owner and nothing is summed with atomics, so
// both passes are deterministic:
//   * dQ (`dq_tc_kernel<DenseDqLoad>`): one block of 4 warps per (64-row
//     query tile, q head, batch); Q·scale, dO, LSE and δ staged once, then
//     the visible key tiles (bf16: 64 keys at D 64, 32 above; fp32: 32) in
//     order, nothing converted;
//   * dK/dV (`dkv_tc_kernel<DenseLoad>`): one block of 4 warps (8 at
//     D 256) per (64-key tile, kv head, batch) keeps K and V in shared
//     memory and walks the query heads of its GQA group and their visible
//     32-row query tiles; dK reads each tile's raw Q where it landed, and
//     only Q·scale for Sᵀ is converted, one step ahead; the group sum stays
//     in registers, so no per-query-head dK/dV reaches HBM
//     (flash_bwd.py:1144-1170).
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
//     dims up to 128 (templates 64, 128): at D 128 the dK/dV block takes
//     204,288 bytes of shared memory, one block an SM (D 64: 105,728, two).
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
#include <type_traits>

#include "bwd_tc.cuh"

using namespace umfa;

namespace {

// ---- The load stages of the tensor-core bodies (bf16 or fp32 tiles) -------

// The product policy of an input type.
template <typename T>
using MmaFor = std::conditional_t<sizeof(T) == 2, Bf16Mma, Tf32x3Mma>;

// Rows [0, 64) of a bf16 or fp32 matrix with rows of D elements (src: its
// first row; n live rows) into a tile of row stride DP + PAD, each value
// times `scale` and rounded to T once when SCALED (the reference's Q·scale,
// flash_bwd.py:52); rows at or past n and columns past D are 0. wide: four
// values at a time (D % 4 == 0, src aligned to four elements).
template <int DP, bool SCALED, typename T>
__device__ __forceinline__ void stage_rows_tile(T* dst, const T* src, int n, int D, bool wide,
                                                float scale) {
  constexpr int C4 = DP / 4;
  constexpr int LD = DP + MmaFor<T>::PAD;
  for (int e = threadIdx.x; e < 64 * C4; e += blockDim.x) {
    const int r = e / C4, c = (e - r * C4) * 4;
    const T* row = src + (long long)r * D;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < n) {
      if (wide) {
        if (c < D) load4(row + c, x);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = c + i < D ? Elem<T>::load(row, c + i) : 0.f;
      }
    }
    if (SCALED) {
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = __fmul_rn(x[i], scale);
    }
    store4(dst + r * LD + c, x);  // unscaled values: exact
  }
}

// dQ: Q and dO staged once; each key tile's K and V copied by cp.async
// straight into padded tiles, which the products read where they landed
// (three staging buffers, copies two steps ahead, nothing converted, no
// per-key score term).
template <int DP, typename T>
struct DenseDqLoad {
  using G = DqTile<DP, MmaFor<T>>;
  static constexpr int KT = G::KT, LD = G::LD;
  static constexpr int NRAW = 3, IN_FLIGHT = 1;
  static constexpr int RAW_BYTES = 2 * KT * LD * (int)sizeof(T);  // K, V (row stride LD)
  struct Kv {
    static constexpr int BYTES = 0;
    T* k;
    T* v;
    __device__ __forceinline__ Kv(unsigned char*, unsigned char* raw) {
      k = reinterpret_cast<T*>(raw);
      v = k + KT * LD;
    }
    __device__ __forceinline__ float score(float x, int) const { return x; }
  };

  // Q·scale (rounded to T), dO, LSE and δ of query rows [q0, q0 + 64); no
  // dP term.
  static __device__ __forceinline__ void stage_q(T* sQ, T* sO, float* sRow, const BwdParams& p,
                                                 long long qbh, long long, int q0) {
    const int n = min(64, p.Sq - q0);
    const long long r0 = qbh * p.Sq + q0;
    stage_rows_tile<DP, true>(sQ, static_cast<const T*>(p.q) + r0 * p.D, n, p.D, p.wide,
                              p.scale);
    stage_rows_tile<DP, false>(sO, static_cast<const T*>(p.dout) + r0 * p.D, n, p.D, p.wide,
                               1.f);
    for (int r = threadIdx.x; r < 64; r += blockDim.x) {
      sRow[r] = 0.f;
      sRow[64 + r] = r < n ? p.lse[r0 + r] : 0.f;
      sRow[128 + r] = r < n ? p.delta[r0 + r] : 0.f;
    }
  }

  // The copies of key rows [k0, k0 + KT) into `raw`, as the products read them.
  static __device__ __forceinline__ void issue(unsigned char* raw, const BwdParams& p, long long,
                                               long long kbh, int k0, bool vec) {
    const int n = min(KT, p.Sk - k0);
    const long long off = (kbh * p.Sk + k0) * p.D;
    T* k = reinterpret_cast<T*>(raw);
    load_tile<KT, DP, LD>(k, static_cast<const T*>(p.k) + off, n, p.D, 0, vec);
    load_tile<KT, DP, LD>(k + KT * LD, static_cast<const T*>(p.v) + off, n, p.D, 0, vec);
  }

  static __device__ __forceinline__ void stage(const unsigned char*, const Kv&, const BwdParams&,
                                               long long, int) {}
};

// dK/dV: a query tile as the products read it. Its staging buffer (three
// of them, copied two steps ahead) holds the raw Q (dK's operand,
// flash_bwd.py:451-456), dO, LSE and δ as they landed; its converted buffer
// Q·scale rounded to T (Sᵀ's operand, flash_bwd.py:52) and the dP term
// vt = 0. bf16 at D 64: the scale 1/8 is exact and the two Q operands
// agree; at D 80 or 128 dK from the scaled Q would be off by relerr ~1e-3.
template <int DP, typename T>
struct DenseQTile {
  using G = DkvTile<DP, MmaFor<T>>;
  static constexpr int QT = G::QT, LD = G::LD;
  static constexpr int BYTES = QT * LD * (int)sizeof(T) + QT * 4;  // Q·scale, vt
  static constexpr int RAW_O = QT * LD * (int)sizeof(T);
  static constexpr int RAW_L = 2 * QT * LD * (int)sizeof(T);
  static constexpr int RAW_D = RAW_L + QT * 4;
  static constexpr int RAW_BYTES = RAW_D + QT * 4;  // Q, dO (LD), LSE, δ
  T* q;
  T* qk;
  T* o;
  float* vt;
  float* lse;
  float* delta;
  __device__ __forceinline__ DenseQTile(unsigned char* conv, unsigned char* raw) {
    q = reinterpret_cast<T*>(conv);
    vt = reinterpret_cast<float*>(q + QT * LD);
    qk = reinterpret_cast<T*>(raw);
    o = reinterpret_cast<T*>(raw + RAW_O);
    lse = reinterpret_cast<float*>(raw + RAW_L);
    delta = reinterpret_cast<float*>(raw + RAW_D);
  }
};

template <int DP, typename T>
struct DenseLoad {
  using G = DkvTile<DP, MmaFor<T>>;
  using Tile = DenseQTile<DP, T>;
  static constexpr int NRAW = 3, RAW_BYTES = Tile::RAW_BYTES;

  static __device__ __forceinline__ float dk_scale(const BwdParams& p) { return p.scale; }

  // K and V of key rows [k0, k0 + 64); the dense backward has no V mean.
  static __device__ __forceinline__ void stage_kv(T* sK, T* sV, float* sVm, const BwdParams& p,
                                                  long long kbh, int k0) {
    const int n = min(64, p.Sk - k0);
    const long long off = (kbh * p.Sk + k0) * p.D;
    stage_rows_tile<DP, false>(sK, static_cast<const T*>(p.k) + off, n, p.D, p.wide, 1.f);
    stage_rows_tile<DP, false>(sV, static_cast<const T*>(p.v) + off, n, p.D, p.wide, 1.f);
    for (int c = threadIdx.x; c < DP; c += blockDim.x) sVm[c] = 0.f;
  }

  // The copies of query rows [q0, q0 + QT) of head qbh into `raw`, as the
  // products read them.
  static __device__ __forceinline__ void issue(unsigned char* raw, const BwdParams& p,
                                               long long qbh, int q0, bool vec) {
    const int n = min(G::QT, p.Sq - q0);
    const long long r0 = qbh * p.Sq + q0;
    load_tile<G::QT, DP, G::LD>(reinterpret_cast<T*>(raw), static_cast<const T*>(p.q) + r0 * p.D,
                                n, p.D, 0, vec);
    load_tile<G::QT, DP, G::LD>(reinterpret_cast<T*>(raw + Tile::RAW_O),
                                static_cast<const T*>(p.dout) + r0 * p.D, n, p.D, 0, vec);
    load_rows_f32<G::QT>(reinterpret_cast<float*>(raw + Tile::RAW_L), p.lse + r0, n);
    load_rows_f32<G::QT>(reinterpret_cast<float*>(raw + Tile::RAW_D), p.delta + r0, n);
  }

  // Q·scale from the raw Q of tile t (zero where it is), 16 bytes a thread
  // (each value rounded to T once); vt = 0.
  static __device__ __forceinline__ void stage(const unsigned char*, const Tile& t, const float*,
                                               const BwdParams& p, long long, int) {
    constexpr int E = 16 / (int)sizeof(T);
    constexpr int CE = DP / E;
    for (int e = threadIdx.x; e < G::QT * CE; e += blockDim.x) {
      const int r = e / CE, c = (e - r * CE) * E;
      if constexpr (sizeof(T) == 2) {
        uint4 w = *reinterpret_cast<const uint4*>(t.qk + r * G::LD + c);
        w.x = scale_bf16x2(w.x, p.scale);
        w.y = scale_bf16x2(w.y, p.scale);
        w.z = scale_bf16x2(w.z, p.scale);
        w.w = scale_bf16x2(w.w, p.scale);
        *reinterpret_cast<uint4*>(t.q + r * G::LD + c) = w;
      } else {
        float4 w = *reinterpret_cast<const float4*>(t.qk + r * G::LD + c);
        w.x = __fmul_rn(w.x, p.scale);
        w.y = __fmul_rn(w.y, p.scale);
        w.z = __fmul_rn(w.z, p.scale);
        w.w = __fmul_rn(w.w, p.scale);
        *reinterpret_cast<float4*>(t.q + r * G::LD + c) = w;
      }
    }
    for (int r = threadIdx.x; r < G::QT; r += blockDim.x) t.vt[r] = 0.f;
  }
};

template <typename Tin, typename Tout, int DP>
cudaError_t launch_tc(BwdParams p, bool dkv, cudaStream_t stream) {
  // Rows by 16-byte cp.async when every row of q, k, v and dO starts
  // 16-byte aligned; four values at a time when rows start at a multiple of
  // four elements.
  const int vec = p.D % (16 / (int)sizeof(Tin)) == 0 && aligned({p.q, p.k, p.v, p.dout}, 16);
  using Mma = MmaFor<Tin>;
  if (dkv) {
    p.wide = p.D % 4 == 0 && aligned({p.k, p.v}, 4 * sizeof(Tin));
    return launch_dkv_tc<DenseLoad<DP, Tin>, Mma, Tout, DP>(p, vec, stream);
  }
  p.wide = p.D % 4 == 0 && aligned({p.q, p.dout}, 4 * sizeof(Tin));
  return launch_dq_tc<DenseDqLoad<DP, Tin>, Mma, Tout, DP>(p, vec, stream);
}

template <typename Tout>
cudaError_t launch_d(const BwdParams& p, bool dkv, bool bf16, cudaStream_t stream) {
  if (!bf16)
    return p.D <= 64 ? launch_tc<float, Tout, 64>(p, dkv, stream)
                     : launch_tc<float, Tout, 128>(p, dkv, stream);
  if (p.D <= 64) return launch_tc<__nv_bfloat16, Tout, 64>(p, dkv, stream);
  if (p.D <= 128) return launch_tc<__nv_bfloat16, Tout, 128>(p, dkv, stream);
  return launch_tc<__nv_bfloat16, Tout, 256>(p, dkv, stream);
}

int dispatch(const BwdParams& p, bool dkv, int in_dtype, int out_dtype, void* stream) {
  if (in_dtype < 0 || in_dtype > 1 || out_dtype < 0 || out_dtype > 1 || p.D < 1 ||
      p.D > (in_dtype == 1 ? 256 : 128) || p.Hkv < 1 || p.Hq % p.Hkv != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_dtype == 0 ? launch_d<float>(p, dkv, in_dtype == 1, st)
                        : launch_d<__nv_bfloat16>(p, dkv, in_dtype == 1, st);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. q/dout (B, Hq, Sq, D) and k/v
// (B, Hkv, Sk, D) contiguous in in_dtype, D <= 256 for bfloat16 and <= 128
// for float32; lse, delta (B, Hq, Sq) float32; bias float32 with element
// strides (or null). umfa_flash_bwd_dq writes out0 = dQ (B, Hq, Sq, D);
// umfa_flash_bwd_dkv writes out0 = dK and out1 = dV (B, Hkv, Sk, D); both in
// out_dtype. Each returns the cudaError_t of its launch.
#define UMFA_BWD_ARGS                                                                        \
  const void *q, const void *k, const void *v, const void *dout, const void *lse,           \
      const void *delta, const void *bias, void *out0, void *out1, int B, int Hq, int Hkv, \
      int Sq, int Sk, int D, long long bsb, long long bsh, long long bsq, long long bsk,    \
      float scale, int left, int right, int in_dtype, int out_dtype, void *stream
#define UMFA_BWD_PARAMS                                                                       \
  BwdParams {                                                                                 \
    q, k, v, nullptr, nullptr, nullptr, dout, static_cast<const float*>(lse),                 \
        static_cast<const float*>(delta), nullptr, nullptr, nullptr,                          \
        static_cast<const float*>(bias), out0, out1, B, Hq, Hkv, Sq, Sk, D, 0, 0, 0, bsb, bsh, \
        bsq, bsk, scale, left, right                                                          \
  }

extern "C" int umfa_flash_bwd_dq(UMFA_BWD_ARGS) {
  return dispatch(UMFA_BWD_PARAMS, false, in_dtype, out_dtype, stream);
}

extern "C" int umfa_flash_bwd_dkv(UMFA_BWD_ARGS) {
  return dispatch(UMFA_BWD_PARAMS, true, in_dtype, out_dtype, stream);
}

// Dynamic shared memory of the dQ (dkv = 0) or dK/dV (dkv = 1) kernel for
// head dim D and input dtype code in_dtype, in bytes (0 if it does not take
// them).
extern "C" int umfa_flash_bwd_smem_bytes(int D, int dkv, int in_dtype) {
  if (D < 1 || in_dtype < 0 || in_dtype > 1 || D > (in_dtype == 1 ? 256 : 128)) return 0;
  if (in_dtype == 0) {
    if (dkv)
      return D <= 64 ? dkv_smem_bytes<DenseLoad<64, float>, Tf32x3Mma, 64>()
                     : dkv_smem_bytes<DenseLoad<128, float>, Tf32x3Mma, 128>();
    return D <= 64 ? dq_smem_bytes<DenseDqLoad<64, float>, Tf32x3Mma, 64>()
                   : dq_smem_bytes<DenseDqLoad<128, float>, Tf32x3Mma, 128>();
  }
  using B16 = __nv_bfloat16;
  if (dkv)
    return D <= 64    ? dkv_smem_bytes<DenseLoad<64, B16>, Bf16Mma, 64>()
           : D <= 128 ? dkv_smem_bytes<DenseLoad<128, B16>, Bf16Mma, 128>()
                      : dkv_smem_bytes<DenseLoad<256, B16>, Bf16Mma, 256>();
  return D <= 64    ? dq_smem_bytes<DenseDqLoad<64, B16>, Bf16Mma, 64>()
         : D <= 128 ? dq_smem_bytes<DenseDqLoad<128, B16>, Bf16Mma, 128>()
                    : dq_smem_bytes<DenseDqLoad<256, B16>, Bf16Mma, 256>();
}
