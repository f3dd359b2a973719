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
// S 4096, D 64, bf16) the dQ pass does 3 products (S = Q·Kᵀ, dP = dO·Vᵀ,
// dQ = dS·K) and the dK/dV pass 4 (S, dP, dV = Pᵀ·dO, dK = dSᵀ·Q) over the
// visible (query, key) pairs, 2·D flops each, against reading Q, K, V and
// dO once: both are compute-bound, ~0.42 ms and ~0.56 ms of bf16
// tensor-core time, against ~0.08 ms of HBM time.
//
// What the design does about it. Every output tile has one owner and
// nothing is summed with atomics, so both passes are deterministic:
//   * bf16 inputs: the tensor-core bodies of bwd_tc.cuh (mma.sync m16n8k16
//     bf16 -> fp32) that the quantized backward shares, with load stages
//     that copy bf16 rows by cp.async straight into padded shared-memory
//     tiles, two steps ahead into one of three staging buffers, where the
//     products read them:
//     - dQ (`dq_tc_kernel<DenseDqLoad>`): one block of 4 warps per (64-row
//       query tile, q head, batch); bf16(q·scale), dO, LSE and δ staged
//       once, then the visible key tiles (64 keys at D 64, 32 above) in
//       order, nothing converted;
//     - dK/dV (`dkv_tc_kernel<DenseLoad>`): one block of 4 warps (8 at
//       D 256) per (64-key tile, kv head, batch) keeps K and V in shared
//       memory and walks the query heads of its GQA group and their visible
//       32-row query tiles; dK reads each tile's raw Q where it landed, and
//       only bf16(q·scale) for Sᵀ is converted, one step ahead; the group
//       sum stays in registers, so no per-query-head dK/dV reaches HBM
//       (flash_bwd.py:1144-1170).
//     Head dims up to 256 (templates 64, 128, 256; a smaller D is
//     zero-padded to the template width). Reading the staging buffers in
//     place is what fits dK/dV at D 256: 204,800 bytes of shared memory,
//     where a staging buffer beside converted Q, raw Q and dO tiles would
//     need 236,800 (a block may have 232,448).
//   * fp32 inputs (fp16 arrives as fp32): `flash_bwd_dq_kernel` and
//     `flash_bwd_dkv_kernel`, FP32 FMAs on the CUDA cores, one block of 256
//     threads per 64-row tile, fp32 tiles in dynamic shared memory (83-165
//     KB a block; each thread a 4 x 4 patch of the score tile); TF32 would
//     miss the fp32 gate of 1e-4, and the reference forces HIGHEST precision
//     for fp32 (flash_bwd.py:36-42). Head dims up to 128: at 256 their
//     tiles would need 279,808 (dQ) and 296,448 (dK/dV) bytes.
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
#include "bwd_tc.cuh"

using namespace umfa;

namespace {

// Dynamic shared memory of the CUDA-core kernels (fp32 inputs).
template <int DP>
constexpr int simt_dq_smem_bytes() {
  return (4 * 64 * (DP + 1) + 64 * (BK + 1)) * (int)sizeof(float);
}

template <int DP>
constexpr int simt_dkv_smem_bytes() {
  return (4 * 64 * (DP + 1) + 2 * 64 * (BQ + 1)) * (int)sizeof(float);
}

// fp32 inputs only (bf16 takes dq_tc_kernel<DenseDqLoad>).
template <typename Tout, int DP>
__global__ void __launch_bounds__(NTB) flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int S = DP + 1;
  constexpr int PS = BK + 1;
  constexpr int NC = DP / 16;
  extern __shared__ float smem[];
  float* sQ = smem;         // q · scale
  float* sO = sQ + BQ * S;  // dO
  float* sK = sO + BQ * S;
  float* sV = sK + BK * S;
  float* sS = sV + BK * S;  // dS, BQ x PS

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const long long qrow = ((long long)b * p.Hq + h) * p.Sq;
  const long long krow = ((long long)b * p.Hkv + hk) * p.Sk;
  const float* k = static_cast<const float*>(p.k) + krow * p.D;
  const float* v = static_cast<const float*>(p.v) + krow * p.D;
  const float* bias = p.bias ? p.bias + b * p.bsb + h * p.bsh : nullptr;

  stage_rows<float, DP, true>(sQ, static_cast<const float*>(p.q) + qrow * p.D, q0, p.Sq, p.D,
                              p.scale);
  stage_rows<float, DP>(sO, static_cast<const float*>(p.dout) + qrow * p.D, q0, p.Sq, p.D);
  float lse[4], dlt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lse[i] = row < p.Sq ? p.lse[qrow + row] : 0.f;
    dlt[i] = row < p.Sq ? p.delta[qrow + row] : 0.f;
  }

  int k_lo, k_hi;
  visible_keys(q0, min(q0 + BQ, p.Sq) - 1, p.Sk, p.left, p.right, &k_lo, &k_hi);
  const int t_lo = k_lo / BK;
  const int t_hi = k_hi >= k_lo ? k_hi / BK : t_lo - 1;

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // sQ/sO staged; the previous tile's sK/sV/sS consumed
    stage_rows<float, DP>(sK, k, k0, p.Sk, p.D);
    stage_rows<float, DP>(sV, v, k0, p.Sk, p.D);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    patch_abt<float, DP>(s, sQ, sK, ty, tx);
    patch_abt<float, DP>(dp, sO, sV, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float ds = 0.f;
        if (key_visible(row, col, p.Sq, p.Sk, p.left, p.right)) {
          float x = s[i][j];
          if (bias) x += bias[row * p.bsq + col * p.bsk];
          ds = expf(x - lse[i]) * (dp[i][j] - dlt[i]);
        }
        sS[(ty * 4 + i) * PS + tx + 16 * j] = ds;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] = sS[(ty * 4 + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv = sK[kk * S + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(d[i], kv, acc[i][c]);
      }
    }
  }

  Tout* dq = static_cast<Tout*>(p.out0) + qrow * p.D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < p.D) Elem<Tout>::store(dq, (long long)row * p.D + col, p.scale * acc[i][c]);
    }
  }
}

// fp32 inputs only (bf16 takes dkv_tc_kernel<DenseLoad>).
template <typename Tout, int DP>
__global__ void __launch_bounds__(NTB) flash_bwd_dkv_kernel(const BwdParams p) {
  constexpr int S = DP + 1;
  constexpr int PS = BQ + 1;
  constexpr int NC = DP / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * S;
  float* sQ = sV + BK * S;  // raw q (scaled on the fly for S)
  float* sO = sQ + BQ * S;  // dO
  float* sP = sO + BQ * S;  // Pᵀ, BK x PS
  float* sS = sP + BK * PS;  // dSᵀ, BK x PS

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.Hq / p.Hkv;
  const long long krow = ((long long)b * p.Hkv + hk) * p.Sk;
  stage_rows<float, DP>(sK, static_cast<const float*>(p.k) + krow * p.D, k0, p.Sk, p.D);
  stage_rows<float, DP>(sV, static_cast<const float*>(p.v) + krow * p.D, k0, p.Sk, p.D);

  int q_lo, q_hi;
  visible_queries(k0, min(k0 + BK, p.Sk) - 1, p.Sq, p.left, p.right, &q_lo, &q_hi);
  const int t_lo = q_lo / BQ;
  const int t_hi = q_hi >= q_lo ? q_hi / BQ : t_lo - 1;

  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const long long qrow = ((long long)b * p.Hq + h) * p.Sq;
    const float* q = static_cast<const float*>(p.q) + qrow * p.D;
    const float* dout = static_cast<const float*>(p.dout) + qrow * p.D;
    const float* bias = p.bias ? p.bias + b * p.bsb + h * p.bsh : nullptr;
    for (int t = t_lo; t <= t_hi; ++t) {
      const int q0 = t * BQ;
      __syncthreads();  // sK/sV staged; the previous tile's sQ/sO/sP/sS consumed
      stage_rows<float, DP>(sQ, q, q0, p.Sq, p.D);
      stage_rows<float, DP>(sO, dout, q0, p.Sq, p.D);
      float lse[4], dlt[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + tx + 16 * j;
        lse[j] = row < p.Sq ? p.lse[qrow + row] : 0.f;
        dlt[j] = row < p.Sq ? p.delta[qrow + row] : 0.f;
      }
      __syncthreads();

      // Transposed patches: rows are keys, columns are queries.
      float s[4][4] = {}, dp[4][4] = {};
      patch_abt<float, DP, true>(s, sK, sQ, ty, tx, p.scale);
      patch_abt<float, DP>(dp, sV, sO, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = q0 + tx + 16 * j;
          float pr = 0.f, ds = 0.f;
          if (key_visible(row, key, p.Sq, p.Sk, p.left, p.right)) {
            float x = s[i][j];
            if (bias) x += bias[row * p.bsq + key * p.bsk];
            pr = expf(x - lse[j]);
            ds = pr * (dp[i][j] - dlt[j]);
          }
          sP[(ty * 4 + i) * PS + tx + 16 * j] = pr;
          sS[(ty * 4 + i) * PS + tx + 16 * j] = ds;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = sP[(ty * 4 + i) * PS + qq];
          dsv[i] = sS[(ty * 4 + i) * PS + qq];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float o = sO[qq * S + tx + 16 * c];
          const float qv = sQ[qq * S + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][c] = fmaf(pv[i], o, dv[i][c]);
            dk[i][c] = fmaf(dsv[i], qv, dk[i][c]);
          }
        }
      }
    }
  }

  Tout* dkp = static_cast<Tout*>(p.out0) + krow * p.D;
  Tout* dvp = static_cast<Tout*>(p.out1) + krow * p.D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= p.Sk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < p.D) {
        Elem<Tout>::store(dkp, (long long)key * p.D + col, p.scale * dk[i][c]);
        Elem<Tout>::store(dvp, (long long)key * p.D + col, dv[i][c]);
      }
    }
  }
}

// ---- bf16 inputs: the load stages of the tensor-core bodies ----------------

// Rows [0, 64) of a bf16 matrix with rows of D elements (src: its first
// row; n live rows) into a tile of row stride DP + 8, each value times
// `scale` and rounded to bf16 once when SCALED (bf16(q·scale),
// flash_bwd.py:52); rows at or past n and columns past D are 0. wide: four
// values at a time (D % 4 == 0, src 8-byte aligned).
template <int DP, bool SCALED>
__device__ __forceinline__ void stage_rows_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                int n, int D, bool wide, float scale) {
  constexpr int C4 = DP / 4;
  for (int e = threadIdx.x; e < 64 * C4; e += blockDim.x) {
    const int r = e / C4, c = (e - r * C4) * 4;
    const __nv_bfloat16* row = src + (long long)r * D;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < n) {
      if (wide) {
        if (c < D) load4(row + c, x);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = c + i < D ? __bfloat162float(row[c + i]) : 0.f;
      }
    }
    if (SCALED) {
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = __fmul_rn(x[i], scale);
    }
    store4_bf16(dst + r * (DP + 8) + c, x);  // bf16 values (unscaled): exact
  }
}

// dQ: Q and dO staged once; each key tile's K and V copied by cp.async
// straight into padded tiles, which the products read where they landed
// (three staging buffers, copies two steps ahead, nothing converted, no
// per-key score term).
template <int DP>
struct DenseDqLoad {
  static constexpr int KT = DqTile<DP>::KT, LD = DqTile<DP>::LD;
  static constexpr int NRAW = 3, IN_FLIGHT = 1;
  static constexpr int RAW_BYTES = 2 * KT * LD * 2;  // K, V (bf16, row stride LD)
  struct Kv {
    static constexpr int BYTES = 0;
    __nv_bfloat16* k;
    __nv_bfloat16* v;
    __device__ __forceinline__ Kv(unsigned char*, unsigned char* raw) {
      k = reinterpret_cast<__nv_bfloat16*>(raw);
      v = k + KT * LD;
    }
    __device__ __forceinline__ float score(float x, int) const { return x; }
  };

  // bf16(q·scale), dO, LSE and δ of query rows [q0, q0 + 64); no dP term.
  static __device__ __forceinline__ void stage_q(__nv_bfloat16* sQ, __nv_bfloat16* sO, float* sRow,
                                                 const BwdParams& p, long long qbh, long long,
                                                 int q0) {
    const int n = min(64, p.Sq - q0);
    const long long r0 = qbh * p.Sq + q0;
    stage_rows_bf16<DP, true>(sQ, static_cast<const __nv_bfloat16*>(p.q) + r0 * p.D, n, p.D,
                              p.wide, p.scale);
    stage_rows_bf16<DP, false>(sO, static_cast<const __nv_bfloat16*>(p.dout) + r0 * p.D, n, p.D,
                               p.wide, 1.f);
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
    __nv_bfloat16* k = reinterpret_cast<__nv_bfloat16*>(raw);
    load_tile<KT, DP, LD>(k, static_cast<const __nv_bfloat16*>(p.k) + off, n, p.D, 0, vec);
    load_tile<KT, DP, LD>(k + KT * LD, static_cast<const __nv_bfloat16*>(p.v) + off, n, p.D, 0, vec);
  }

  static __device__ __forceinline__ void stage(const unsigned char*, const Kv&, const BwdParams&,
                                               long long, int) {}
};

// dK/dV: a query tile as the products read it. Its staging buffer (three
// of them, copied two steps ahead) holds the raw Q (dK's operand,
// flash_bwd.py:451-456), dO, LSE and δ as they landed; its converted buffer
// bf16(q·scale) (Sᵀ's operand, flash_bwd.py:52) and the dP term vt = 0. At
// D 64 the scale 1/8 is exact and the two Q operands agree; at D 80 or 128
// dK from the scaled Q would be off by relerr ~1e-3.
template <int DP>
struct DenseQTile {
  static constexpr int QT = DkvTile<DP>::QT, LD = DkvTile<DP>::LD;
  static constexpr int BYTES = QT * LD * 2 + QT * 4;  // bf16(q·scale), vt
  static constexpr int RAW_O = QT * LD * 2;
  static constexpr int RAW_L = 2 * QT * LD * 2;
  static constexpr int RAW_D = RAW_L + QT * 4;
  static constexpr int RAW_BYTES = RAW_D + QT * 4;  // Q, dO (bf16, LD), LSE, δ
  __nv_bfloat16* q;
  __nv_bfloat16* qk;
  __nv_bfloat16* o;
  float* vt;
  float* lse;
  float* delta;
  __device__ __forceinline__ DenseQTile(unsigned char* conv, unsigned char* raw) {
    q = reinterpret_cast<__nv_bfloat16*>(conv);
    vt = reinterpret_cast<float*>(q + QT * LD);
    qk = reinterpret_cast<__nv_bfloat16*>(raw);
    o = reinterpret_cast<__nv_bfloat16*>(raw + RAW_O);
    lse = reinterpret_cast<float*>(raw + RAW_L);
    delta = reinterpret_cast<float*>(raw + RAW_D);
  }
};

template <int DP>
struct DenseLoad {
  using G = DkvTile<DP>;
  using Tile = DenseQTile<DP>;
  static constexpr int NRAW = 3, RAW_BYTES = Tile::RAW_BYTES;

  static __device__ __forceinline__ float dk_scale(const BwdParams& p) { return p.scale; }

  // K and V of key rows [k0, k0 + 64); the dense backward has no V mean.
  static __device__ __forceinline__ void stage_kv(__nv_bfloat16* sK, __nv_bfloat16* sV,
                                                  float* sVm, const BwdParams& p, long long kbh,
                                                  int k0) {
    const int n = min(64, p.Sk - k0);
    const long long off = (kbh * p.Sk + k0) * p.D;
    stage_rows_bf16<DP, false>(sK, static_cast<const __nv_bfloat16*>(p.k) + off, n, p.D, p.wide,
                               1.f);
    stage_rows_bf16<DP, false>(sV, static_cast<const __nv_bfloat16*>(p.v) + off, n, p.D, p.wide,
                               1.f);
    for (int c = threadIdx.x; c < DP; c += blockDim.x) sVm[c] = 0.f;
  }

  // The copies of query rows [q0, q0 + QT) of head qbh into `raw`, as the
  // products read them.
  static __device__ __forceinline__ void issue(unsigned char* raw, const BwdParams& p,
                                               long long qbh, int q0, bool vec) {
    const int n = min(G::QT, p.Sq - q0);
    const long long r0 = qbh * p.Sq + q0;
    load_tile<G::QT, DP, G::LD>(reinterpret_cast<__nv_bfloat16*>(raw),
                                static_cast<const __nv_bfloat16*>(p.q) + r0 * p.D, n, p.D, 0, vec);
    load_tile<G::QT, DP, G::LD>(reinterpret_cast<__nv_bfloat16*>(raw + Tile::RAW_O),
                                static_cast<const __nv_bfloat16*>(p.dout) + r0 * p.D, n, p.D, 0,
                                vec);
    load_rows_f32<G::QT>(reinterpret_cast<float*>(raw + Tile::RAW_L), p.lse + r0, n);
    load_rows_f32<G::QT>(reinterpret_cast<float*>(raw + Tile::RAW_D), p.delta + r0, n);
  }

  // bf16(q·scale) from the raw Q of tile t (zero where it is), eight
  // columns a thread; vt = 0.
  static __device__ __forceinline__ void stage(const unsigned char*, const Tile& t, const float*,
                                               const BwdParams& p, long long, int) {
    constexpr int C8 = DP / 8;
    for (int e = threadIdx.x; e < G::QT * C8; e += blockDim.x) {
      const int r = e / C8, c = (e - r * C8) * 8;
      uint4 w = *reinterpret_cast<const uint4*>(t.qk + r * G::LD + c);
      w.x = scale_bf16x2(w.x, p.scale);
      w.y = scale_bf16x2(w.y, p.scale);
      w.z = scale_bf16x2(w.z, p.scale);
      w.w = scale_bf16x2(w.w, p.scale);
      *reinterpret_cast<uint4*>(t.q + r * G::LD + c) = w;
    }
    for (int r = threadIdx.x; r < G::QT; r += blockDim.x) t.vt[r] = 0.f;
  }
};

template <typename Tout, int DP>
cudaError_t launch_tc(BwdParams p, bool dkv, cudaStream_t stream) {
  // Rows by 16-byte cp.async when every row of q, k, v and dO starts
  // 16-byte aligned.
  const int vec = p.D % 8 == 0 && aligned({p.q, p.k, p.v, p.dout}, 16);
  if (dkv) {
    p.wide = p.D % 4 == 0 && aligned({p.k, p.v}, 8);
    return launch_dkv_tc<DenseLoad<DP>, Tout, DP>(p, vec, stream);
  }
  p.wide = p.D % 4 == 0 && aligned({p.q, p.dout}, 8);
  return launch_dq_tc<DenseDqLoad<DP>, Tout, DP>(p, vec, stream);
}

template <typename Tout, int DP>
cudaError_t launch_simt(const BwdParams& p, bool dkv, cudaStream_t stream) {
  const dim3 grid(((dkv ? p.Sk : p.Sq) + BQ - 1) / BQ, dkv ? p.Hkv : p.Hq, p.B);
  if (dkv) {
    constexpr int smem = simt_dkv_smem_bytes<DP>();
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<Tout, DP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_kernel<Tout, DP><<<grid, NTB, smem, stream>>>(p);
  } else {
    constexpr int smem = simt_dq_smem_bytes<DP>();
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<Tout, DP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_kernel<Tout, DP><<<grid, NTB, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename Tout>
cudaError_t launch_d(const BwdParams& p, bool dkv, bool bf16, cudaStream_t stream) {
  if (!bf16)
    return p.D <= 64 ? launch_simt<Tout, 64>(p, dkv, stream) : launch_simt<Tout, 128>(p, dkv, stream);
  if (p.D <= 64) return launch_tc<Tout, 64>(p, dkv, stream);
  if (p.D <= 128) return launch_tc<Tout, 128>(p, dkv, stream);
  return launch_tc<Tout, 256>(p, dkv, stream);
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
// (B, Hkv, Sk, D) contiguous in in_dtype, D <= 256 for bfloat16 (tensor
// cores) and <= 128 for float32 (CUDA cores); lse, delta (B, Hq, Sq)
// float32; bias float32 with element strides (or null). umfa_flash_bwd_dq
// writes out0 = dQ (B, Hq, Sq, D); umfa_flash_bwd_dkv writes out0 = dK and
// out1 = dV (B, Hkv, Sk, D); both in out_dtype. Each returns the
// cudaError_t of its launch.
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

// Dynamic shared memory of the tensor-core dQ (dkv = 0) or dK/dV (dkv = 1)
// kernel (bfloat16 inputs) for head dim D, in bytes (0 if it does not take D).
extern "C" int umfa_flash_bwd_smem_bytes(int D, int dkv) {
  if (D < 1 || D > 256) return 0;
  if (dkv)
    return D <= 64    ? dkv_smem_bytes<DenseLoad<64>, 64>()
           : D <= 128 ? dkv_smem_bytes<DenseLoad<128>, 128>()
                      : dkv_smem_bytes<DenseLoad<256>, 256>();
  return D <= 64    ? dq_smem_bytes<DenseDqLoad<64>, 64>()
         : D <= 128 ? dq_smem_bytes<DenseDqLoad<128>, 128>()
                    : dq_smem_bytes<DenseDqLoad<256>, 256>();
}
