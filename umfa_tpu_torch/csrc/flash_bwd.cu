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
//   * dK/dV, bf16 inputs: `dkv_tc_kernel<DenseLoad>`, the tensor-core body
//     of bwd_tc.cuh (mma.sync m16n8k16 bf16 -> fp32) that the quantized
//     backward shares: one block of 4 warps per (64-key tile, kv head,
//     batch) keeps K and V in shared memory and walks the query heads of
//     its GQA group and their visible 32-row query tiles, copying each
//     tile's Q, dO, LSE and δ by cp.async two steps ahead and converting
//     them one step ahead; the group sum stays in registers, so no
//     per-query-head dK/dV reaches HBM (flash_bwd.py:1144-1170);
//   * dK/dV, fp32 inputs (fp16 arrives as fp32): `flash_bwd_dkv_kernel`,
//     FP32 FMAs on the CUDA cores, the same walk with one block of 256
//     threads; TF32 would miss the fp32 gate of 1e-4, and the reference
//     forces HIGHEST precision for fp32 (flash_bwd.py:36-42);
//   * dQ (both dtypes): `flash_bwd_dq_kernel`, FP32 FMAs on the CUDA cores
//     (exact for bf16 operands), one block of 256 threads per (64-row query
//     tile, q head, batch) walking the key tiles the causal/window rule
//     leaves visible, with Q·scale and dO staged once and K, V per tile.
// The CUDA-core kernels stage fp32 tiles in dynamic shared memory (83-165
// KB a block); each thread holds a 4 x 4 patch of the 64 x 64 score tile
// and 4 rows x D/16 columns of each gradient accumulator; their own
// ceiling is the 67 TFLOP/s FP32 rate. Head dims up to 128. wgmma, TMA,
// warp specialisation and dQ on the tensor cores are later work.
//
// Rounding points held to the reference (bf16 inputs; fp32 rounds nowhere):
//   * Q·scale is rounded to the input type before S (flash_bwd.py:52), and
//     dK takes the raw Q with scale on its accumulator (:451-456): the
//     tensor-core load stage converts each Q tile twice;
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

// Dynamic shared memory of the CUDA-core kernels.
template <int DP>
constexpr int simt_dq_smem_bytes() {
  return (4 * 64 * (DP + 1) + 64 * (BK + 1)) * (int)sizeof(float);
}

template <int DP>
constexpr int simt_dkv_smem_bytes() {
  return (4 * 64 * (DP + 1) + 2 * 64 * (BQ + 1)) * (int)sizeof(float);
}

template <typename Tin, typename Tout, int DP>
__global__ void __launch_bounds__(NTB) flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int S = DP + 1;
  constexpr int PS = BK + 1;
  constexpr int NC = DP / 16;
  extern __shared__ float smem[];
  float* sQ = smem;       // round(q · scale)
  float* sO = sQ + BQ * S;  // dO
  float* sK = sO + BQ * S;
  float* sV = sK + BK * S;
  float* sS = sV + BK * S;  // round(dS), BQ x PS

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const long long qrow = ((long long)b * p.Hq + h) * p.Sq;
  const long long krow = ((long long)b * p.Hkv + hk) * p.Sk;
  const Tin* k = static_cast<const Tin*>(p.k) + krow * p.D;
  const Tin* v = static_cast<const Tin*>(p.v) + krow * p.D;
  const float* bias = p.bias ? p.bias + b * p.bsb + h * p.bsh : nullptr;

  stage_rows<Tin, DP, true>(sQ, static_cast<const Tin*>(p.q) + qrow * p.D, q0, p.Sq, p.D,
                            p.scale);
  stage_rows<Tin, DP>(sO, static_cast<const Tin*>(p.dout) + qrow * p.D, q0, p.Sq, p.D);
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
    stage_rows<Tin, DP>(sK, k, k0, p.Sk, p.D);
    stage_rows<Tin, DP>(sV, v, k0, p.Sk, p.D);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    patch_abt<Tin, DP>(s, sQ, sK, ty, tx);
    patch_abt<Tin, DP>(dp, sO, sV, ty, tx);
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
        sS[(ty * 4 + i) * PS + tx + 16 * j] = Elem<Tin>::round(ds);
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

// ---- dK/dV, bf16 inputs: the load stage of dkv_tc_kernel -------------------
//
// Q and dO arrive as bf16 (dO in V's type). Each query tile is converted
// twice: bf16(q·scale) for Sᵀ (flash_bwd.py:52) and the raw Q for dK, whose
// accumulator takes the scale at the store (:451-456). At D 64 the scale
// 1/8 is exact and the two agree; at D 80 or 128 dK from the scaled Q
// would be off by relerr ~1e-3.
template <int DP>
struct DenseLoad {
  using G = DkvTile<DP>;
  using Tile = QTile<DP, true>;
  // Staging buffer: Q, dO (bf16, packed rows of D), LSE, δ.
  static constexpr int RAW_Q = 0;
  static constexpr int RAW_O = G::QT * DP * 2;
  static constexpr int RAW_L = RAW_O + G::QT * DP * 2;
  static constexpr int RAW_D = RAW_L + G::QT * 4;
  static constexpr int RAW_BYTES = RAW_D + G::QT * 4;

  static __device__ __forceinline__ float dk_scale(const BwdParams& p) { return p.scale; }

  // Rows [r0, r0 + 64) of a bf16 (nrows, D) matrix into a tile of row
  // stride DP + 8; rows past nrows and columns past D are 0. wide: four
  // values at a time (D % 4 == 0, src 8-byte aligned).
  static __device__ __forceinline__ void copy_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                   int r0, int nrows, int D, bool wide) {
    constexpr int C4 = DP / 4;
    for (int e = threadIdx.x; e < 64 * C4; e += blockDim.x) {
      const int r = e / C4, c = (e - r * C4) * 4;
      const __nv_bfloat16* row = src + (long long)(r0 + r) * D;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (r0 + r < nrows) {
        if (wide) {
          if (c < D) load4(row + c, x);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) x[i] = c + i < D ? __bfloat162float(row[c + i]) : 0.f;
        }
      }
      store4_bf16(dst + r * (DP + 8) + c, x);  // bf16 values: exact
    }
  }

  // K and V of key rows [k0, k0 + 64); the dense backward has no V mean.
  static __device__ __forceinline__ void stage_kv(__nv_bfloat16* sK, __nv_bfloat16* sV,
                                                  float* sVm, const BwdParams& p, long long kbh,
                                                  int k0) {
    const long long off = kbh * p.Sk * p.D;
    copy_rows(sK, static_cast<const __nv_bfloat16*>(p.k) + off, k0, p.Sk, p.D, p.wide);
    copy_rows(sV, static_cast<const __nv_bfloat16*>(p.v) + off, k0, p.Sk, p.D, p.wide);
    for (int c = threadIdx.x; c < DP; c += blockDim.x) sVm[c] = 0.f;
  }

  // Issue the copies of query rows [q0, q0 + QT) of head qbh into `raw`.
  static __device__ __forceinline__ void issue(unsigned char* raw, const BwdParams& p,
                                               long long qbh, int q0, bool vec) {
    const int n = min(G::QT, p.Sq - q0);
    const long long r0 = qbh * p.Sq + q0;
    copy_bytes(raw + RAW_Q, static_cast<const unsigned char*>(p.q) + r0 * p.D * 2, n * p.D * 2, vec);
    copy_bytes(raw + RAW_O, static_cast<const unsigned char*>(p.dout) + r0 * p.D * 2, n * p.D * 2,
               vec);
    copy_bytes(raw + RAW_L, reinterpret_cast<const unsigned char*>(p.lse + r0), n * 4, vec);
    copy_bytes(raw + RAW_D, reinterpret_cast<const unsigned char*>(p.delta + r0), n * 4, vec);
  }

  // bf16(q·scale), q and dO, LSE and δ from `raw` into tile `t` (rows past
  // Sq and columns past D zero); four columns a thread.
  static __device__ __forceinline__ void stage(const unsigned char* raw, const Tile& t,
                                               const float*, const BwdParams& p, long long,
                                               int q0) {
    constexpr int C4 = DP / 4;
    const int n = min(G::QT, p.Sq - q0), D = p.D;
    const __nv_bfloat16* rq = reinterpret_cast<const __nv_bfloat16*>(raw + RAW_Q);
    const __nv_bfloat16* ro = reinterpret_cast<const __nv_bfloat16*>(raw + RAW_O);
    for (int e = threadIdx.x; e < G::QT * C4; e += blockDim.x) {
      const int r = e / C4, c = (e - r * C4) * 4;
      float xq[4] = {0.f, 0.f, 0.f, 0.f}, xo[4] = {0.f, 0.f, 0.f, 0.f}, xs[4];
      if (r < n) {
        if (D % 4 == 0) {
          if (c < D) {
            load4(rq + r * D + c, xq);
            load4(ro + r * D + c, xo);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            xq[i] = c + i < D ? __bfloat162float(rq[r * D + c + i]) : 0.f;
            xo[i] = c + i < D ? __bfloat162float(ro[r * D + c + i]) : 0.f;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) xs[i] = __fmul_rn(xq[i], p.scale);
      store4_bf16(t.q + r * G::LD + c, xs);
      store4_bf16(t.qk + r * G::LD + c, xq);
      store4_bf16(t.o + r * G::LD + c, xo);
    }
    const float* rl = reinterpret_cast<const float*>(raw + RAW_L);
    const float* rd = reinterpret_cast<const float*>(raw + RAW_D);
    for (int r = threadIdx.x; r < G::QT; r += blockDim.x) {
      t.vt[r] = 0.f;
      t.lse[r] = r < n ? rl[r] : 0.f;
      t.delta[r] = r < n ? rd[r] : 0.f;
    }
  }
};

template <typename Tin, typename Tout, int DP>
cudaError_t launch_dq(const BwdParams& p, cudaStream_t stream) {
  constexpr int smem = simt_dq_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<Tin, Tout, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, p.B);
  flash_bwd_dq_kernel<Tin, Tout, DP><<<grid, NTB, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename Tin, typename Tout, int DP>
cudaError_t launch_dkv(BwdParams p, cudaStream_t stream) {
  if constexpr (std::is_same<Tin, __nv_bfloat16>::value) {
    p.wide = p.D % 4 == 0 && aligned({p.k, p.v}, 8);
    // Query tiles by cp.async when every tile's rows start 16-byte aligned.
    const int vec = aligned({p.q, p.dout, p.lse, p.delta}, 16) && p.Sq % 4 == 0 &&
                    p.Sq * (long long)p.D % 8 == 0;
    return launch_dkv_tc<DenseLoad<DP>, Tout, DP>(p, vec, stream);
  } else {
    constexpr int smem = simt_dkv_smem_bytes<DP>();
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<Tout, DP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Sk + BK - 1) / BK, p.Hkv, p.B);
    flash_bwd_dkv_kernel<Tout, DP><<<grid, NTB, smem, stream>>>(p);
    return cudaGetLastError();
  }
}

template <typename Tin, typename Tout>
cudaError_t launch_d(const BwdParams& p, bool dkv, cudaStream_t stream) {
  if (dkv)
    return p.D <= 64 ? launch_dkv<Tin, Tout, 64>(p, stream) : launch_dkv<Tin, Tout, 128>(p, stream);
  return p.D <= 64 ? launch_dq<Tin, Tout, 64>(p, stream) : launch_dq<Tin, Tout, 128>(p, stream);
}

int dispatch(const BwdParams& p, bool dkv, int in_dtype, int out_dtype, void* stream) {
  if (p.D < 1 || p.D > 128 || p.Hkv < 1 || p.Hq % p.Hkv != 0 || in_dtype < 0 || in_dtype > 1 ||
      out_dtype < 0 || out_dtype > 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0)
    return out_dtype == 0 ? launch_d<float, float>(p, dkv, st)
                          : launch_d<float, __nv_bfloat16>(p, dkv, st);
  return out_dtype == 0 ? launch_d<__nv_bfloat16, float>(p, dkv, st)
                        : launch_d<__nv_bfloat16, __nv_bfloat16>(p, dkv, st);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. q/dout (B, Hq, Sq, D) and k/v
// (B, Hkv, Sk, D) contiguous in in_dtype, D <= 128; lse, delta (B, Hq, Sq)
// float32; bias float32 with element strides (or null). umfa_flash_bwd_dq
// writes out0 = dQ (B, Hq, Sq, D); umfa_flash_bwd_dkv writes out0 = dK and
// out1 = dV (B, Hkv, Sk, D) (bfloat16 inputs on the tensor cores, float32 on
// the CUDA cores); both in out_dtype. Each returns the cudaError_t of its
// launch.
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

// Dynamic shared memory of the tensor-core dK/dV kernel (bfloat16 inputs)
// for head dim D, in bytes (0 if it does not take D).
extern "C" int umfa_flash_bwd_dkv_smem_bytes(int D) {
  if (D < 1 || D > 128) return 0;
  return D <= 64 ? dkv_smem_bytes<DenseLoad<64>, 64>() : dkv_smem_bytes<DenseLoad<128>, 128>();
}
