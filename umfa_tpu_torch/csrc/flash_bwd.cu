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
// What this design does about it: this first version is simple and exact
// rather than fast. Products run as FP32 FMAs on the CUDA cores (exact for
// bf16 operands, full FP32 for fp32 ones: no TF32), so its own ceiling is
// the 67 TFLOP/s FP32 rate. Every output tile has one owner and nothing is
// summed with atomics, so both passes are deterministic:
//   * dQ: one block of 256 threads per (64-row query tile, q head, batch)
//     walks the key tiles the causal/window rule leaves visible, with Q·scale
//     and dO staged once and K, V staged per tile;
//   * dK/dV: one block per (64-row key tile, kv head, batch) keeps K and V
//     staged and walks the query heads of its GQA group and, for each, the
//     visible query tiles, so the group sum happens in registers and no
//     per-query-head dK/dV ever reaches HBM (flash_bwd.py:1144-1170).
// All tiles are staged in dynamic shared memory as fp32 (83-165 KB a
// block). Each thread holds a 4 x 4 patch of the 64 x 64 score tile and 4
// rows x D/16 columns of each gradient accumulator. wgmma, TMA and warp
// specialisation are later work.
//
// Rounding points held to the reference (bf16 inputs; fp32 rounds nowhere):
//   * Q·scale is rounded to the input type before S (flash_bwd.py:52);
//   * dO arrives in V's type (the wrapper casts it) for dP and dV
//     (:168, :437);
//   * P is rounded to V's type for dV (:437); dS to K's type for dQ (:175)
//     and to Q's type for dK (:452);
//   * scale multiplies the dQ and dK accumulators, not dS (:174, :451);
//   * accumulation is fp32; the store type is the wrapper's grad_dtype.
// Masking: index-hidden pairs (causal, window, KV tail, padded rows) have
// P = 0; a -1e30 bias is not an index mask. Bias: fp32, any broadcast
// shape, four element strides (0 = broadcast dimension, q-broadcast too).
#include "common.cuh"

using namespace umfa;

namespace {

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  const float* bias;
  void* out0;  // dQ, or dK
  void* out1;  // unused, or dV
  int B, Hq, Hkv, Sq, Sk, D;
  long long bsb, bsh, bsq, bsk;
  float scale;
  int left, right;
};

template <int DP>
constexpr int dq_smem_bytes() {
  return (4 * 64 * (DP + 1) + 64 * (BK + 1)) * (int)sizeof(float);
}

template <int DP>
constexpr int dkv_smem_bytes() {
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

template <typename Tin, typename Tout, int DP>
__global__ void __launch_bounds__(NTB) flash_bwd_dkv_kernel(const BwdParams p) {
  constexpr int S = DP + 1;
  constexpr int PS = BQ + 1;
  constexpr int NC = DP / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * S;
  float* sQ = sV + BK * S;  // raw q (scaled on the fly for S)
  float* sO = sQ + BQ * S;  // dO
  float* sP = sO + BQ * S;  // round(Pᵀ), BK x PS
  float* sS = sP + BK * PS;  // round(dSᵀ), BK x PS

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.Hq / p.Hkv;
  const long long krow = ((long long)b * p.Hkv + hk) * p.Sk;
  stage_rows<Tin, DP>(sK, static_cast<const Tin*>(p.k) + krow * p.D, k0, p.Sk, p.D);
  stage_rows<Tin, DP>(sV, static_cast<const Tin*>(p.v) + krow * p.D, k0, p.Sk, p.D);

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
    const Tin* q = static_cast<const Tin*>(p.q) + qrow * p.D;
    const Tin* dout = static_cast<const Tin*>(p.dout) + qrow * p.D;
    const float* bias = p.bias ? p.bias + b * p.bsb + h * p.bsh : nullptr;
    for (int t = t_lo; t <= t_hi; ++t) {
      const int q0 = t * BQ;
      __syncthreads();  // sK/sV staged; the previous tile's sQ/sO/sP/sS consumed
      stage_rows<Tin, DP>(sQ, q, q0, p.Sq, p.D);
      stage_rows<Tin, DP>(sO, dout, q0, p.Sq, p.D);
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
      patch_abt<Tin, DP, true>(s, sK, sQ, ty, tx, p.scale);
      patch_abt<Tin, DP>(dp, sV, sO, ty, tx);
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
          sP[(ty * 4 + i) * PS + tx + 16 * j] = Elem<Tin>::round(pr);
          sS[(ty * 4 + i) * PS + tx + 16 * j] = Elem<Tin>::round(ds);
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

template <typename Tin, typename Tout, int DP>
cudaError_t launch(const BwdParams& p, bool dkv, cudaStream_t stream) {
  const void* fn = dkv ? (const void*)flash_bwd_dkv_kernel<Tin, Tout, DP>
                       : (const void*)flash_bwd_dq_kernel<Tin, Tout, DP>;
  const int smem = dkv ? dkv_smem_bytes<DP>() : dq_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (dkv) {
    const dim3 grid((p.Sk + BK - 1) / BK, p.Hkv, p.B);
    flash_bwd_dkv_kernel<Tin, Tout, DP><<<grid, NTB, smem, stream>>>(p);
  } else {
    const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, p.B);
    flash_bwd_dq_kernel<Tin, Tout, DP><<<grid, NTB, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename Tin, typename Tout>
cudaError_t launch_d(const BwdParams& p, bool dkv, cudaStream_t stream) {
  if (p.D <= 64) return launch<Tin, Tout, 64>(p, dkv, stream);
  return launch<Tin, Tout, 128>(p, dkv, stream);
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
// (B, Hkv, Sk, D) contiguous in in_dtype; lse, delta (B, Hq, Sq) float32;
// bias float32 with element strides (or null). umfa_flash_bwd_dq writes
// out0 = dQ (B, Hq, Sq, D); umfa_flash_bwd_dkv writes out0 = dK and
// out1 = dV (B, Hkv, Sk, D); both in out_dtype. Each returns the cudaError_t
// of its launch.
#define UMFA_BWD_ARGS                                                                        \
  const void *q, const void *k, const void *v, const void *dout, const void *lse,           \
      const void *delta, const void *bias, void *out0, void *out1, int B, int Hq, int Hkv, \
      int Sq, int Sk, int D, long long bsb, long long bsh, long long bsq, long long bsk,    \
      float scale, int left, int right, int in_dtype, int out_dtype, void *stream
#define UMFA_BWD_PARAMS                                                                       \
  BwdParams {                                                                                 \
    q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),          \
        static_cast<const float*>(bias), out0, out1, B, Hq, Hkv, Sq, Sk, D, bsb, bsh, bsq,   \
        bsk, scale, left, right                                                               \
  }

extern "C" int umfa_flash_bwd_dq(UMFA_BWD_ARGS) {
  return dispatch(UMFA_BWD_PARAMS, false, in_dtype, out_dtype, stream);
}

extern "C" int umfa_flash_bwd_dkv(UMFA_BWD_ARGS) {
  return dispatch(UMFA_BWD_PARAMS, true, in_dtype, out_dtype, stream);
}
