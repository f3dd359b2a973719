// STE backward on quantized residuals (dQ, then dK/dV) for Hopper, sm_90a.
//
// Replaces umfa_tpu/ops/quant_bwd.py:101 `_q_dq_kernel` and quant_bwd.py:339
// `_q_dkv_kernel` (host `quantized_attention_backward`, quant_bwd.py:589),
// without their block-sparse walks. The host wrapper (ops/quant_bwd.py)
// computes δ = rowsum(dO∘O) − dlse in fp32, gives rows with no visible key
// LSE +1e30 (their gradients are exactly 0), folds the softmax scale into
// Q's scales and multiplies the Q-mean score row by it, as the reference
// does outside its kernels.
//
// What bounds it on this card: at the training shape (B8 Hq16 Hkv8, causal
// S 4096, D 64) the dQ pass does 3 products (S, dP, dQ) and the dK/dV pass 4
// (S, dP, dV, dK) over the visible pairs, 2·D flops each, against reading
// the int8 residuals, dO, LSE and δ once: compute-bound, ~0.42 ms and
// ~0.56 ms of bf16 tensor-core time against ~0.05 ms of HBM time.
//
// What this simple design does about it: flash_bwd.cu's design, with the
// operands dequantized on load. One owner per output tile, no atomics,
// deterministic:
//   * dQ: one block of 256 threads per (64-row query tile, q head, batch)
//     walks the visible key tiles; Q and dO staged once, K and V per tile;
//   * dK/dV: one block per (64-row key tile, kv head, batch) keeps K and V
//     staged and walks the query heads of its GQA group and their visible
//     query tiles, so the group sum (and each head's Q-mean term) stays in
//     registers.
// Products are FP32 FMAs on the CUDA cores on bf16 values (exact), tiles in
// dynamic shared memory as fp32 (~84-150 KB a block).
//
// Arithmetic held to the reference (quant_bwd.py:65-98, :205-251, :448-495):
//   * dequantize on load: bf16(code · scale), INT4 codes unpacked from split
//     halves first ((p & 0xF) ^ 8) − 8 and p >> 4 (arithmetic shift); Q's
//     scale carries the softmax scale; scales per row or per (b, h);
//   * P = exp(q̃·k̃ + corr + bias − lse), 0 where the index mask hides a key;
//   * dP = bf16(dO)·ṽ + Σ_d dO·vm (dO in its own precision for the vm term);
//   * dS = P∘(dP − δ); dQ = scale · bf16(dS)·k̃; dV = bf16(P)ᵀ·bf16(dO);
//     dK = bf16(dS)ᵀ·q̃ + scale·colsum(dS)ᵀ·qm per query head;
//   * fp32 accumulation; stored in the wrapper's grad dtype.
#include "common.cuh"

using namespace umfa;

namespace {

struct QBwdParams {
  const int8_t* q;
  const int8_t* k;
  const int8_t* v;
  const float* qs;  // (B, Hq, Sq | 1), softmax scale folded in
  const float* ks;  // (B, Hkv, Sk | 1)
  const float* vs;
  const void* dout;
  const float* lse;
  const float* delta;
  const float* qm;    // (B, Hq, D) or null
  const float* vm;    // (B, Hkv, D) or null
  const float* corr;  // (B, Hq, Sk), times scale, or null
  const float* bias;
  void* out0;  // dQ, or dK
  void* out1;  // unused, or dV
  int B, Hq, Hkv, Sq, Sk, D;
  int qs_rows, ks_rows, vs_rows;
  long long bsb, bsh, bsq, bsk;
  float scale;
  int left, right;
  int int4;  // bit 0: Q, bit 1: K, bit 2: V
};

// Rows [r0, r0 + 64) of dO as bf16(dO) in fp32 (row stride DP + 1; rows
// past `nrows` and columns past D are 0).
template <typename T, int DP>
__device__ __forceinline__ void stage_bf16(float* dst, const T* src, int r0, int nrows, int D) {
  for (int e = threadIdx.x; e < 64 * DP; e += blockDim.x) {
    const int r = e / DP, c = e - r * DP;
    dst[r * (DP + 1) + c] =
        r0 + r < nrows && c < D ? round_bf16(Elem<T>::load(src, (long long)(r0 + r) * D + c)) : 0.f;
  }
}

// vt[r] = Σ_d dO[r0 + r][d] · vm[d] for the 64 rows of a query tile (0 past
// nrows or without vm), FMAs in index order.
template <typename Tdo>
__device__ __forceinline__ void stage_vm_term(float* vt, const Tdo* dout, const float* vm,
                                              int r0, int nrows, int D) {
  for (int r = threadIdx.x; r < 64; r += blockDim.x) {
    float acc = 0.f;
    if (vm && r0 + r < nrows)
      for (int d = 0; d < D; ++d)
        acc = fmaf(Elem<Tdo>::load(dout, (long long)(r0 + r) * D + d), vm[d], acc);
    vt[r] = acc;
  }
}

template <int DP>
constexpr int qdq_smem_bytes() {
  return (4 * 64 * (DP + 1) + 64 * (BK + 1) + 64) * (int)sizeof(float);
}

template <int DP>
constexpr int qdkv_smem_bytes() {
  return (4 * 64 * (DP + 1) + 2 * 64 * (BQ + 1) + 64) * (int)sizeof(float);
}

template <typename Tdo, typename Tout, int DP>
__global__ void __launch_bounds__(NTB) quant_bwd_dq_kernel(const QBwdParams p) {
  constexpr int S = DP + 1;
  constexpr int PS = BK + 1;
  constexpr int NC = DP / 16;
  extern __shared__ float smem[];
  float* sQ = smem;          // q̃
  float* sO = sQ + BQ * S;   // bf16(dO)
  float* sK = sO + BQ * S;   // k̃
  float* sV = sK + BK * S;   // ṽ
  float* sS = sV + BK * S;   // bf16(dS), BQ x PS
  float* sVt = sS + BQ * PS;  // the vm term per query row

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int D = p.D;
  const bool q4 = p.int4 & 1, k4 = p.int4 & 2, v4 = p.int4 & 4;
  const long long qbh = (long long)b * p.Hq + h, kbh = (long long)b * p.Hkv + hk;
  const long long qrow = qbh * p.Sq, krow = kbh * p.Sk;
  const int qw = q4 ? D / 2 : D, kw = k4 ? D / 2 : D, vw = v4 ? D / 2 : D;
  const Tdo* dout = static_cast<const Tdo*>(p.dout) + qrow * D;
  const float* bias = p.bias ? p.bias + b * p.bsb + h * p.bsh : nullptr;
  const float* corr = p.corr ? p.corr + qbh * p.Sk : nullptr;

  stage_deq<DP>(sQ, p.q + qrow * qw, p.qs + qbh * (p.qs_rows ? p.Sq : 1), p.qs_rows, q0, p.Sq,
                D, q4);
  stage_bf16<Tdo, DP>(sO, dout, q0, p.Sq, D);
  stage_vm_term<Tdo>(sVt, dout, p.vm ? p.vm + kbh * D : nullptr, q0, p.Sq, D);
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
    __syncthreads();  // sQ/sO/sVt staged; the previous tile's sK/sV/sS consumed
    stage_deq<DP>(sK, p.k + krow * kw, p.ks + kbh * (p.ks_rows ? p.Sk : 1), p.ks_rows, k0, p.Sk,
                  D, k4);
    stage_deq<DP>(sV, p.v + krow * vw, p.vs + kbh * (p.vs_rows ? p.Sk : 1), p.vs_rows, k0, p.Sk,
                  D, v4);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    patch_abt<float, DP>(s, sQ, sK, ty, tx);
    patch_abt<float, DP>(dp, sO, sV, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      const float vt = sVt[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float ds = 0.f;
        if (key_visible(row, col, p.Sq, p.Sk, p.left, p.right)) {
          float x = s[i][j];
          if (corr) x = __fadd_rn(x, corr[col]);
          if (bias) x = __fadd_rn(x, bias[row * p.bsq + col * p.bsk]);
          const float pr = expf(x - lse[i]);
          ds = __fmul_rn(pr, __fadd_rn(dp[i][j], vt) - dlt[i]);
        }
        sS[(ty * 4 + i) * PS + tx + 16 * j] = round_bf16(ds);
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

  Tout* dq = static_cast<Tout*>(p.out0) + qrow * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) Elem<Tout>::store(dq, (long long)row * D + col, p.scale * acc[i][c]);
    }
  }
}

template <typename Tdo, typename Tout, int DP>
__global__ void __launch_bounds__(NTB) quant_bwd_dkv_kernel(const QBwdParams p) {
  constexpr int S = DP + 1;
  constexpr int PS = BQ + 1;
  constexpr int NC = DP / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * S;
  float* sQ = sV + BK * S;    // q̃
  float* sO = sQ + BQ * S;    // bf16(dO)
  float* sP = sO + BQ * S;    // bf16(Pᵀ), BK x PS
  float* sS = sP + BK * PS;   // bf16(dSᵀ), BK x PS
  float* sVt = sS + BK * PS;  // the vm term per query row

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.Hq / p.Hkv;
  const int D = p.D;
  const bool q4 = p.int4 & 1, k4 = p.int4 & 2, v4 = p.int4 & 4;
  const long long kbh = (long long)b * p.Hkv + hk, krow = kbh * p.Sk;
  const int qw = q4 ? D / 2 : D, kw = k4 ? D / 2 : D, vw = v4 ? D / 2 : D;
  stage_deq<DP>(sK, p.k + krow * kw, p.ks + kbh * (p.ks_rows ? p.Sk : 1), p.ks_rows, k0, p.Sk, D,
                k4);
  stage_deq<DP>(sV, p.v + krow * vw, p.vs + kbh * (p.vs_rows ? p.Sk : 1), p.vs_rows, k0, p.Sk, D,
                v4);
  const float* vm = p.vm ? p.vm + kbh * D : nullptr;

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
    const long long qbh = (long long)b * p.Hq + h, qrow = qbh * p.Sq;
    const int8_t* qv = p.q + qrow * qw;
    const float* qs = p.qs + qbh * (p.qs_rows ? p.Sq : 1);
    const Tdo* dout = static_cast<const Tdo*>(p.dout) + qrow * D;
    const float* bias = p.bias ? p.bias + b * p.bsb + h * p.bsh : nullptr;
    const float* corr = p.corr ? p.corr + qbh * p.Sk : nullptr;
    float cs[4] = {0.f, 0.f, 0.f, 0.f};  // this thread's part of colsum(dS), per key row
    for (int t = t_lo; t <= t_hi; ++t) {
      const int q0 = t * BQ;
      __syncthreads();  // sK/sV staged; the previous tile's sQ/sO/sP/sS/sVt consumed
      stage_deq<DP>(sQ, qv, qs, p.qs_rows, q0, p.Sq, D, q4);
      stage_bf16<Tdo, DP>(sO, dout, q0, p.Sq, D);
      stage_vm_term<Tdo>(sVt, dout, vm, q0, p.Sq, D);
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
      patch_abt<float, DP>(s, sK, sQ, ty, tx);
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
            if (corr) x = __fadd_rn(x, corr[key]);
            if (bias) x = __fadd_rn(x, bias[row * p.bsq + key * p.bsk]);
            pr = expf(x - lse[j]);
            ds = __fmul_rn(pr, __fadd_rn(dp[i][j], sVt[tx + 16 * j]) - dlt[j]);
          }
          cs[i] += ds;
          sP[(ty * 4 + i) * PS + tx + 16 * j] = round_bf16(pr);
          sS[(ty * 4 + i) * PS + tx + 16 * j] = round_bf16(ds);
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
          const float qv_ = sQ[qq * S + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][c] = fmaf(pv[i], o, dv[i][c]);
            dk[i][c] = fmaf(dsv[i], qv_, dk[i][c]);
          }
        }
      }
    }
    if (p.qm) {
      // dK += scale · colsum(dS)ᵀ · qm of this query head. The 16 lanes
      // that share a key row (same ty) are one half-warp.
      const float* qm = p.qm + qbh * D;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float c = cs[i];
        c += __shfl_xor_sync(0xffffffffu, c, 1);
        c += __shfl_xor_sync(0xffffffffu, c, 2);
        c += __shfl_xor_sync(0xffffffffu, c, 4);
        c += __shfl_xor_sync(0xffffffffu, c, 8);
        const float sc = p.scale * c;
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const int col = tx + 16 * cc;
          if (col < D) dk[i][cc] = fmaf(sc, qm[col], dk[i][cc]);
        }
      }
    }
  }

  Tout* dkp = static_cast<Tout*>(p.out0) + krow * D;
  Tout* dvp = static_cast<Tout*>(p.out1) + krow * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= p.Sk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) {
        Elem<Tout>::store(dkp, (long long)key * D + col, dk[i][c]);
        Elem<Tout>::store(dvp, (long long)key * D + col, dv[i][c]);
      }
    }
  }
}

template <typename Tdo, typename Tout, int DP>
cudaError_t launch(const QBwdParams& p, bool dkv, cudaStream_t stream) {
  const void* fn = dkv ? (const void*)quant_bwd_dkv_kernel<Tdo, Tout, DP>
                       : (const void*)quant_bwd_dq_kernel<Tdo, Tout, DP>;
  const int smem = dkv ? qdkv_smem_bytes<DP>() : qdq_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (dkv) {
    const dim3 grid((p.Sk + BK - 1) / BK, p.Hkv, p.B);
    quant_bwd_dkv_kernel<Tdo, Tout, DP><<<grid, NTB, smem, stream>>>(p);
  } else {
    const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, p.B);
    quant_bwd_dq_kernel<Tdo, Tout, DP><<<grid, NTB, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename Tdo, typename Tout>
cudaError_t launch_d(const QBwdParams& p, bool dkv, cudaStream_t stream) {
  if (p.D <= 64) return launch<Tdo, Tout, 64>(p, dkv, stream);
  return launch<Tdo, Tout, 128>(p, dkv, stream);
}

int dispatch(const QBwdParams& p, bool dkv, int do_dtype, int out_dtype, void* stream) {
  if (p.D < 1 || p.D > 128 || p.Hkv < 1 || p.Hq % p.Hkv != 0 || (p.int4 && p.D % 2) ||
      do_dtype < 0 || do_dtype > 1 || out_dtype < 0 || out_dtype > 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (do_dtype == 0)
    return out_dtype == 0 ? launch_d<float, float>(p, dkv, st)
                          : launch_d<float, __nv_bfloat16>(p, dkv, st);
  return out_dtype == 0 ? launch_d<__nv_bfloat16, float>(p, dkv, st)
                        : launch_d<__nv_bfloat16, __nv_bfloat16>(p, dkv, st);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. q (B, Hq, Sq, D | D/2) and k/v
// (B, Hkv, Sk, D | D/2) int8 codes (packed INT4 where `int4` says so),
// contiguous; scales float32 (B, H, S) or (B, H) per the *_rows flags; dout
// (B, Hq, Sq, D) in do_dtype; lse, delta (B, Hq, Sq) float32; qm (B, Hq, D),
// vm (B, Hkv, D), corr (B, Hq, Sk) float32 or null; bias float32 with
// element strides (or null). umfa_quant_bwd_dq writes out0 = dQ
// (B, Hq, Sq, D); umfa_quant_bwd_dkv writes out0 = dK and out1 = dV
// (B, Hkv, Sk, D); both in out_dtype. Each returns the cudaError_t of its
// launch.
#define UMFA_QBWD_ARGS                                                                          \
  const void *q, const void *k, const void *v, const void *qs, const void *ks, const void *vs, \
      const void *dout, const void *lse, const void *delta, const void *qm, const void *vm,    \
      const void *corr, const void *bias, void *out0, void *out1, int B, int Hq, int Hkv,      \
      int Sq, int Sk, int D, int qs_rows, int ks_rows, int vs_rows, long long bsb,              \
      long long bsh, long long bsq, long long bsk, float scale, int left, int right, int int4, \
      int do_dtype, int out_dtype, void *stream
#define UMFA_QBWD_PARAMS                                                                      \
  QBwdParams {                                                                                \
    static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),                             \
        static_cast<const int8_t*>(v), static_cast<const float*>(qs),                         \
        static_cast<const float*>(ks), static_cast<const float*>(vs), dout,                   \
        static_cast<const float*>(lse), static_cast<const float*>(delta),                     \
        static_cast<const float*>(qm), static_cast<const float*>(vm),                         \
        static_cast<const float*>(corr), static_cast<const float*>(bias), out0, out1, B, Hq,  \
        Hkv, Sq, Sk, D, qs_rows, ks_rows, vs_rows, bsb, bsh, bsq, bsk, scale, left, right,    \
        int4                                                                                  \
  }

extern "C" int umfa_quant_bwd_dq(UMFA_QBWD_ARGS) {
  return dispatch(UMFA_QBWD_PARAMS, false, do_dtype, out_dtype, stream);
}

extern "C" int umfa_quant_bwd_dkv(UMFA_QBWD_ARGS) {
  return dispatch(UMFA_QBWD_PARAMS, true, do_dtype, out_dtype, stream);
}
