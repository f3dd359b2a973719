// Gradient of an additive attention bias for Hopper, sm_90a.
//
// Replaces umfa_tpu/ops/flash_bwd.py:628 `_dbias_kernel` (host
// `flash_attention_bias_grad`, flash_bwd.py:708): dbias = dS = P∘(dP − δ),
// with no softmax scale (the bias enters the scores after it,
// flash_bwd.py:699-701), summed over the bias's broadcast batch and head
// dimensions inside the kernel, so the (B, H, Sq, Sk) gradient is never
// written for a (1, 1, Sq, Sk) bias. The wrapper (ops/flash_bwd.py) gives
// delta = rowsum(dO∘O) in fp32, dO in the input type, and a q-broadcast
// bias expanded (stride 0) and its gradient summed afterwards.
//
// What bounds it on this card: per (batch, head) it recomputes S = Q·Kᵀ and
// dP = dO·Vᵀ (2 products, 4·D flops a visible pair) but writes a dense fp32
// (Bb, Hb, Sq, Sk) result and reads the bias once: for a per-head bias at
// the attention() shape (B2 Hq16 S1024 D64) the 4 bytes written and read a
// pair outweigh the flops, so it is bound by bytes; for a shared
// (1, 1, S, S) bias summed over many heads it is bound by operations.
//
// What this design does about it: simple and exact first. One block of 256
// threads owns one 64 x 64 (query, key) tile of one (bias batch, bias head)
// and walks the batches and heads it sums over in a fixed order (one owner,
// no atomics: deterministic), staging Q·scale (rounded to the input type),
// dO, K and V per step as fp32 in dynamic shared memory (66-132 KB); FP32
// FMAs on the CUDA cores, each thread a 4 x 4 patch. A tile the causal or
// window rule hides entirely is written as zeros without being computed.
// P uses the LSE as given: index-hidden pairs have P = 0, as in the
// reference (a row masked by a -1e30 bias alone is not index-hidden).
#include "common.cuh"

using namespace umfa;

namespace {

struct DbiasParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  const float* bias;
  float* dbias;
  int B, Hq, Hkv, Sq, Sk, D, Bb, Hb;
  long long bsb, bsh, bsq, bsk;
  float scale;
  int left, right;
};

template <int DP>
constexpr int dbias_smem_bytes() {
  return 4 * 64 * (DP + 1) * (int)sizeof(float);
}

template <typename Tin, int DP>
__global__ void __launch_bounds__(NTB) flash_dbias_kernel(const DbiasParams p) {
  constexpr int S = DP + 1;
  extern __shared__ float smem[];
  float* sQ = smem;         // round(q · scale)
  float* sO = sQ + BQ * S;  // dO
  float* sK = sO + BQ * S;
  float* sV = sK + BK * S;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * BK, q0 = blockIdx.y * BQ;
  const int bb = blockIdx.z / p.Hb, bh = blockIdx.z - bb * p.Hb;
  const int group = p.Hq / p.Hkv;

  int k_lo, k_hi;
  visible_keys(q0, min(q0 + BQ, p.Sq) - 1, p.Sk, p.left, p.right, &k_lo, &k_hi);
  const bool visible = k_lo <= k_hi && k0 <= k_hi && k0 + BK - 1 >= k_lo;

  float acc[4][4] = {};
  const int nb = p.Bb == 1 ? p.B : 1;
  const int nh = p.Hb == 1 ? p.Hq : 1;
  for (int n = 0; visible && n < nb * nh; ++n) {
    const int b = p.Bb == 1 ? n / nh : bb;
    const int h = p.Hb == 1 ? n % nh : bh;
    const long long qrow = ((long long)b * p.Hq + h) * p.Sq;
    const long long krow = ((long long)b * p.Hkv + h / group) * p.Sk;
    __syncthreads();  // the previous step's tiles consumed
    stage_rows<Tin, DP, true>(sQ, static_cast<const Tin*>(p.q) + qrow * p.D, q0, p.Sq, p.D,
                              p.scale);
    stage_rows<Tin, DP>(sO, static_cast<const Tin*>(p.dout) + qrow * p.D, q0, p.Sq, p.D);
    stage_rows<Tin, DP>(sK, static_cast<const Tin*>(p.k) + krow * p.D, k0, p.Sk, p.D);
    stage_rows<Tin, DP>(sV, static_cast<const Tin*>(p.v) + krow * p.D, k0, p.Sk, p.D);
    float lse[4], dlt[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      lse[i] = row < p.Sq ? p.lse[qrow + row] : 0.f;
      dlt[i] = row < p.Sq ? p.delta[qrow + row] : 0.f;
    }
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    patch_abt<Tin, DP>(s, sQ, sK, ty, tx);
    patch_abt<Tin, DP>(dp, sO, sV, ty, tx);
    const float* bias = p.bias + b * p.bsb + h * p.bsh;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        if (key_visible(row, col, p.Sq, p.Sk, p.left, p.right)) {
          const float pr = expf(s[i][j] + bias[row * p.bsq + col * p.bsk] - lse[i]);
          acc[i][j] += pr * (dp[i][j] - dlt[i]);
        }
      }
    }
  }

  float* out = p.dbias + ((long long)bb * p.Hb + bh) * p.Sq * p.Sk;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      if (col < p.Sk) out[(long long)row * p.Sk + col] = acc[i][j];
    }
  }
}

template <typename Tin, int DP>
cudaError_t launch(const DbiasParams& p, cudaStream_t stream) {
  constexpr int smem = dbias_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_dbias_kernel<Tin, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sk + BK - 1) / BK, (p.Sq + BQ - 1) / BQ, p.Bb * p.Hb);
  flash_dbias_kernel<Tin, DP><<<grid, NTB, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename Tin>
cudaError_t launch_d(const DbiasParams& p, cudaStream_t stream) {
  if (p.D <= 64) return launch<Tin, 64>(p, stream);
  return launch<Tin, 128>(p, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. q/dout (B, Hq, Sq, D) and k/v
// (B, Hkv, Sk, D) contiguous in in_dtype; lse, delta (B, Hq, Sq) float32;
// bias float32 with element strides; dbias float32 (Bb, Hb, Sq, Sk)
// contiguous, Bb in {1, B}, Hb in {1, Hq}. Returns the cudaError_t of the
// launch.
extern "C" int umfa_flash_dbias(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, const void* bias,
                                void* dbias, int B, int Hq, int Hkv, int Sq, int Sk, int D,
                                int Bb, int Hb, long long bsb, long long bsh, long long bsq,
                                long long bsk, float scale, int left, int right, int in_dtype,
                                void* stream) {
  if (D < 1 || D > 128 || Hkv < 1 || Hq % Hkv != 0 || in_dtype < 0 || in_dtype > 1 ||
      !(Bb == 1 || Bb == B) || !(Hb == 1 || Hb == Hq) || bias == nullptr)
    return cudaErrorInvalidValue;
  const DbiasParams p{q,  k,  v,  dout, static_cast<const float*>(lse),
                      static_cast<const float*>(delta), static_cast<const float*>(bias),
                      static_cast<float*>(dbias), B, Hq, Hkv, Sq, Sk, D, Bb, Hb,
                      bsb, bsh, bsq, bsk, scale, left, right};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return in_dtype == 0 ? launch_d<float>(p, st) : launch_d<__nv_bfloat16>(p, st);
}
