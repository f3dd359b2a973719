// Dense flash-attention forward (out + LSE) for Hopper, sm_90a.
//
// Replaces umfa_tpu/ops/flash_fwd.py:296 `_fwd_kernel` (host
// `flash_attention_forward`, flash_fwd.py:762), without its block-sparse
// walk and its in-kernel RoPE.
//
// What bounds it on this card: at the serving shapes (D = 64, causal
// prefill of 4032 queries against 4096 cached keys) the work is 4*D flops
// per visible (query, key) pair against ~2*D bytes of Q/K/V per row read
// once, so it is compute-bound: ~0.27 ms of bf16 tensor-core time per layer
// at B8 H16 against ~0.06 ms of HBM time.
//
// What this design does about it: this first version is simple and exact
// rather than fast. Products run as FP32 FMAs on the CUDA cores (exact for
// bf16 operands, full FP32 for fp32 ones: no TF32), so its own ceiling is
// the 67 TFLOP/s FP32 rate, not the tensor cores. One block of 128 threads
// per (64-row query tile, q head, batch); K/V tiles of 64 keys are staged
// in shared memory as FP32; each thread owns a 4x8 patch of the score tile
// and 4 rows x D/8 columns of the FP32 accumulator; the online-softmax
// state (m, l) stays in registers; key tiles that causal/window make
// invisible are never loaded. wgmma, TMA and warp specialisation are later
// work.
//
// Semantics held to the reference:
//   * the softmax scale is folded into Q once and Q is rounded back to the
//     input type (the TPU kernel's q scratch);
//   * P is rounded to the input type before P·V and the row sum l adds the
//     rounded P (the reference's ones-column row sum at D < 128);
//   * index masking (causal, window, KV tail) sets the score to -1e30 and
//     zeroes P; a -1e30 *bias* is not an index mask (a row masked by bias
//     alone averages uniformly); a row with no visible key outputs exactly
//     0 with LSE -1e30;
//   * GQA: q head h reads kv head h / (Hq / Hkv);
//   * bias: FP32, any broadcast shape, given as four element strides
//     (0 = broadcast dimension).
#include "common.cuh"

using namespace umfa;

namespace {

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  void* out;
  float* lse;
  int B, Hq, Hkv, Sq, Sk, D;
  long long bsb, bsh, bsq, bsk;
  float scale;
  int left, right;
};

template <int DP>
constexpr int fwd_smem_bytes() {
  return (BQ * (DP + 1) + BK * (DP + 1) + BK * DP + BQ * (BK + 1)) * (int)sizeof(float);
}

template <typename Tin, typename Tout, int DP>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(const FwdParams p) {
  constexpr int QS = DP + 1;  // +1: row-strided reads hit distinct banks
  constexpr int PS = BK + 1;
  constexpr int NC = DP / 8;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * QS;
  float* sV = sK + BK * QS;
  float* sP = sV + BK * DP;

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const Tin* q = static_cast<const Tin*>(p.q) + ((long long)b * p.Hq + h) * p.Sq * p.D;
  const Tin* k = static_cast<const Tin*>(p.k) + ((long long)b * p.Hkv + hk) * p.Sk * p.D;
  const Tin* v = static_cast<const Tin*>(p.v) + ((long long)b * p.Hkv + hk) * p.Sk * p.D;
  const float* bias = p.bias ? p.bias + b * p.bsb + h * p.bsh : nullptr;

  for (int e = tid; e < BQ * DP; e += NT) {
    const int r = e / DP, c = e - r * DP;
    float x = 0.f;
    if (q0 + r < p.Sq && c < p.D)
      x = Elem<Tin>::round(Elem<Tin>::load(q, (long long)(q0 + r) * p.D + c) * p.scale);
    sQ[r * QS + c] = x;
  }

  int k_lo, k_hi;
  visible_keys(q0, min(q0 + BQ, p.Sq) - 1, p.Sk, p.left, p.right, &k_lo, &k_hi);
  const int t_lo = k_lo / BK;
  const int t_hi = k_hi >= k_lo ? k_hi / BK : t_lo - 1;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASK_VALUE;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // sQ written; the previous tile's sK/sV/sP consumed
    for (int e = tid; e < BK * DP; e += NT) {
      const int r = e / DP, c = e - r * DP;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < p.Sk && c < p.D) {
        const long long i = (long long)(k0 + r) * p.D + c;
        kx = Elem<Tin>::load(k, i);
        vx = Elem<Tin>::load(v, i);
      }
      sK[r * QS + c] = kx;
      sV[r * DP + c] = vx;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float a[4], kb[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kb[j] = sK[(tx + 8 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], kb[j], s[i][j]);
    }

    unsigned vis = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + tx + 8 * j;
        if (key_visible(row, col, p.Sq, p.Sk, p.left, p.right)) {
          if (bias) s[i][j] += bias[row * p.bsq + col * p.bsk];
          vis |= 1u << (i * 8 + j);
        } else {
          s[i][j] = MASK_VALUE;
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < 8; ++j) mx = fmaxf(mx, s[i][j]);
      const float m_new = fmaxf(m[i], row_max8(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float pj = (vis >> (i * 8 + j)) & 1u ? expf(s[i][j] - m_new) : 0.f;
        pj = Elem<Tin>::round(pj);
        rs += pj;
        sP[(ty * 4 + i) * PS + tx + 8 * j] = pj;
      }
      l[i] = alpha * l[i] + row_sum8(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pp[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pp[i] = sP[(ty * 4 + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = sV[kk * DP + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pp[i], vv, acc[i][c]);
      }
    }
  }

  Tout* out = static_cast<Tout*>(p.out) + ((long long)b * p.Hq + h) * p.Sq * p.D;
  float* lse = p.lse + ((long long)b * p.Hq + h) * p.Sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.Sq) continue;
    const bool empty = l[i] == 0.f;
    const float l_safe = empty ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 8 * c;
      if (col < p.D) Elem<Tout>::store(out, (long long)row * p.D + col, acc[i][c] / l_safe);
    }
    if (tx == 0) lse[row] = empty ? MASK_VALUE : m[i] + logf(l_safe);
  }
}

template <typename Tin, typename Tout, int DP>
cudaError_t launch(const FwdParams& p, cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<Tin, Tout, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, p.B);
  flash_fwd_kernel<Tin, Tout, DP><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename Tin, typename Tout>
cudaError_t launch_d(const FwdParams& p, cudaStream_t stream) {
  if (p.D <= 64) return launch<Tin, Tout, 64>(p, stream);
  return launch<Tin, Tout, 128>(p, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. q/k/v contiguous (B, H, S, D);
// out (B, Hq, Sq, D) in out_dtype; lse (B, Hq, Sq) float32. Returns the
// cudaError_t of the launch.
extern "C" int umfa_flash_fwd(const void* q, const void* k, const void* v, const void* bias,
                              void* out, void* lse, int B, int Hq, int Hkv, int Sq, int Sk,
                              int D, long long bsb, long long bsh, long long bsq,
                              long long bsk, float scale, int left, int right, int in_dtype,
                              int out_dtype, void* stream) {
  if (D < 1 || D > 128 || Hkv < 1 || Hq % Hkv != 0 || in_dtype < 0 || in_dtype > 1 ||
      out_dtype < 0 || out_dtype > 1)
    return cudaErrorInvalidValue;
  const FwdParams p{q,   k,   v,   static_cast<const float*>(bias), out, static_cast<float*>(lse),
                    B,   Hq,  Hkv, Sq,  Sk,  D, bsb, bsh, bsq, bsk, scale, left, right};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0)
    return out_dtype == 0 ? launch_d<float, float>(p, st) : launch_d<float, __nv_bfloat16>(p, st);
  return out_dtype == 0 ? launch_d<__nv_bfloat16, float>(p, st)
                        : launch_d<__nv_bfloat16, __nv_bfloat16>(p, st);
}
