// Quantized (INT8) attention forward on pre-quantized operands, for
// Hopper, sm_90a.
//
// Replaces umfa_tpu/ops/quant_attention.py:74 `_quant_fwd_kernel` (host
// `quantized_attention_forward`, quant_attention.py:295) for symmetric INT8
// operands with per-row or per-tensor scales, bias, causal/window and GQA.
// INT4 operands, asymmetric zero points, the Q-mean correction row, integer
// P·V and block-sparse walks are not ported yet.
//
// What bounds it on this card: at the serving shapes (D = 64, causal
// prefill of 4032 queries against the 4096-row INT8 cache) it is
// compute-bound, like the dense kernel: 2*D integer ops per visible pair for
// QKᵀ (1,979 TOP/s int8 peak) plus 2*D bf16 flops for P·V (989 TFLOP/s),
// against one byte per element of Q/K/V.
//
// What this design does about it: simple and exact first. QKᵀ is an exact
// int8 x int8 -> int32 dot with __dp4a (four products per instruction on the
// CUDA cores); P·V runs as FP32 FMAs on bf16-rounded operands. Same tiling
// as flash_fwd.cu: one block of 128 threads per (64-row query tile, q head,
// batch), 64-key tiles in shared memory, invisible key tiles skipped. Two
// passes over the visible keys: the first computes only QKᵀ and the exact
// row max, the second exponentiates against that final max, so P is rounded
// to bf16 where the plain version rounds it (a one-pass online softmax
// rounds relative to a running max and lands ~1e-3 away). The first pass
// costs one more int8 QKᵀ, the cheap half of the work here. Tensor-core
// int8 mma is later work.
//
// Arithmetic held to the reference (quant_attention.py:166-256):
//   s = float(int32 dot) * q_scale * k_scale, with the softmax scale
//   already folded into q_scale by the host; + bias; index mask -> -1e30;
//   l sums the FP32 P; P·V uses bf16(P) and the dequantized V tile
//   bf16(bf16(v_i8) * bf16(v_scale)), accumulated in FP32; output FP32.
#include "common.cuh"

using namespace umfa;

namespace {

struct QParams {
  const int8_t* q;
  const int8_t* k;
  const int8_t* v;
  const float* qs;  // (B, Hq, Sq | 1) q scales, softmax scale folded in
  const float* ks;  // (B, Hkv, Sk | 1)
  const float* vs;  // (B, Hkv, Sk | 1)
  const float* bias;
  float* out;
  float* lse;
  int B, Hq, Hkv, Sq, Sk, D;
  int qs_rows, ks_rows, vs_rows;  // 1 = one scale per row, 0 = one per (b, h)
  long long bsb, bsh, bsq, bsk;
  int left, right;
};

template <int DP>
constexpr int quant_smem_bytes() {
  return (BQ * (DP / 4 + 1) + BK * (DP / 4 + 1)) * (int)sizeof(int) +
         (BK * DP + BQ * (BK + 1) + BK) * (int)sizeof(float);
}

template <int DP>
__global__ void __launch_bounds__(NT) quant_attn_fwd_kernel(const QParams p) {
  constexpr int W = DP / 4;  // int8x4 words per row
  constexpr int WS = W + 1;
  constexpr int PS = BK + 1;
  constexpr int NC = DP / 8;
  extern __shared__ int smem_i[];
  int* sQ = smem_i;
  int* sK = sQ + BQ * WS;
  float* sV = reinterpret_cast<float*>(sK + BK * WS);
  float* sP = sV + BK * DP;
  float* sKs = sP + BQ * PS;

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int wd = p.D / 4;
  const int* q = reinterpret_cast<const int*>(p.q + ((long long)b * p.Hq + h) * p.Sq * p.D);
  const int* k = reinterpret_cast<const int*>(p.k + ((long long)b * p.Hkv + hk) * p.Sk * p.D);
  const int8_t* v = p.v + ((long long)b * p.Hkv + hk) * p.Sk * p.D;
  const float* qs = p.qs + ((long long)b * p.Hq + h) * (p.qs_rows ? p.Sq : 1);
  const float* ks = p.ks + ((long long)b * p.Hkv + hk) * (p.ks_rows ? p.Sk : 1);
  const float* vs = p.vs + ((long long)b * p.Hkv + hk) * (p.vs_rows ? p.Sk : 1);
  const float* bias = p.bias ? p.bias + b * p.bsb + h * p.bsh : nullptr;

  for (int e = tid; e < BQ * W; e += NT) {
    const int r = e / W, w = e - r * W;
    sQ[r * WS + w] = (q0 + r < p.Sq && w < wd) ? q[(long long)(q0 + r) * wd + w] : 0;
  }
  float qsc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    qsc[i] = row < p.Sq ? qs[p.qs_rows ? row : 0] : 0.f;
  }

  int k_lo, k_hi;
  visible_keys(q0, min(q0 + BQ, p.Sq) - 1, p.Sk, p.left, p.right, &k_lo, &k_hi);
  const int t_lo = k_lo / BK;
  const int t_hi = k_hi >= k_lo ? k_hi / BK : t_lo - 1;

  // K tile (int8x4 words) and its scales into shared memory.
  auto load_k = [&](int k0) {
    for (int e = tid; e < BK * W; e += NT) {
      const int r = e / W, w = e - r * W;
      sK[r * WS + w] = (k0 + r < p.Sk && w < wd) ? k[(long long)(k0 + r) * wd + w] : 0;
    }
    if (tid < BK) sKs[tid] = k0 + tid < p.Sk ? ks[p.ks_rows ? k0 + tid : 0] : 0.f;
  };
  // This thread's 4x8 scores of the tile at k0; returns the bits of the
  // index-visible ones (the others are MASK_VALUE). Explicitly rounded
  // multiplies and add (never contracted): both passes get the same bits.
  auto scores = [&](int k0, float (&s)[4][8]) -> unsigned {
    int si[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) si[i][j] = 0;
#pragma unroll 8
    for (int w = 0; w < W; ++w) {
      int a[4], kb[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty * 4 + i) * WS + w];
#pragma unroll
      for (int j = 0; j < 8; ++j) kb[j] = sK[(tx + 8 * j) * WS + w];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) si[i][j] = __dp4a(a[i], kb[j], si[i][j]);
    }
    unsigned vis = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + tx + 8 * j;
        if (key_visible(row, col, p.Sq, p.Sk, p.left, p.right)) {
          float x = __fmul_rn(__fmul_rn((float)si[i][j], qsc[i]), sKs[tx + 8 * j]);
          if (bias) x = __fadd_rn(x, bias[row * p.bsq + col * p.bsk]);
          s[i][j] = x;
          vis |= 1u << (i * 8 + j);
        } else {
          s[i][j] = MASK_VALUE;
        }
      }
    }
    return vis;
  };

  // Pass 1: the exact row max over every visible key (QKᵀ only), so that
  // pass 2 rounds P to bf16 relative to the final max, as the plain version
  // does, instead of relative to a running max.
  float m[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = MASK_VALUE;
  for (int t = t_lo; t <= t_hi; ++t) {
    __syncthreads();  // sQ written; the previous tile's sK/sKs consumed
    load_k(t * BK);
    __syncthreads();
    float s[4][8];
    scores(t * BK, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) m[i] = fmaxf(m[i], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = row_max8(m[i]);

  // Pass 2: P = exp(s - m) with the final m (no rescaling), l sums the
  // FP32 P, P·V on bf16(P) and the dequantized bf16 V tile.
  float l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's sK/sV/sP/sKs consumed
    load_k(k0);
    for (int e = tid; e < BK * DP; e += NT) {
      const int r = e / DP, c = e - r * DP;
      float x = 0.f;
      if (k0 + r < p.Sk && c < p.D) {
        const float vsc = round_bf16(vs[p.vs_rows ? k0 + r : 0]);
        x = round_bf16((float)v[(long long)(k0 + r) * p.D + c] * vsc);
      }
      sV[r * DP + c] = x;
    }
    __syncthreads();
    float s[4][8];
    const unsigned vis = scores(k0, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pj = (vis >> (i * 8 + j)) & 1u ? expf(s[i][j] - m[i]) : 0.f;
        rs += pj;
        sP[(ty * 4 + i) * PS + tx + 8 * j] = round_bf16(pj);
      }
      l[i] += row_sum8(rs);
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

  float* out = p.out + ((long long)b * p.Hq + h) * p.Sq * p.D;
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
      if (col < p.D) out[(long long)row * p.D + col] = acc[i][c] / l_safe;
    }
    if (tx == 0) lse[row] = empty ? MASK_VALUE : m[i] + logf(l_safe);
  }
}

template <int DP>
cudaError_t launch(const QParams& p, cudaStream_t stream) {
  constexpr int smem = quant_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(quant_attn_fwd_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, p.B);
  quant_attn_fwd_kernel<DP><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D): contiguous int8, D % 4 == 0, 4-byte
// aligned. Scales contiguous float32. out (B, Hq, Sq, D) and lse (B, Hq, Sq)
// float32. Returns the cudaError_t of the launch.
extern "C" int umfa_quant_attn_fwd(const void* q, const void* k, const void* v, const void* qs,
                                   const void* ks, const void* vs, const void* bias, void* out,
                                   void* lse, int B, int Hq, int Hkv, int Sq, int Sk, int D,
                                   int qs_rows, int ks_rows, int vs_rows, long long bsb,
                                   long long bsh, long long bsq, long long bsk, int left,
                                   int right, void* stream) {
  if (D < 4 || D > 128 || D % 4 != 0 || Hkv < 1 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  const QParams p{static_cast<const int8_t*>(q),
                  static_cast<const int8_t*>(k),
                  static_cast<const int8_t*>(v),
                  static_cast<const float*>(qs),
                  static_cast<const float*>(ks),
                  static_cast<const float*>(vs),
                  static_cast<const float*>(bias),
                  static_cast<float*>(out),
                  static_cast<float*>(lse),
                  B, Hq, Hkv, Sq, Sk, D,
                  qs_rows, ks_rows, vs_rows,
                  bsb, bsh, bsq, bsk,
                  left, right};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64) return launch<64>(p, st);
  return launch<128>(p, st);
}
