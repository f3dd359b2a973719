// Dense flash-attention forward (out + LSE) for Hopper, sm_90a.
//
// Replaces umfa_tpu/ops/flash_fwd.py:296 `_fwd_kernel` (host
// `flash_attention_forward`, flash_fwd.py:762), without its block-sparse
// walk and its in-kernel RoPE. The tensor-core body of fwd_tc.cuh
// (`fwd_tc_kernel`), with the product policy chosen by the input dtype:
//   * bf16 inputs: `Bf16Mma`, mma.sync m16n8k16 bf16 -> fp32, D <= 256;
//   * fp32 inputs (fp16 arrives promoted to fp32): `Tf32x3Mma`, both
//     products as three mma.sync m16n8k8 tf32 on operands split into tf32
//     big and small parts (never fp32 in one TF32 pass, which would miss
//     the fp32 gate of 2e-5), D <= 128. Wider fp32 heads (D 129-256) run
//     the one CUDA-core kernel left, `flash_fwd_kernel` (FP32 FMAs).
// Head dims are zero-padded in shared memory to the template width (64,
// 128, 256).
//
// What bounds it on this card: at the serving prefill (B8 Hq16 Hkv8, 4032
// causal queries against 4096 keys, D 64) the work is 4·D flops per visible
// (query, key) pair, 2.66e11 flop, against ~0.07 GB of Q/K/V/out read or
// written once (bf16): operation-bound, 0.269 ms at 989 TFLOP/s bf16
// against ~0.02 ms of HBM time; in fp32 the floor is three TF32 products
// for each fp32 one, 1.61 ms at 495 TFLOP/s.
//
// What the design does about it (fwd_tc.cuh): the FA2 shape on mma.sync,
// 4 warps x 16 query rows, Q in registers as A fragments at bf16 D <= 128
// (fp32: loaded and split at each use), K/V tiles double-buffered by cp.async
// (bf16 64 keys, fp32 32), P from the S accumulators. The running max
// starts from the row max of the first 512 visible keys, found in a K-only
// pre-pass (a quarter more Q·Kᵀ at the prefill shape): a row that sees at
// most 512 keys rounds P against its final max, as the plain version does,
// and a longer one rounds against a running max only past its first 512
// keys. Without it, P rounded against the max of each row's first 64 keys
// put the bf16 LSE of short causal rows up to 1.15e-3 from the plain
// version's at the serving prefill, over its 1e-3 gate.
// Left for later PRs: wgmma (the only way to the full tensor-core rate),
// TMA loads with mbarriers, warp specialisation (a producer warp), and a
// persistent grid that overlaps one tile's epilogue with the next loads.
//
// Semantics held to the reference:
//   * the softmax scale is folded into Q once and Q is rounded back to the
//     input type (the TPU kernel's q scratch): Q·scale in fp32 for fp32;
//   * P is rounded to the input type before P·V (bf16; fp32 P is not
//     rounded), against the running max (seeded by the pre-pass) of the
//     kernel's own key tiles; the row sum l adds the rounded P at D < 128
//     (the reference's ones-column row sum) and the fp32 P at D >= 128 (its
//     VPU row sum: it has no ones column there);
//   * index masking (causal, window, KV tail) sets the score to -1e30 and
//     zeroes P; a -1e30 *bias* is not an index mask (a row masked by bias
//     alone averages uniformly); a row with no visible key outputs exactly
//     0 with LSE -1e30;
//   * GQA: q head h reads kv head h / (Hq / Hkv);
//   * bias: FP32, any broadcast shape, given as four element strides
//     (0 = broadcast dimension).
#include "fwd_tc.cuh"

using namespace umfa;

namespace {

// ---- fp32 at D 129-256: FP32 FMAs on the CUDA cores --------------------
//
// The one head-dim range the 3xTF32 body does not take (its D 256
// accumulators and fp32 tiles do not fit beside each other). One block of
// 128 threads per (64-row query tile, q head, batch); K/V tiles of 64 keys
// staged in shared memory as fp32; each thread owns a 4x8 patch of the
// score tile and 4 rows x DP/8 columns of the accumulator; the
// online-softmax state (m, l) stays in registers.

template <int DP>
constexpr int fwd_smem_bytes() {
  return (BQ * (DP + 1) + BK * (DP + 1) + BK * DP + BQ * (BK + 1)) * (int)sizeof(float);
}

template <typename Tout, int DP>
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
  const float* q = static_cast<const float*>(p.q) + ((long long)b * p.Hq + h) * p.Sq * p.D;
  const float* k = static_cast<const float*>(p.k) + ((long long)b * p.Hkv + hk) * p.Sk * p.D;
  const float* v = static_cast<const float*>(p.v) + ((long long)b * p.Hkv + hk) * p.Sk * p.D;
  const float* bias = p.bias ? p.bias + b * p.bsb + h * p.bsh : nullptr;

  for (int e = tid; e < BQ * DP; e += NT) {
    const int r = e / DP, c = e - r * DP;
    sQ[r * QS + c] = q0 + r < p.Sq && c < p.D ? q[(long long)(q0 + r) * p.D + c] * p.scale : 0.f;
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
        kx = k[i];
        vx = v[i];
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
        const float pj = (vis >> (i * 8 + j)) & 1u ? expf(s[i][j] - m_new) : 0.f;
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

template <typename Tout, int DP>
cudaError_t launch_simt(const FwdParams& p, cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<Tout, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, p.B);
  flash_fwd_kernel<Tout, DP><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename Tout>
cudaError_t launch_d(const FwdParams& p, bool bf16, cudaStream_t stream) {
  if (bf16) {
    if (p.D <= 64) return launch_fwd_tc<Bf16Mma, Tout, 64>(p, stream);
    if (p.D <= 128) return launch_fwd_tc<Bf16Mma, Tout, 128>(p, stream);
    return launch_fwd_tc<Bf16Mma, Tout, 256>(p, stream);
  }
  if (p.D <= 64) return launch_fwd_tc<Tf32x3Mma, Tout, 64>(p, stream);
  if (p.D <= 128) return launch_fwd_tc<Tf32x3Mma, Tout, 128>(p, stream);
  return launch_simt<Tout, 256>(p, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. q/k/v contiguous (B, H, S, D),
// D <= 256; bfloat16 inputs run the tensor-core body in bf16, float32
// inputs in 3xTF32 (D <= 128) or on the CUDA cores (D 129-256). out (B, Hq,
// Sq, D) in out_dtype; lse (B, Hq, Sq) float32. Returns the cudaError_t of
// the launch.
extern "C" int umfa_flash_fwd(const void* q, const void* k, const void* v, const void* bias,
                              void* out, void* lse, int B, int Hq, int Hkv, int Sq, int Sk,
                              int D, long long bsb, long long bsh, long long bsq,
                              long long bsk, float scale, int left, int right, int in_dtype,
                              int out_dtype, void* stream) {
  if (D < 1 || D > 256 || Hkv < 1 || Hq % Hkv != 0 || in_dtype < 0 || in_dtype > 1 ||
      out_dtype < 0 || out_dtype > 1)
    return cudaErrorInvalidValue;
  const int per16 = in_dtype == 1 ? 8 : 4;  // elements a 16-byte copy
  const int vec = D % per16 == 0 && ((reinterpret_cast<uintptr_t>(k) |
                                      reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  FwdParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
  p.bsb = bsb;
  p.bsh = bsh;
  p.bsq = bsq;
  p.bsk = bsk;
  p.scale = scale;
  p.left = left;
  p.right = right;
  p.vec = vec;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf16 = in_dtype == 1;
  return out_dtype == 0 ? launch_d<float>(p, bf16, st) : launch_d<__nv_bfloat16>(p, bf16, st);
}

// Dynamic shared memory of the kernel that umfa_flash_fwd launches for
// head dim D and input dtype `in_dtype`, in bytes (0 if none takes D).
extern "C" int umfa_flash_fwd_smem_bytes(int D, int in_dtype) {
  if (D < 1 || D > 256) return 0;
  if (in_dtype == 1)
    return D <= 64    ? FwdTile<64, Bf16Mma, false>::SMEM
           : D <= 128 ? FwdTile<128, Bf16Mma, false>::SMEM
                      : FwdTile<256, Bf16Mma, false>::SMEM;
  return D <= 64    ? FwdTile<64, Tf32x3Mma, false>::SMEM
         : D <= 128 ? FwdTile<128, Tf32x3Mma, false>::SMEM
                    : fwd_smem_bytes<256>();
}
