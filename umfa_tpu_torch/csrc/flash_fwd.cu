// Dense flash-attention forward (out + LSE) for Hopper, sm_90a.
//
// Replaces umfa_tpu/ops/flash_fwd.py:296 `_fwd_kernel` (host
// `flash_attention_forward`, flash_fwd.py:762), without its block-sparse
// walk and its in-kernel RoPE. Two kernels, chosen by the input dtype:
//   * bf16 inputs: `flash_fwd_tc_kernel`, on the tensor cores;
//   * fp32 inputs (fp16 arrives promoted to fp32): `flash_fwd_kernel`, FP32
//     FMAs on the CUDA cores. TF32 would miss the fp32 gate of 2e-5, so
//     fp32 stays off the tensor cores; its ceiling is the 67 TFLOP/s FP32
//     rate.
// Head dims up to 256 (templates 64, 128, 256; a smaller D is zero-padded
// in shared memory to the template width).
//
// What bounds it on this card: at the serving prefill (B8 Hq16 Hkv8, 4032
// causal queries against 4096 keys, D 64) the work is 4·D flops per visible
// (query, key) pair, 2.66e11 flop, against ~0.07 GB of Q/K/V/out read or
// written once: operation-bound, 0.269 ms at 989 TFLOP/s bf16 against
// ~0.02 ms of HBM time.
//
// What the tensor-core design does about it (the FA2 shape on mma.sync):
//   * one block of 4 warps per (64-row query tile, q head, batch); each
//     warp owns 16 whole query rows, so the row max and row sum need only
//     quad shuffles; tiles are issued heaviest first (the last query tiles
//     of a causal mask see the most keys);
//   * Q·scale is rounded to bf16 once into shared memory and, for D <= 128,
//     held in registers as A fragments (ldmatrix) for the whole walk;
//   * K and V tiles of 64 keys are bf16 in shared memory, double-buffered:
//     16-byte cp.async brings tile t + 1 while tile t is computed; rows are
//     padded by 16 bytes so that ldmatrix is free of bank conflicts; rows
//     past Sk and columns past D are zero-filled by the copy itself;
//   * S = Q·Kᵀ by mma.sync m16n8k16 into fp32 fragments; the mask and the
//     bias are applied on the fragments, element by element only on tiles
//     that cross a mask edge or carry a bias; key tiles the mask hides from
//     the whole block are never loaded, and a warp skips a tile its rows
//     cannot see;
//   * the running max starts from the row max of the first PRE_TILES (8)
//     visible key tiles, found in a K-only pre-pass (a quarter more Q·Kᵀ
//     at the prefill shape): a row that sees at most 512 keys rounds P
//     against its final max, as the plain version does, and a longer one
//     rounds against a running max only past its first 512 keys. Without
//     it, P rounded against the max of each row's first 64 keys put the
//     LSE of short causal rows up to 1.15e-3 from the plain version's at
//     the serving prefill, over its 1e-3 gate;
//   * P leaves the S accumulators as bf16 A fragments (no trip through
//     shared memory); V's B fragments come through ldmatrix.trans;
//   * the epilogue writes out = acc / l and the LSE.
// Left for later PRs: wgmma (the only way to the full tensor-core rate),
// TMA loads with mbarriers, warp specialisation (a producer warp), and a
// persistent grid that overlaps one tile's epilogue with the next loads.
//
// Semantics held to the reference:
//   * the softmax scale is folded into Q once and Q is rounded back to the
//     input type (the TPU kernel's q scratch);
//   * P is rounded to the input type before P·V, against the running max
//     (seeded by the pre-pass) of the kernel's own 64-key tiles; the row
//     sum l adds the rounded P at D < 128 (the reference's ones-column row
//     sum) and the fp32 P at D >= 128 (its VPU row sum: it has no ones
//     column there);
//   * index masking (causal, window, KV tail) sets the score to -1e30 and
//     zeroes P; a -1e30 *bias* is not an index mask (a row masked by bias
//     alone averages uniformly); a row with no visible key outputs exactly
//     0 with LSE -1e30;
//   * GQA: q head h reads kv head h / (Hq / Hkv);
//   * bias: FP32, any broadcast shape, given as four element strides
//     (0 = broadcast dimension).
#include "common.cuh"
#include "mma.cuh"

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
  int vec;  // D % 8 == 0 and K/V 16-byte aligned: K/V tiles by cp.async
};

// ---- fp32: FP32 FMAs on the CUDA cores --------------------------------
//
// One block of 128 threads per (64-row query tile, q head, batch); K/V
// tiles of 64 keys staged in shared memory as fp32; each thread owns a 4x8
// patch of the score tile and 4 rows x DP/8 columns of the accumulator; the
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

// ---- bf16: mma.sync on the tensor cores --------------------------------

// Shared memory: Q (BQ rows) and two buffers of K and V (BK rows each),
// bf16, row stride DP + 8.
template <int DP>
constexpr int tc_smem_bytes() {
  return (BQ + 4 * BK) * (DP + 8) * (int)sizeof(__nv_bfloat16);
}

// Rows [k0, k0 + BK) of K (and of V, with_v) into one buffer; rows past Sk
// and columns past D are zero. With `vec`, by cp.async (the caller commits
// the group); else by plain loads and stores.
template <int DP>
__device__ __forceinline__ void load_kv_tile(__nv_bfloat16* sK, __nv_bfloat16* sV,
                                             const __nv_bfloat16* k, const __nv_bfloat16* v,
                                             int k0, int Sk, int D, bool vec, bool with_v) {
  constexpr int LD = DP + 8, CH = DP / 8;
  if (vec) {
    for (int e = threadIdx.x; e < BK * CH; e += blockDim.x) {
      const int r = e / CH, c = (e - r * CH) * 8;
      const bool ok = k0 + r < Sk && c < D;
      const long long i = ok ? (long long)(k0 + r) * D + c : 0;
      cp_async16(sK + r * LD + c, k + i, ok ? 16 : 0);
      if (with_v) cp_async16(sV + r * LD + c, v + i, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < BK * DP; e += blockDim.x) {
      const int r = e / DP, c = e - r * DP;
      const bool ok = k0 + r < Sk && c < D;
      const long long i = (long long)(k0 + r) * D + c;
      sK[r * LD + c] = ok ? k[i] : __float2bfloat16_rn(0.f);
      if (with_v) sV[r * LD + c] = ok ? v[i] : __float2bfloat16_rn(0.f);
    }
  }
}

// Key tiles whose row max seeds the running max before any P is formed.
constexpr int PRE_TILES = 8;

// At D 64, four blocks an SM (registers capped at 128).
template <typename Tout, int DP>
__global__ void __launch_bounds__(NT, DP <= 64 ? 4 : 1) flash_fwd_tc_kernel(const FwdParams p) {
  constexpr int LD = DP + 8;
  constexpr int KS = DP / 16;           // 16-deep steps of Q·Kᵀ
  constexpr int NA = DP / 8;            // 8-column accumulator tiles of out
  constexpr bool QREG = DP <= 128;      // Q's A fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sKV = sQ + BQ * LD;  // [buffer][K, V][BK][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(p.q) + ((long long)b * p.Hq + h) * p.Sq * p.D;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(p.k) + ((long long)b * p.Hkv + hk) * p.Sk * p.D;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(p.v) + ((long long)b * p.Hkv + hk) * p.Sk * p.D;
  const float* bias = p.bias ? p.bias + b * p.bsb + h * p.bsh : nullptr;
  const bool sum_rounded = p.D < 128;

  int k_lo, k_hi;
  visible_keys(q0, min(q0 + BQ, p.Sq) - 1, p.Sk, p.left, p.right, &k_lo, &k_hi);
  const int t_lo = k_lo / BK;
  const int n_t = k_hi >= k_lo ? k_hi / BK - t_lo + 1 : 0;
  // Steps [0, n_pre) walk the first key tiles for the row max alone (K
  // only); steps [n_pre, n_pre + n_t) walk every visible tile with the
  // softmax update and P·V. A row that sees at most PRE_TILES tiles thus
  // rounds P against its final max, as the plain version does.
  const int n_pre = min(n_t, PRE_TILES), steps = n_pre + n_t;
  auto tile_of = [&](int i) { return t_lo + (i < n_pre ? i : i - n_pre); };
  if (steps > 0) {
    load_kv_tile<DP>(sKV, sKV + BK * LD, k, v, tile_of(0) * BK, p.Sk, p.D, p.vec, false);
    cp_async_commit();
  }

  for (int e = tid; e < BQ * DP; e += NT) {
    const int r = e / DP, c = e - r * DP;
    float x = 0.f;
    if (q0 + r < p.Sq && c < p.D)
      x = __bfloat162float(q[(long long)(q0 + r) * p.D + c]) * p.scale;
    sQ[r * LD + c] = __float2bfloat16_rn(x);
  }
  __syncthreads();

  const int rw = warp * 16;                   // the warp's first row in the tile
  const int row0 = q0 + rw + g, row1 = row0 + 8;  // this thread's two rows
  uint32_t qf[QREG ? KS : 1][4];
  if (QREG) {
#pragma unroll
    for (int ks = 0; ks < (QREG ? KS : 1); ++ks) load_a(qf[ks], sQ, LD, rw, ks * 16, lane);
  }

  float m[2] = {MASK_VALUE, MASK_VALUE}, l[2] = {0.f, 0.f};
  float acc[NA][4];
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < steps; ++i) {
    const int k0 = tile_of(i) * BK;
    const int cur = i & 1;
    if (i + 1 < steps) {
      __nv_bfloat16* nxt = sKV + (cur ^ 1) * 2 * BK * LD;
      load_kv_tile<DP>(nxt, nxt + BK * LD, k, v, tile_of(i + 1) * BK, p.Sk, p.D, p.vec,
                       i + 1 >= n_pre);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* cK = sKV + cur * 2 * BK * LD;
    const __nv_bfloat16* cV = cK + BK * LD;

    // Rows rw..rw+15 of the tile against keys k0..k0+63: none visible, all
    // visible (and all rows real), or an edge.
    const int r_lo = q0 + rw, r_hi = r_lo + 15;
    const bool none = k0 >= p.Sk || (p.right >= 0 && k0 > r_hi + p.right) ||
                      (p.left >= 0 && k0 + BK - 1 < r_lo - p.left);
    const bool all = k0 + BK <= p.Sk && r_hi < p.Sq &&
                     (p.right < 0 || k0 + BK - 1 <= r_lo + p.right) &&
                     (p.left < 0 || k0 >= r_hi - p.left);
    if (!none) {
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[4];
        if (QREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[QREG ? ks : 0][e];
        } else {
          load_a(a, sQ, LD, rw, ks * 16, lane);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          uint32_t b0[2], b1[2];
          load_b_nk(b0, b1, cK, LD, jj * 16, ks * 16, lane);
          mma_bf16(s[2 * jj], a, b0);
          mma_bf16(s[2 * jj + 1], a, b1);
        }
      }

      // Element (j, e): row e < 2 ? row0 : row1, key k0 + 8j + 2tq + (e & 1).
      unsigned vis = 0xffffffffu;
      if (!all || bias) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = e < 2 ? row0 : row1, col = k0 + 8 * j + 2 * tq + (e & 1);
            if (all || key_visible(row, col, p.Sq, p.Sk, p.left, p.right)) {
              if (bias) s[j][e] += bias[row * p.bsq + col * p.bsk];
            } else {
              s[j][e] = MASK_VALUE;
              vis &= ~(1u << (4 * j + e));
            }
          }
      }

      float m_new[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        m_new[0] = fmaxf(m_new[0], fmaxf(s[j][0], s[j][1]));
        m_new[1] = fmaxf(m_new[1], fmaxf(s[j][2], s[j][3]));
      }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_new[r] = quad_max(m_new[r]);
        alpha[r] = __expf(m[r] - m_new[r]);
        m[r] = m_new[r];
      }
      if (i >= n_pre) {  // a pre-pass step stops at the row max
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pj = (vis >> (4 * j + e)) & 1u ? __expf(s[j][e] - m_new[e >> 1]) : 0.f;
            const float pr = round_bf16(pj);
            rs[e >> 1] += sum_rounded ? pr : pj;
            s[j][e] = pr;
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];
#pragma unroll
        for (int n = 0; n < NA; ++n) {
          acc[n][0] *= alpha[0];
          acc[n][1] *= alpha[0];
          acc[n][2] *= alpha[1];
          acc[n][3] *= alpha[1];
        }

#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          uint32_t a[4];
          pack_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
          for (int dn = 0; dn < DP / 16; ++dn) {
            uint32_t b0[2], b1[2];
            load_b_kn(b0, b1, cV, LD, kk * 16, dn * 16, lane);
            mma_bf16(acc[2 * dn], a, b0);
            mma_bf16(acc[2 * dn + 1], a, b1);
          }
        }
      }
    }
    __syncthreads();  // this buffer is refilled two steps on
  }

  Tout* out = static_cast<Tout*>(p.out) + ((long long)b * p.Hq + h) * p.Sq * p.D;
  float* lse = p.lse + ((long long)b * p.Hq + h) * p.Sq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i ? row1 : row0;
    const float lsum = quad_sum(l[i]);
    if (row >= p.Sq) continue;
    const bool empty = lsum == 0.f;
    const float l_safe = empty ? 1.f : lsum;
#pragma unroll
    for (int n = 0; n < NA; ++n) {
      const int col = 8 * n + 2 * tq;
      if (col < p.D) Elem<Tout>::store(out, (long long)row * p.D + col, acc[n][2 * i] / l_safe);
      if (col + 1 < p.D)
        Elem<Tout>::store(out, (long long)row * p.D + col + 1, acc[n][2 * i + 1] / l_safe);
    }
    if (tq == 0) lse[row] = empty ? MASK_VALUE : m[i] + logf(l_safe);
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

template <typename Tout, int DP>
cudaError_t launch_tc(const FwdParams& p, cudaStream_t stream) {
  constexpr int smem = tc_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc_kernel<Tout, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, p.B);
  flash_fwd_tc_kernel<Tout, DP><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename Tout>
cudaError_t launch_d(const FwdParams& p, bool tc, cudaStream_t stream) {
  if (tc) {
    if (p.D <= 64) return launch_tc<Tout, 64>(p, stream);
    if (p.D <= 128) return launch_tc<Tout, 128>(p, stream);
    return launch_tc<Tout, 256>(p, stream);
  }
  if (p.D <= 64) return launch_simt<Tout, 64>(p, stream);
  if (p.D <= 128) return launch_simt<Tout, 128>(p, stream);
  return launch_simt<Tout, 256>(p, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. q/k/v contiguous (B, H, S, D),
// D <= 256; float32 inputs run the CUDA-core kernel, bfloat16 inputs the
// tensor-core kernel. out (B, Hq, Sq, D) in out_dtype; lse (B, Hq, Sq)
// float32. Returns the cudaError_t of the launch.
extern "C" int umfa_flash_fwd(const void* q, const void* k, const void* v, const void* bias,
                              void* out, void* lse, int B, int Hq, int Hkv, int Sq, int Sk,
                              int D, long long bsb, long long bsh, long long bsq,
                              long long bsk, float scale, int left, int right, int in_dtype,
                              int out_dtype, void* stream) {
  if (D < 1 || D > 256 || Hkv < 1 || Hq % Hkv != 0 || in_dtype < 0 || in_dtype > 1 ||
      out_dtype < 0 || out_dtype > 1)
    return cudaErrorInvalidValue;
  const int vec = D % 8 == 0 && ((reinterpret_cast<uintptr_t>(k) |
                                  reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const FwdParams p{q,   k,   v,   static_cast<const float*>(bias), out, static_cast<float*>(lse),
                    B,   Hq,  Hkv, Sq,  Sk,  D, bsb, bsh, bsq, bsk, scale, left, right, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool tc = in_dtype == 1;
  return out_dtype == 0 ? launch_d<float>(p, tc, st) : launch_d<__nv_bfloat16>(p, tc, st);
}

// Dynamic shared memory of the kernel that umfa_flash_fwd launches for
// head dim D and input dtype `in_dtype`, in bytes (0 if none takes D).
extern "C" int umfa_flash_fwd_smem_bytes(int D, int in_dtype) {
  if (D < 1 || D > 256) return 0;
  const int dp = D <= 64 ? 64 : D <= 128 ? 128 : 256;
  if (in_dtype == 1)
    return dp == 64 ? tc_smem_bytes<64>() : dp == 128 ? tc_smem_bytes<128>() : tc_smem_bytes<256>();
  return dp == 64 ? fwd_smem_bytes<64>() : dp == 128 ? fwd_smem_bytes<128>() : fwd_smem_bytes<256>();
}
