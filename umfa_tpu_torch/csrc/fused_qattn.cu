// Single-launch runtime-quantized attention forward for Hopper, sm_90a.
//
// Replaces umfa_tpu/ops/quant_fused_attn.py:206 `_fused_qattn_kernel` (host
// `fused_quantize_attend`, quant_fused_attn.py:831): read fp32/bf16 Q, K,
// V, quantize them per row (INT8 or INT4, mean smoothing, optional Hadamard
// rotation of Q and K, or a dense Q), attend on the dequantized bf16
// values, restore the V mean, and write the quantized residuals the STE
// backward consumes. Symmetric ROW only; BLOCK, ASYMMETRIC, pv_int8 and
// block-sparse walks are not ported yet.
//
// What bounds it on this card: at the training shape (B8 Hq16 Hkv8, causal
// S 4096, D 64) it is compute-bound like the dense forward: 4·D flops per
// visible (query, key) pair (QKᵀ and P·V on bf16 values) against reading
// Q, K, V once and writing out and the int8 residuals: ~0.28 ms of bf16
// tensor-core time against ~0.08 ms of HBM time.
//
// What this simple design does about it: exact first, fast later. One call
// runs three kernels on the stream:
//   1. means: the smoothing means, one block per (b, h), so every block of a
//      (b, h) reads the same bits;
//   2. K/V quantize: one warp per K or V row writes its int8 codes (INT4
//      packed) and scale, once. On the TPU the kernel quantizes each K/V
//      tile on first touch into a VMEM cache that later q-blocks reuse;
//      blocks on this card share nothing, so the rows are quantized once
//      into HBM instead, as int8 (fewer bytes than the bf16 K/V the
//      attention would read otherwise). These are the K/V residuals, each
//      row written by exactly one warp; without residuals they go to
//      scratch;
//   3. attention: quant_attn_fwd.cu's layout, one block of 128 threads per
//      (64-row query tile, q head, batch), 64-key tiles, a 4 x 8 score patch
//      per thread, FMAs on the CUDA cores, invisible key tiles skipped, two
//      passes over the visible keys (the first finds the exact row max, the
//      second rounds P to bf16 against it, as the plain version does). The
//      block quantizes its own Q tile (one warp per row, absmax by
//      shuffles; its codes are the Q residual) and dequantizes K and V on
//      load from the codes of kernel 2.
//
// Means, as the TPU kernel estimates them (from its zero-padded first
// tile): the sum of the first min(T, S) rows over T, T from the host
// (`default_mean_rows`), the rows summed in double by 256/D row slices in a
// fixed order; km and vm per KV head, qm per query head, km and qm of the
// rotated rows.
//
// Rounding points held to the reference (quant_fused_attn.py:100-828):
//   * x·H summed in double and rounded once to fp32 (V is never rotated);
//   * a row: x − mean, absmax = max(|x|, 1e-12), scale = absmax / qmax,
//     code = rint(x · (qmax / absmax)) (a reciprocal multiply, no clip);
//   * bf16(code·sk), bf16(code·sv), bf16((code·sq)·scale); a dense Q is
//     bf16(q_rot·scale) and has no mean;
//   * with smooth_q: cc_j = (bf16(qm)·k̃_j)·scale, added to S before the
//     bias; index masking (causal, window, KV tail) sets −1e30;
//   * P = exp(S − m), P·V on bf16(P); l sums bf16(P) at D < 128 and the
//     fp32 P at D ≥ 128; out = acc / l + vm, rows with l == 0 exactly 0 and
//     LSE −1e30.
// Exactness against the plain version: Q·K, the cc row and the means are
// summed in double (products of bf16 values are exact, and so are these
// sums for the magnitudes attention sees) and rounded once to fp32, as the
// plain version's float64 sums are, so both quantize and exponentiate the
// same fp32 values and round P to bf16 at the same points; only the fp32
// sums of l and P·V run in another order (row 5's INT8 gates hold). The
// double FMAs of QKᵀ run at half the fp32 rate; the dequantized Q and K
// tiles are kept as double in shared memory, so the inner loop converts
// nothing. Shared memory (103 KB a block at D 64, two blocks per SM; 188 KB
// at D 128) is set above 48 KB through cudaFuncSetAttribute.
#include <math.h>

#include "common.cuh"

using namespace umfa;

namespace {

enum : int {
  F_HADAMARD = 1,
  F_SMOOTH = 2,
  F_SMOOTH_Q = 4,
  F_Q_DENSE = 8,
  F_Q_INT4 = 32,
  F_K_INT4 = 64,
  F_V_INT4 = 128,
};

struct FQParams {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  void* out;
  float* lse;
  int8_t* qv;  // Q residual (null unless asked for, and for a dense Q)
  float* qs;
  int8_t* kv;  // K/V codes and scales (always: the residuals, or scratch)
  float* ks;
  int8_t* vv;
  float* vs;
  float* qm;  // (B, Hq, D), with F_SMOOTH_Q
  float* km;  // (B, Hkv, D), with F_SMOOTH
  float* vm;
  int B, Hq, Hkv, Sq, Sk, D;
  long long bsb, bsh, bsq, bsk;
  float scale;
  int left, right;
  int flags, qmax_q, qmax_k, qmax_v, Tq, Tkv;
  float hval;
};

constexpr int NTM = 256;  // means kernel threads
constexpr int KV_WARPS = 8;  // rows per block of the K/V quantize kernel
constexpr int MAXD = 128;

// Element c of the rotated row x·H (H entries ±hval): the products summed
// in double and rounded once, as the plain version's float64 product is,
// so both quantize the same fp32 values.
template <typename Load>
__device__ __forceinline__ float rotate_elem(Load x, int c, int D, float hval) {
  double y = 0.0;
  for (int j = 0; j < D; ++j)
    y = fma((double)x(j), (__popc(j & c) & 1) ? -(double)hval : (double)hval, y);
  return (float)y;
}

// The mean of the first min(T, S) rows over T (rotated when `rot`), written
// to out[0..D). Rows are summed in double by NTM / D slices in a fixed order.
template <typename Tin>
__device__ void tile_mean(const Tin* x, int S, int T, int D, bool rot, float hval, float* out,
                          double* part) {
  const int ns = NTM / D;
  const int c = threadIdx.x % D, sl = threadIdx.x / D;
  const int n = min(T, S);
  double acc = 0.0;
  if (sl < ns) {
    for (int r = sl; r < n; r += ns) {
      const Tin* xr = x + (long long)r * D;
      const float y = rot ? rotate_elem([&](int j) { return Elem<Tin>::load(xr, j); }, c, D, hval)
                          : Elem<Tin>::load(xr, c);
      acc += (double)y;
    }
    part[sl * D + c] = acc;
  }
  __syncthreads();
  if (threadIdx.x < D) {
    double s = part[c];
    for (int i = 1; i < ns; ++i) s += part[i * D + c];
    out[c] = __fdiv_rn((float)s, (float)T);
  }
  __syncthreads();
}

template <typename Tin>
__global__ void __launch_bounds__(NTM) fused_means_kernel(const FQParams p) {
  __shared__ double part[NTM];
  const bool rot = p.flags & F_HADAMARD;
  const int nq = p.B * p.Hq;
  const int bh = blockIdx.x;
  if (bh < nq) {
    if (p.flags & F_SMOOTH_Q)
      tile_mean(static_cast<const Tin*>(p.q) + (long long)bh * p.Sq * p.D, p.Sq, p.Tq, p.D, rot,
                p.hval, p.qm + (long long)bh * p.D, part);
    return;
  }
  if (!(p.flags & F_SMOOTH)) return;
  const long long kb = bh - nq;
  const long long off = kb * p.Sk * p.D;
  tile_mean(static_cast<const Tin*>(p.k) + off, p.Sk, p.Tkv, p.D, rot, p.hval, p.km + kb * p.D,
            part);
  tile_mean(static_cast<const Tin*>(p.v) + off, p.Sk, p.Tkv, p.D, false, p.hval, p.vm + kb * p.D,
            part);
}

// One warp per row of K (rows [0, n)) or V (rows [n, 2n)): rotate K, subtract
// the mean, quantize (reciprocal multiply, no clip), write the codes (INT4
// packed split-halves) and the scale.
template <typename Tin>
__global__ void __launch_bounds__(KV_WARPS * 32) fused_kv_quant_kernel(const FQParams p) {
  __shared__ float s_raw[KV_WARPS][MAXD];
  __shared__ int s_code[KV_WARPS][MAXD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long n = (long long)p.B * p.Hkv * p.Sk;
  const long long row = (long long)blockIdx.x * KV_WARPS + warp;
  if (row >= 2 * n) return;
  const bool is_v = row >= n;
  const long long r = is_v ? row - n : row;
  const int D = p.D;
  const Tin* x = static_cast<const Tin*>(is_v ? p.v : p.k) + r * D;
  const float* mean = (p.flags & F_SMOOTH) ? (is_v ? p.vm : p.km) + (r / p.Sk) * D : nullptr;
  const bool rot = !is_v && (p.flags & F_HADAMARD);
  const bool int4 = p.flags & (is_v ? F_V_INT4 : F_K_INT4);
  const float fq = (float)(is_v ? p.qmax_v : p.qmax_k);
  float* raw = s_raw[warp];
  int* code = s_code[warp];
  if (rot) {
    for (int c = lane; c < D; c += 32) raw[c] = Elem<Tin>::load(x, c);
    __syncwarp();
  }
  float y[MAXD / 32];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < MAXD / 32; ++i) {
    const int c = lane + 32 * i;
    float t = 0.f;
    if (c < D) {
      t = rot ? rotate_elem([&](int j) { return raw[j]; }, c, D, p.hval) : Elem<Tin>::load(x, c);
      if (mean) t = __fsub_rn(t, mean[c]);
      amax = fmaxf(amax, fabsf(t));
    }
    y[i] = t;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  amax = fmaxf(amax, 1e-12f);
  const float sc = __fdiv_rn(amax, fq), rcp = __fdiv_rn(fq, amax);
  int8_t* vals = is_v ? p.vv : p.kv;
#pragma unroll
  for (int i = 0; i < MAXD / 32; ++i) {
    const int c = lane + 32 * i;
    if (c >= D) continue;
    const int qc = (int)rintf(__fmul_rn(y[i], rcp));
    if (int4)
      code[c] = qc;
    else
      vals[r * D + c] = (int8_t)qc;
  }
  if (int4) {
    __syncwarp();
    const int h = D / 2;
    for (int c = lane; c < h; c += 32)
      vals[r * h + c] = (int8_t)(unsigned char)((code[c] & 0xF) | ((code[c + h] & 0xF) << 4));
  }
  if (lane == 0) (is_v ? p.vs : p.ks)[r] = sc;
}

template <int DP>
constexpr int fq_smem_bytes() {
  return 2 * 64 * (DP + 1) * (int)sizeof(double) +
         (64 * (DP + 1) + BQ * (BK + 1) + 3 * DP + BK + 64) * (int)sizeof(float) + 64 * DP;
}

template <typename Tin, typename Tout, int DP>
__global__ void __launch_bounds__(NT) fused_qattn_kernel(const FQParams p) {
  constexpr int S = DP + 1;  // row stride of the staged tiles
  constexpr int PS = BK + 1;
  constexpr int NC = DP / 8;
  constexpr int NE = DP / 32;
  extern __shared__ double smem[];
  double* sQd = smem;          // dequantized Q, softmax scale folded in
  double* sKd = sQd + 64 * S;  // dequantized K tile
  float* sV = reinterpret_cast<float*>(sKd + 64 * S);  // staged Q rows; the dequantized V tile
  float* sP = sV + 64 * S;    // bf16(P)
  float* sQm = sP + BQ * PS;  // qm (fp32), subtracted from Q
  float* sQmb = sQm + DP;     // bf16(qm), for the cc row
  float* sVm = sQmb + DP;
  float* sCC = sVm + DP;      // the cc row of the current K tile
  float* sRs = sCC + BK;      // per-row scales of the Q tile
  int8_t* sCode = reinterpret_cast<int8_t*>(sRs + 64);  // its codes, 64 x DP

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int group = p.Hq / p.Hkv, hk = h / group;
  const int D = p.D;
  const bool smooth = p.flags & F_SMOOTH, smooth_q = p.flags & F_SMOOTH_Q;
  const bool q_dense = p.flags & F_Q_DENSE;
  const bool k4 = p.flags & F_K_INT4, v4 = p.flags & F_V_INT4;
  const long long qrow = ((long long)b * p.Hq + h) * p.Sq;
  const long long krow = ((long long)b * p.Hkv + hk) * p.Sk;
  const int kw = k4 ? D / 2 : D, vw = v4 ? D / 2 : D;
  const int8_t* kcodes = p.kv + krow * kw;
  const int8_t* vcodes = p.vv + krow * vw;
  const float* kscales = p.ks + krow;
  const float* vscales = p.vs + krow;
  const float* bias = p.bias ? p.bias + b * p.bsb + h * p.bsh : nullptr;

  for (int c = tid; c < DP; c += NT) {
    const bool in = c < D;
    sQm[c] = in && smooth_q ? p.qm[((long long)b * p.Hq + h) * D + c] : 0.f;
    sQmb[c] = round_bf16(sQm[c]);
    sVm[c] = in && smooth ? p.vm[((long long)b * p.Hkv + hk) * D + c] : 0.f;
  }

  // The Q tile: staged (rotated: each output reads its raw row from global
  // memory), then quantized, its dequantized values with the softmax scale
  // folded in, or, dense, rounded as bf16(q_rot · scale).
  {
    const Tin* q = static_cast<const Tin*>(p.q) + qrow * D;
    const int nvalid = min(BQ, p.Sq - q0);
    if (p.flags & F_HADAMARD) {
      for (int e = tid; e < 64 * DP; e += NT) {
        const int r = e / DP, c = e - r * DP;
        float y = 0.f;
        if (r < nvalid && c < D) {
          const Tin* xr = q + (long long)(q0 + r) * D;
          y = rotate_elem([&](int j) { return Elem<Tin>::load(xr, j); }, c, D, p.hval);
        }
        sV[r * S + c] = y;
      }
    } else {
      stage_rows<Tin, DP>(sV, q, q0, p.Sq, D);
    }
    __syncthreads();
    if (q_dense) {
      for (int e = tid; e < 64 * DP; e += NT) {
        const int r = e / DP, c = e - r * DP;
        sQd[r * S + c] = r < nvalid && c < D ? round_bf16(__fmul_rn(sV[r * S + c], p.scale)) : 0.f;
      }
    } else {
      const float fq = (float)p.qmax_q;
      for (int r = warp; r < 64; r += NT / 32) {  // one warp per row
        const float* tr = sV + r * S;
        double* dr = sQd + r * S;
        if (r >= nvalid) {
          for (int c = lane; c < DP; c += 32) dr[c] = 0.0;
          continue;
        }
        float y[NE];
        float amax = 0.f;
#pragma unroll
        for (int i = 0; i < NE; ++i) {
          const int c = lane + 32 * i;
          float x = 0.f;
          if (c < D) {
            x = tr[c];
            if (smooth_q) x = __fsub_rn(x, sQm[c]);
            amax = fmaxf(amax, fabsf(x));
          }
          y[i] = x;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
        amax = fmaxf(amax, 1e-12f);
        const float sc = __fdiv_rn(amax, fq), rcp = __fdiv_rn(fq, amax);
#pragma unroll
        for (int i = 0; i < NE; ++i) {
          const int c = lane + 32 * i;
          float deq = 0.f;
          if (c < D) {
            const float qf = rintf(__fmul_rn(y[i], rcp));
            sCode[r * DP + c] = (int8_t)(int)qf;
            deq = round_bf16(__fmul_rn(__fmul_rn(qf, sc), p.scale));
          }
          dr[c] = deq;
        }
        if (lane == 0) sRs[r] = sc;
      }
      if (p.qv) {  // the Q residual: codes (INT4 packed) and scales
        __syncthreads();
        const bool q4 = p.flags & F_Q_INT4;
        const int w = q4 ? D / 2 : D;
        for (int e = tid; e < nvalid * w; e += NT) {
          const int r = e / w, c = e - r * w;
          int code = sCode[r * DP + c];
          if (q4) code = (code & 0xF) | ((sCode[r * DP + c + w] & 0xF) << 4);
          p.qv[(qrow + q0 + r) * w + c] = (int8_t)(unsigned char)code;
        }
        for (int r = tid; r < nvalid; r += NT) p.qs[qrow + q0 + r] = sRs[r];
      }
    }
  }

  // The K tile at k0 dequantized on load into sKd, and its cc row.
  auto load_k = [&](int k0) {
    stage_deq<DP>(sKd, kcodes, kscales, 1, k0, p.Sk, D, k4);
    if (smooth_q) {
      __syncthreads();
      if (tid < BK) {
        double acc = 0.0;  // exact: products of bf16 values
        for (int d = 0; d < D; ++d) acc = fma((double)sQmb[d], sKd[tid * S + d], acc);
        sCC[tid] = __fmul_rn((float)acc, p.scale);
      }
    }
  };

  int k_lo, k_hi;
  visible_keys(q0, min(q0 + BQ, p.Sq) - 1, p.Sk, p.left, p.right, &k_lo, &k_hi);
  const int t_lo = k_lo / BK;
  const int t_hi = k_hi >= k_lo ? k_hi / BK : t_lo - 1;

  // This thread's 4 x 8 scores of the key tile at k0; returns the bits of
  // the index-visible ones (the others are MASK_VALUE). The dot of bf16
  // values is exact in double and rounded once (as the plain version's
  // float64 product); explicitly rounded adds: both passes, and the plain
  // version, compute the same bits.
  auto scores = [&](int k0, float (&s)[4][8]) -> unsigned {
    double sd[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sd[i][j] = 0.0;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      double a[4], kb[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQd[(ty * 4 + i) * S + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kb[j] = sKd[(tx + 8 * j) * S + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sd[i][j] = fma(a[i], kb[j], sd[i][j]);
    }
    unsigned vis = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + tx + 8 * j;
        if (key_visible(row, col, p.Sq, p.Sk, p.left, p.right)) {
          float x = (float)sd[i][j];
          if (smooth_q) x = __fadd_rn(x, sCC[tx + 8 * j]);
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

  // Pass 1: the exact row max over every visible key.
  float m[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = MASK_VALUE;
  for (int t = t_lo; t <= t_hi; ++t) {
    __syncthreads();  // sQd written; the previous tile's sKd/sCC consumed
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

  // Pass 2: P against the final max, l, and P·V on bf16(P).
  const bool sum_rounded = D < 128;
  float l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's sKd/sV/sP/sCC consumed
    stage_deq<DP>(sV, vcodes, vscales, 1, k0, p.Sk, D, v4);
    load_k(k0);
    __syncthreads();
    float s[4][8];
    const unsigned vis = scores(k0, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pj = (vis >> (i * 8 + j)) & 1u ? expf(s[i][j] - m[i]) : 0.f;
        const float pb = round_bf16(pj);
        rs += sum_rounded ? pb : pj;
        sP[(ty * 4 + i) * PS + tx + 8 * j] = pb;
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
        const float vv = sV[kk * S + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pp[i], vv, acc[i][c]);
      }
    }
  }

  Tout* out = static_cast<Tout*>(p.out) + qrow * D;
  float* lse = p.lse + qrow;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.Sq) continue;
    const bool empty = l[i] == 0.f;
    const float l_safe = empty ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 8 * c;
      if (col >= D) continue;
      float o = acc[i][c] / l_safe;
      // The V-mean restore; rows with no visible key keep their exact 0.
      if (smooth) o = empty ? 0.f : __fadd_rn(o, sVm[col]);
      Elem<Tout>::store(out, (long long)row * D + col, o);
    }
    if (tx == 0) lse[row] = empty ? MASK_VALUE : m[i] + logf(l_safe);
  }
}

template <typename Tin, typename Tout, int DP>
cudaError_t launch(const FQParams& p, cudaStream_t stream) {
  cudaError_t err;
  if (p.flags & (F_SMOOTH | F_SMOOTH_Q)) {
    fused_means_kernel<Tin><<<p.B * (p.Hq + p.Hkv), NTM, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const long long kv_rows = 2LL * p.B * p.Hkv * p.Sk;
  if (kv_rows) {
    fused_kv_quant_kernel<Tin>
        <<<(unsigned)((kv_rows + KV_WARPS - 1) / KV_WARPS), KV_WARPS * 32, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  constexpr int smem = fq_smem_bytes<DP>();
  err = cudaFuncSetAttribute(fused_qattn_kernel<Tin, Tout, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, p.B);
  fused_qattn_kernel<Tin, Tout, DP><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename Tin, typename Tout>
cudaError_t launch_d(const FQParams& p, cudaStream_t stream) {
  if (p.D <= 64) return launch<Tin, Tout, 64>(p, stream);
  return launch<Tin, Tout, 128>(p, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. q (B, Hq, Sq, D), k/v
// (B, Hkv, Sk, D) contiguous in in_dtype; bias float32 with element strides
// (or null); out (B, Hq, Sq, D) in out_dtype, lse (B, Hq, Sq) float32.
// K/V codes kv/vv (B, Hkv, Sk, D), or (B, Hkv, Sk, D/2) packed INT4, and
// float32 scales ks/vs (B, Hkv, Sk): always written (the residuals, or
// scratch). The Q residual qv/qs likewise for an integer Q, or null. Means
// (float32): qm (B, Hq, D) with SMOOTH_Q, km and vm (B, Hkv, D) with SMOOTH,
// written by this call. Returns the cudaError_t of the launches.
extern "C" int umfa_fused_qattn(const void* q, const void* k, const void* v, const void* bias,
                                void* out, void* lse, void* qv, void* qs, void* kv, void* ks,
                                void* vv, void* vs, void* qm, void* km, void* vm, int B, int Hq,
                                int Hkv, int Sq, int Sk, int D, long long bsb, long long bsh,
                                long long bsq, long long bsk, float scale, int left, int right,
                                int flags, int qmax_q, int qmax_k, int qmax_v, int Tq, int Tkv,
                                int in_dtype, int out_dtype, void* stream) {
  const bool int4 = flags & (F_Q_INT4 | F_K_INT4 | F_V_INT4);
  if (D < 1 || D > MAXD || Hkv < 1 || Hq % Hkv != 0 || in_dtype < 0 || in_dtype > 1 ||
      out_dtype < 0 || out_dtype > 1 || (int4 && D % 2) ||
      ((flags & F_HADAMARD) && (D & (D - 1))) || Tq < 1 || Tkv < 1 ||
      ((flags & F_SMOOTH) && (!km || !vm)) || ((flags & F_SMOOTH_Q) && !qm) || !kv || !ks ||
      !vv || !vs || (!qv != !qs))
    return cudaErrorInvalidValue;
  const FQParams p{q, k, v, static_cast<const float*>(bias), out, static_cast<float*>(lse),
                   static_cast<int8_t*>(qv), static_cast<float*>(qs), static_cast<int8_t*>(kv),
                   static_cast<float*>(ks), static_cast<int8_t*>(vv), static_cast<float*>(vs),
                   static_cast<float*>(qm), static_cast<float*>(km), static_cast<float*>(vm),
                   B, Hq, Hkv, Sq, Sk, D, bsb, bsh, bsq, bsk, scale, left, right,
                   flags, qmax_q, qmax_k, qmax_v, Tq, Tkv,
                   // The rotation's entries: fp32(D^-1/2), as the host's hadamard_matrix.
                   (float)pow((double)D, -0.5)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0)
    return out_dtype == 0 ? launch_d<float, float>(p, st) : launch_d<float, __nv_bfloat16>(p, st);
  return out_dtype == 0 ? launch_d<__nv_bfloat16, float>(p, st)
                        : launch_d<__nv_bfloat16, __nv_bfloat16>(p, st);
}
