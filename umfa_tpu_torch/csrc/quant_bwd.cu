// STE backward on quantized residuals (dQ, then dK/dV) for Hopper, sm_90a.
//
// Replaces umfa_tpu/ops/quant_bwd.py:101 `_q_dq_kernel` (`quant_bwd_dq`)
// and quant_bwd.py:339 `_q_dkv_kernel` (`quant_bwd_dkv`), host
// `quantized_attention_backward` (quant_bwd.py:589), without their
// block-sparse walks. The host wrapper (ops/quant_bwd.py) computes
// δ = rowsum(dO∘O) − dlse in fp32, gives rows with no visible key LSE
// +1e30 (their gradients are exactly 0), folds the softmax scale into Q's
// scales and multiplies the Q-mean score row by it, as the reference does
// outside its kernels.
//
// What bounds it on this card: at the training shape (B8 Hq16 Hkv8, causal
// S 4096, D 64) the dQ pass does 3 products (S, dP, dQ) and the dK/dV pass 4
// (S, dP, dV, dK) over the visible pairs, 2·D flops each: 4.12e11 and
// 5.5e11 flop, against reading the int8 residuals, dO, LSE and δ once:
// operation-bound, 0.417 ms and 0.556 ms at 989 TFLOP/s bf16 against
// ~0.05 ms of HBM time.
//
// What the design does about it. One owner per output tile, no atomics,
// deterministic:
//   * dQ (`quant_bwd_dq_kernel`, CUDA cores): one block of 256 threads per
//     (64-row query tile, q head, batch) walks the visible key tiles; Q and
//     dO staged once, K and V per tile, as fp32 in shared memory; FP32 FMAs
//     on bf16 values (exact), so its ceiling is the 67 TFLOP/s FP32 rate;
//   * dK/dV (`dkv_tc_kernel`, tensor cores, mma.sync m16n8k16 bf16 -> fp32):
//     one block of 4 warps per (64-key tile, kv head, batch), three blocks
//     an SM at D 64; K̃ and Ṽ are dequantized once to bf16 in shared
//     memory; it walks the query heads of its GQA group and their visible
//     32-row query tiles, copying each tile's raw int8/int4 Q codes, dO,
//     LSE and δ by cp.async two steps ahead and dequantizing them to bf16
//     tiles one step ahead (double-buffered both, one barrier a step);
//     Sᵀ, dPᵀ, dV and dK are mma.sync products whose A operands for dV and
//     dK come straight from the Pᵀ and dSᵀ accumulators; the GQA group sum
//     and each head's Q-mean term stay in registers. Its sums run in
//     another order than the plain version's, so the two agree to the
//     backward gates, not bit for bit.
// Left for later PRs: dQ on the tensor cores (and with it D 256), wgmma,
// TMA loads, warp specialisation and a persistent grid.
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
#include "mma.cuh"

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

// ---- dK/dV on the tensor cores -----------------------------------------
//
// One block of 4 warps per (64-key tile, kv head, batch); warp w owns keys
// 16w..16w+15 of the tile and their rows of dK and dV, in fp32 mma
// accumulators for the whole walk over the GQA group's query heads and
// their visible query tiles (QT rows each). Per query tile, with keys as
// the rows of every product:
//   Sᵀ = K̃·Q̃ᵀ and dPᵀ = Ṽ·bf16(dO)ᵀ   (A: K̃, Ṽ; B: Q̃, dO via ldmatrix)
//   Pᵀ, dSᵀ on the fragments; colsum(dS) in fp32 registers
//   dV += bf16(Pᵀ)·bf16(dO), dK += bf16(dSᵀ)·Q̃   (A straight from the Pᵀ
//   and dSᵀ accumulators, B via ldmatrix.trans)
// The load stage is the template parameter `Load`: it brings a query
// tile's raw operands into a staging buffer (cp.async, double-buffered, so
// tile i + 1 arrives while tile i is computed) and turns them into the bf16
// tiles Q̃ and bf16(dO) plus the per-row LSE, δ and vm term. `QuantLoad`
// dequantizes int8/int4 codes; a plain bf16 load stage gives the dense
// backward the same body.

// Tiles and occupancy as measured best at the training shape (B8 Hq16
// Hkv8 S4096 D64; 32-query tiles with K̃/Ṽ fragments from shared memory
// and three blocks an SM beat 64-query tiles, fragments held in
// registers, and two or four blocks an SM).
template <int DP>
struct DkvTile {
  static constexpr int QT = 32;                  // query rows per tile
  static constexpr int LD = DP + 8;              // bf16 row stride in shared memory
  static constexpr int MINB = DP <= 64 ? 3 : 2;  // blocks an SM holds
  // Staging buffer: Q codes, dO (up to fp32), LSE, δ, Q's row scales.
  static constexpr int RAW_Q = 0;
  static constexpr int RAW_O = QT * DP;
  static constexpr int RAW_L = RAW_O + QT * DP * 4;
  static constexpr int RAW_D = RAW_L + QT * 4;
  static constexpr int RAW_S = RAW_D + QT * 4;
  static constexpr int RAW_BYTES = RAW_S + QT * 4;
  // A converted query tile: Q̃, bf16(dO) (bf16, QT x LD) and the vm term,
  // LSE and δ per row (fp32).
  static constexpr int TILE_BYTES = 2 * QT * LD * 2 + 3 * QT * 4;
  // Shared memory: K̃, Ṽ (64 x LD bf16), vm (DP fp32), two converted tiles,
  // two staging buffers.
  static constexpr int SMEM = 2 * 64 * LD * 2 + DP * 4 + 2 * TILE_BYTES + 2 * RAW_BYTES;
};

// A converted query tile in shared memory.
template <int DP>
struct QTile {
  __nv_bfloat16* q;  // Q̃
  __nv_bfloat16* o;  // bf16(dO)
  float* vt;         // Σ_d dO·vm per row (0 without vm)
  float* lse;
  float* delta;
  __device__ __forceinline__ explicit QTile(unsigned char* base) {
    using G = DkvTile<DP>;
    q = reinterpret_cast<__nv_bfloat16*>(base);
    o = q + G::QT * G::LD;
    vt = reinterpret_cast<float*>(o + G::QT * G::LD);
    lse = vt + G::QT;
    delta = lse + G::QT;
  }
};

// n bytes from global src to shared dst: by 16-byte cp.async (the last
// piece zero-filled past n; both addresses 16-aligned) when vec, else by
// plain byte copies.
__device__ __forceinline__ void copy_bytes(unsigned char* dst, const unsigned char* src, int n,
                                           bool vec) {
  if (vec) {
    for (int off = threadIdx.x * 16; off < n; off += blockDim.x * 16)
      cp_async16(dst + off, src + off, min(16, n - off));
  } else {
    for (int off = threadIdx.x; off < n; off += blockDim.x) dst[off] = src[off];
  }
}

// Rows [r0, r0 + 64) of an int8 (or packed INT4) code matrix as
// bf16(code · scale), row stride DP + 8; rows past nrows and columns past D
// are 0.
template <int DP>
__device__ __forceinline__ void stage_deq_bf16(__nv_bfloat16* dst, const int8_t* vals,
                                               const float* scales, int per_row, int r0,
                                               int nrows, int D, bool int4) {
  const int w = int4 ? D / 2 : D;
  for (int e = threadIdx.x; e < 64 * DP; e += blockDim.x) {
    const int r = e / DP, c = e - r * DP;
    float x = 0.f;
    if (r0 + r < nrows && c < D) {
      const long long row = r0 + r;
      int code;
      if (int4) {
        const int pk = vals[row * w + (c < w ? c : c - w)];
        code = c < w ? ((pk & 0xF) ^ 8) - 8 : pk >> 4;
      } else {
        code = vals[row * w + c];
      }
      x = __fmul_rn((float)code, scales[per_row ? row : 0]);
    }
    dst[r * (DP + 8) + c] = __float2bfloat16_rn(x);
  }
}

// Four consecutive dO values (16-byte aligned fp32, 8-byte aligned bf16).
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(v.x << 16);
  x[1] = __uint_as_float(v.x & 0xffff0000u);
  x[2] = __uint_as_float(v.y << 16);
  x[3] = __uint_as_float(v.y & 0xffff0000u);
}

template <typename Tdo, int DP>
struct QuantLoad {
  using G = DkvTile<DP>;

  // K̃ and Ṽ of key rows [k0, k0 + 64), and the V mean vm (0 without it).
  static __device__ __forceinline__ void stage_kv(__nv_bfloat16* sK, __nv_bfloat16* sV,
                                                  float* sVm, const QBwdParams& p, long long kbh,
                                                  int k0) {
    const int kw = p.int4 & 2 ? p.D / 2 : p.D, vw = p.int4 & 4 ? p.D / 2 : p.D;
    const long long krow = kbh * p.Sk;
    stage_deq_bf16<DP>(sK, p.k + krow * kw, p.ks + kbh * (p.ks_rows ? p.Sk : 1), p.ks_rows, k0,
                       p.Sk, p.D, p.int4 & 2);
    stage_deq_bf16<DP>(sV, p.v + krow * vw, p.vs + kbh * (p.vs_rows ? p.Sk : 1), p.vs_rows, k0,
                       p.Sk, p.D, p.int4 & 4);
    for (int c = threadIdx.x; c < DP; c += blockDim.x)
      sVm[c] = p.vm && c < p.D ? p.vm[kbh * p.D + c] : 0.f;
  }

  // Issue the copies of query rows [q0, q0 + QT) of head qbh into `raw`.
  static __device__ __forceinline__ void issue(unsigned char* raw, const QBwdParams& p,
                                               long long qbh, int q0, bool vec) {
    const int qw = p.int4 & 1 ? p.D / 2 : p.D;
    const int n = min(G::QT, p.Sq - q0);
    const long long r0 = qbh * p.Sq + q0;
    copy_bytes(raw + G::RAW_Q, reinterpret_cast<const unsigned char*>(p.q + r0 * qw), n * qw, vec);
    copy_bytes(raw + G::RAW_O,
               reinterpret_cast<const unsigned char*>(static_cast<const Tdo*>(p.dout) + r0 * p.D),
               n * p.D * (int)sizeof(Tdo), vec);
    copy_bytes(raw + G::RAW_L, reinterpret_cast<const unsigned char*>(p.lse + r0), n * 4, vec);
    copy_bytes(raw + G::RAW_D, reinterpret_cast<const unsigned char*>(p.delta + r0), n * 4, vec);
    if (p.qs_rows)
      copy_bytes(raw + G::RAW_S, reinterpret_cast<const unsigned char*>(p.qs + r0), n * 4, vec);
  }

  // Q̃ = bf16(code · scale) and bf16(dO) (rows past Sq and columns past D
  // zero), the vm term Σ_d dO·vm (dO in its own precision), LSE and δ,
  // from `raw` into tile `t`; four columns a thread, the DP/4 threads of a
  // row in one warp.
  static __device__ __forceinline__ void stage(const unsigned char* raw, const QTile<DP>& t,
                                               const float* sVm, const QBwdParams& p,
                                               long long qbh, int q0) {
    constexpr int C4 = DP / 4;
    const int D = p.D;
    const bool q4 = p.int4 & 1;
    const int qw = q4 ? D / 2 : D;
    const int8_t* rq = reinterpret_cast<const int8_t*>(raw + G::RAW_Q);
    const Tdo* ro = reinterpret_cast<const Tdo*>(raw + G::RAW_O);
    const float* rs = reinterpret_cast<const float*>(raw + G::RAW_S);
    const float q_scale = p.qs_rows ? 0.f : p.qs[qbh];
    const bool wide = D % 8 == 0;  // four codes in one 32-bit word, four dO in one vector
#pragma unroll
    for (int it = 0; it < G::QT * C4 / NT; ++it) {
      const int e = it * NT + threadIdx.x;
      const int r = e / C4, c = (e - r * C4) * 4;
      const bool live = q0 + r < p.Sq;
      const float sc = live && p.qs_rows ? rs[r] : q_scale;
      float xq[4] = {0.f, 0.f, 0.f, 0.f}, xo[4] = {0.f, 0.f, 0.f, 0.f}, part = 0.f;
      if (wide) {
        if (live && c < D) {
          const uint32_t w4 =
              *reinterpret_cast<const uint32_t*>(rq + r * qw + (q4 && c >= qw ? c - qw : c));
          load4(ro + r * D + c, xo);
          const float4 vm4 = *reinterpret_cast<const float4*>(sVm + c);
          const float vmv[4] = {vm4.x, vm4.y, vm4.z, vm4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int pk = static_cast<int8_t>(w4 >> (8 * i));
            const int code = !q4 ? pk : c < qw ? ((pk & 0xF) ^ 8) - 8 : pk >> 4;
            xq[i] = __fmul_rn((float)code, sc);
            part = fmaf(xo[i], vmv[i], part);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = c + i;
          if (live && col < D) {
            int code;
            if (q4) {
              const int pk = rq[r * qw + (col < qw ? col : col - qw)];
              code = col < qw ? ((pk & 0xF) ^ 8) - 8 : pk >> 4;
            } else {
              code = rq[r * qw + col];
            }
            xq[i] = __fmul_rn((float)code, sc);
            xo[i] = Elem<Tdo>::load(ro, r * D + col);
            part = fmaf(xo[i], sVm[col], part);
          }
        }
      }
      uint2 wq, wo;
      wq.x = pack_bf16x2(xq[0], xq[1]);
      wq.y = pack_bf16x2(xq[2], xq[3]);
      wo.x = pack_bf16x2(xo[0], xo[1]);
      wo.y = pack_bf16x2(xo[2], xo[3]);
      *reinterpret_cast<uint2*>(t.q + r * G::LD + c) = wq;
      *reinterpret_cast<uint2*>(t.o + r * G::LD + c) = wo;
#pragma unroll
      for (int off = C4 / 2; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      if (c == 0) t.vt[r] = part;
    }
    const float* rl = reinterpret_cast<const float*>(raw + G::RAW_L);
    const float* rd = reinterpret_cast<const float*>(raw + G::RAW_D);
    for (int r = threadIdx.x; r < G::QT; r += blockDim.x) {
      const bool live = q0 + r < p.Sq;
      t.lse[r] = live ? rl[r] : 0.f;
      t.delta[r] = live ? rd[r] : 0.f;
    }
  }
};

template <class Load, typename Tout, int DP>
__global__ void __launch_bounds__(NT, DkvTile<DP>::MINB) dkv_tc_kernel(const QBwdParams p, const int vec) {
  using G = DkvTile<DP>;
  constexpr int QT = G::QT, LD = G::LD;
  constexpr int KS = DP / 16;  // 16-deep steps over d
  constexpr int NQ = QT / 8;   // 8-query tiles of Sᵀ and dPᵀ
  constexpr int NA = DP / 8;   // 8-column tiles of dK and dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + 64 * LD;
  float* sVm = reinterpret_cast<float*>(sV + 64 * LD);
  unsigned char* tiles = reinterpret_cast<unsigned char*>(sVm + DP);  // [2][TILE_BYTES]
  unsigned char* raw = tiles + 2 * G::TILE_BYTES;                     // [2][RAW_BYTES]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int k0 = blockIdx.x * 64, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.Hq / p.Hkv;
  const long long kbh = (long long)b * p.Hkv + hk;
  const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;  // this thread's two key rows

  int q_lo, q_hi;
  visible_queries(k0, min(k0 + 64, p.Sk) - 1, p.Sq, p.left, p.right, &q_lo, &q_hi);
  const int t_lo = q_lo / QT;
  const int n_t = q_hi >= q_lo ? q_hi / QT - t_lo + 1 : 0;
  const int total = group * n_t;  // (head, query tile) steps, head-major
  auto head_of = [&](int i) { return (long long)b * p.Hq + hk * group + i / n_t; };
  auto q0_of = [&](int i) { return (t_lo + i % n_t) * QT; };

  // Pipeline: step i's raw operands are copied two steps ahead and
  // converted one step ahead, so one barrier a step orders everything.
  if (total > 0) Load::issue(raw, p, head_of(0), q0_of(0), vec);
  cp_async_commit();
  if (total > 1) Load::issue(raw + G::RAW_BYTES, p, head_of(1), q0_of(1), vec);
  cp_async_commit();
  Load::stage_kv(sK, sV, sVm, p, kbh, k0);
  cp_async_wait<1>();
  __syncthreads();
  if (total > 0) Load::stage(raw, QTile<DP>(tiles), sVm, p, head_of(0), q0_of(0));

  float dk[NA][4], dv[NA][4];
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  float cs[2] = {0.f, 0.f};  // this thread's part of colsum(dS), per key row
  float corr[2] = {0.f, 0.f};

  for (int i = 0; i < total; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // tile i converted, raw i + 1 landed, step i - 1 done
    if (i + 2 < total) Load::issue(raw + (i & 1) * G::RAW_BYTES, p, head_of(i + 2), q0_of(i + 2), vec);
    cp_async_commit();
    if (i + 1 < total)
      Load::stage(raw + ((i + 1) & 1) * G::RAW_BYTES, QTile<DP>(tiles + ((i + 1) & 1) * G::TILE_BYTES),
                  sVm, p, head_of(i + 1), q0_of(i + 1));

    const long long qbh = head_of(i);
    const int q0 = q0_of(i);
    const QTile<DP> t(tiles + (i & 1) * G::TILE_BYTES);
    if (i % n_t == 0 && p.corr) {
      const float* cr = p.corr + qbh * p.Sk;
      corr[0] = key0 < p.Sk ? cr[key0] : 0.f;
      corr[1] = key1 < p.Sk ? cr[key1] : 0.f;
    }

    // This warp's keys [kw, kw + 15] against queries [q0, q0 + QT).
    const int kw = k0 + warp * 16, qe = q0 + QT - 1;
    const bool none = kw >= p.Sk || q0 >= p.Sq || (p.right >= 0 && kw > qe + p.right) ||
                      (p.left >= 0 && kw + 15 < q0 - p.left);
    const bool all = kw + 15 < p.Sk && qe < p.Sq && (p.right < 0 || kw + 15 <= q0 + p.right) &&
                     (p.left < 0 || kw >= qe - p.left);
    if (!none) {
      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ak[4], av[4];
        load_a(ak, sK, LD, warp * 16, ks * 16, lane);
        load_a(av, sV, LD, warp * 16, ks * 16, lane);
#pragma unroll
        for (int jj = 0; jj < QT / 16; ++jj) {
          uint32_t b0[2], b1[2];
          load_b_nk(b0, b1, t.q, LD, jj * 16, ks * 16, lane);
          mma_bf16(s[2 * jj], ak, b0);
          mma_bf16(s[2 * jj + 1], ak, b1);
          load_b_nk(b0, b1, t.o, LD, jj * 16, ks * 16, lane);
          mma_bf16(dp[2 * jj], av, b0);
          mma_bf16(dp[2 * jj + 1], av, b1);
        }
      }

      // Element (j, e): key e < 2 ? key0 : key1, query q0 + 8j + 2tq + (e & 1).
      const float* bias = p.bias ? p.bias + b * p.bsb + (qbh - (long long)b * p.Hq) * p.bsh : nullptr;
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = e < 2 ? key0 : key1, qi = 8 * j + 2 * tq + (e & 1), row = q0 + qi;
          float pr = 0.f, ds = 0.f;
          if (all || key_visible(row, key, p.Sq, p.Sk, p.left, p.right)) {
            float x = s[j][e];
            if (p.corr) x = __fadd_rn(x, corr[e >> 1]);
            if (bias) x = __fadd_rn(x, bias[row * p.bsq + key * p.bsk]);
            pr = expf(x - t.lse[qi]);
            ds = __fmul_rn(pr, __fadd_rn(dp[j][e], t.vt[qi]) - t.delta[qi]);
          }
          cs[e >> 1] += ds;
          s[j][e] = pr;
          dp[j][e] = ds;
        }

#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {
        uint32_t ap[4], as[4];
        pack_a(ap, s[2 * kk], s[2 * kk + 1]);
        pack_a(as, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int dn = 0; dn < DP / 16; ++dn) {
          uint32_t b0[2], b1[2];
          load_b_kn(b0, b1, t.o, LD, kk * 16, dn * 16, lane);
          mma_bf16(dv[2 * dn], ap, b0);
          mma_bf16(dv[2 * dn + 1], ap, b1);
          load_b_kn(b0, b1, t.q, LD, kk * 16, dn * 16, lane);
          mma_bf16(dk[2 * dn], as, b0);
          mma_bf16(dk[2 * dn + 1], as, b1);
        }
      }
    }

    if (i % n_t == n_t - 1) {
      // The head's last tile: dK += scale · colsum(dS)ᵀ · qm of this head.
      if (p.qm) {
        const float* qm = p.qm + qbh * p.D;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float sc = p.scale * quad_sum(cs[r]);
#pragma unroll
          for (int n = 0; n < NA; ++n) {
            const int col = 8 * n + 2 * tq;
            if (col < p.D) dk[n][2 * r] = fmaf(sc, qm[col], dk[n][2 * r]);
            if (col + 1 < p.D) dk[n][2 * r + 1] = fmaf(sc, qm[col + 1], dk[n][2 * r + 1]);
          }
        }
      }
      cs[0] = cs[1] = 0.f;
    }
  }

  Tout* dkp = static_cast<Tout*>(p.out0) + kbh * p.Sk * p.D;
  Tout* dvp = static_cast<Tout*>(p.out1) + kbh * p.Sk * p.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r ? key1 : key0;
    if (key >= p.Sk) continue;
#pragma unroll
    for (int n = 0; n < NA; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * n + 2 * tq + c;
        if (col < p.D) {
          Elem<Tout>::store(dkp, (long long)key * p.D + col, dk[n][2 * r + c]);
          Elem<Tout>::store(dvp, (long long)key * p.D + col, dv[n][2 * r + c]);
        }
      }
  }
}

template <typename Tdo, typename Tout, int DP>
cudaError_t launch_dq(const QBwdParams& p, cudaStream_t stream) {
  const int smem = qdq_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(quant_bwd_dq_kernel<Tdo, Tout, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, p.B);
  quant_bwd_dq_kernel<Tdo, Tout, DP><<<grid, NTB, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename Tdo, typename Tout, int DP>
cudaError_t launch_dkv(const QBwdParams& p, cudaStream_t stream) {
  using G = DkvTile<DP>;
  const auto fn = dkv_tc_kernel<QuantLoad<Tdo, DP>, Tout, DP>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return err;
  // Query tiles by cp.async when every tile's rows start 16-byte aligned.
  const long long qw = p.int4 & 1 ? p.D / 2 : p.D;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(p.q) | reinterpret_cast<uintptr_t>(p.dout) |
                         reinterpret_cast<uintptr_t>(p.lse) |
                         reinterpret_cast<uintptr_t>(p.delta) | reinterpret_cast<uintptr_t>(p.qs);
  const int vec = (ptrs & 15) == 0 && p.Sq % 4 == 0 && p.Sq * qw % 16 == 0 &&
                  p.Sq * (long long)p.D * (long long)sizeof(Tdo) % 16 == 0;
  const dim3 grid((p.Sk + 63) / 64, p.Hkv, p.B);
  dkv_tc_kernel<QuantLoad<Tdo, DP>, Tout, DP><<<grid, NT, G::SMEM, stream>>>(p, vec);
  return cudaGetLastError();
}

template <typename Tdo, typename Tout>
cudaError_t launch_d(const QBwdParams& p, bool dkv, cudaStream_t stream) {
  if (dkv)
    return p.D <= 64 ? launch_dkv<Tdo, Tout, 64>(p, stream) : launch_dkv<Tdo, Tout, 128>(p, stream);
  return p.D <= 64 ? launch_dq<Tdo, Tout, 64>(p, stream) : launch_dq<Tdo, Tout, 128>(p, stream);
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

// Dynamic shared memory of the dK/dV kernel for head dim D, in bytes (0 if
// it does not take D).
extern "C" int umfa_quant_bwd_dkv_smem_bytes(int D) {
  if (D < 1 || D > 128) return 0;
  return D <= 64 ? DkvTile<64>::SMEM : DkvTile<128>::SMEM;
}
