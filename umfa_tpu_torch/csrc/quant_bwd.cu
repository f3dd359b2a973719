// STE backward on quantized residuals (dQ, then dK/dV) for Hopper, sm_90a.
//
// Replaces umfa_tpu/ops/quant_bwd.py:101 `_q_dq_kernel` (`quant_bwd_dq`)
// and quant_bwd.py:339 `_q_dkv_kernel` (`quant_bwd_dkv`), host
// `quantized_attention_backward` (quant_bwd.py:589), with their
// block-sparse walks (quant_bwd.py:146-200, :396-445: the SPARSE
// instantiations of the bodies, a map given; the others compile as without
// it). The host wrapper (ops/quant_bwd.py) computes
// δ = rowsum(dO∘O) − dlse in fp32, gives rows with no visible key LSE
// +1e30 (their gradients are exactly 0), folds the softmax scale into Q's
// scales and multiplies the Q-mean score row by it, as the reference does
// outside its kernels. Head dims up to 256 (templates 64, 128, 256; a
// smaller D is zero-padded in shared memory to the template width).
//
// What bounds it on this card: at the training shape (B8 Hq16 Hkv8, causal
// S 4096, D 64) the dQ pass does 3 products (S, dP, dQ) and the dK/dV pass 4
// (S, dP, dV, dK) over the visible pairs, 2·D flops each: 4.12e11 and
// 5.5e11 flop, against reading the int8 residuals, dO, LSE and δ once:
// operation-bound, 0.417 ms and 0.556 ms at 989 TFLOP/s bf16 against
// ~0.05 ms of HBM time.
//
// What the design does about it: both passes are the tensor-core bodies of
// bwd_tc.cuh (mma.sync m16n8k16 bf16 -> fp32) with load stages that
// dequantize the codes into bf16 tiles in shared memory:
//   * dQ (`dq_tc_kernel<QuantDqLoad>`): one block of 4 warps per (64-row
//     query tile, q head, batch); Q̃, bf16(dO), the vm term, LSE and δ
//     staged once; per key tile the raw K and V codes, their row scales and
//     the corr row copied by cp.async two steps ahead and dequantized one
//     step ahead (64 keys at D 64, 32 above). Each block dequantizes every
//     key tile it sees again: at GQA group g that is g times the
//     dequantization of a block per (query tile, kv head) that folds the
//     group into its rows, which at D 64 would need twice the shared memory
//     for Q̃ and dO (two blocks an SM instead of three) and does not fit at
//     D 256. The dequantization runs on the CUDA cores beside the tensor
//     cores' products, as dK/dV's does.
//   * dK/dV (`dkv_tc_kernel<QuantLoad>`): one block of 4 warps (8 at D 256)
//     per (64-key tile, kv head, batch); K̃ and Ṽ dequantized once; the raw
//     Q codes, dO, LSE and δ of each visible 32-row query tile of the GQA
//     group copied by cp.async two steps ahead and dequantized one step
//     ahead; the group sum and each head's Q-mean term stay in registers.
// Their sums run in another order than the plain version's, so the two
// agree to the backward gates, not bit for bit. Left for later PRs: wgmma,
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
#include "bwd_tc.cuh"

using namespace umfa;

namespace {

// bf16(code · sc) of four codes: byte i of w4 is column c + i. INT4 bytes
// hold the split halves: `high` (c >= D/2) takes the upper nibbles (an
// arithmetic shift), else the lower ones, ((p & 0xF) ^ 8) - 8.
__device__ __forceinline__ void unpack4(uint32_t w4, bool int4, bool high, float sc,
                                        float (&x)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pk = static_cast<int8_t>(w4 >> (8 * i));
    const int code = !int4 ? pk : high ? pk >> 4 : ((pk & 0xF) ^ 8) - 8;
    x[i] = __fmul_rn((float)code, sc);
  }
}

// Column c of a row of codes (w bytes wide: D, or D/2 for INT4), 0 past D.
__device__ __forceinline__ int code_at(const int8_t* row, int c, int w, int D, bool int4) {
  if (c >= D) return 0;
  const int pk = row[int4 && c >= w ? c - w : c];
  return !int4 ? pk : c < w ? ((pk & 0xF) ^ 8) - 8 : pk >> 4;
}

// Rows [0, ROWS) of a code matrix (n live rows, packed rows; scales rs[r],
// or sc0 for every row when rs is null) into a bf16 tile of row stride
// DP + 8; rows past n and columns past D are 0. Four columns a thread;
// wide (D % 8 == 0, codes 4-byte aligned): the four codes are one word.
template <int DP, int ROWS>
__device__ __forceinline__ void deq_rows(__nv_bfloat16* dst, const int8_t* codes, const float* rs,
                                         float sc0, int n, int D, bool int4, bool wide) {
  constexpr int C4 = DP / 4;
  const int w = int4 ? D / 2 : D;
  for (int e = threadIdx.x; e < ROWS * C4; e += blockDim.x) {
    const int r = e / C4, c = (e - r * C4) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < n && c < D) {
      const float sc = rs ? rs[r] : sc0;
      if (wide) {
        unpack4(*reinterpret_cast<const uint32_t*>(codes + r * w + (int4 && c >= w ? c - w : c)),
                int4, c >= w, sc, x);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          x[i] = __fmul_rn((float)code_at(codes + r * w, c + i, w, D, int4), sc);
      }
    }
    store4(dst + r * (DP + 8) + c, x);
  }
}

// Rows [0, ROWS) of a query tile (n live rows): Q̃ = bf16(code · scale) into
// tq and bf16(dO) into to (bf16, row stride DP + 8; rows past n and columns
// past D zero), and the vm term Σ_d dO·vm per row (dO in its own
// precision; 0 without vm) into vt. Each thread takes CW consecutive
// columns; the DP / CW threads of a row are lanes of one warp and sum the
// vm term with xor-shuffles. wide: as for deq_rows, and dO rows and vm
// 16-byte aligned.
template <typename Tdo, int DP, int ROWS, int NTHR>
__device__ __forceinline__ void deq_q_rows(__nv_bfloat16* tq, __nv_bfloat16* to, float* vt,
                                           const int8_t* codes, const Tdo* dout, const float* rs,
                                           float sc0, const float* vm, int n, int D, bool q4,
                                           bool wide) {
  constexpr int CW = DP > 128 ? 8 : 4;  // columns a thread
  constexpr int TPR = DP / CW;          // threads a row
  const int qw = q4 ? D / 2 : D;
#pragma unroll
  for (int it = 0; it < ROWS * TPR / NTHR; ++it) {
    const int e = it * NTHR + threadIdx.x;
    const int r = e / TPR, c0 = (e - r * TPR) * CW;
    const bool live = r < n;
    const float sc = live && rs ? rs[r] : sc0;
    float part = 0.f;
#pragma unroll
    for (int c = c0; c < c0 + CW; c += 4) {
      float xq[4] = {0.f, 0.f, 0.f, 0.f}, xo[4] = {0.f, 0.f, 0.f, 0.f};
      if (wide) {
        if (live && c < D) {
          unpack4(*reinterpret_cast<const uint32_t*>(codes + r * qw + (q4 && c >= qw ? c - qw : c)),
                  q4, c >= qw, sc, xq);
          load4(dout + r * D + c, xo);
          if (vm) {
            const float4 v4 = *reinterpret_cast<const float4*>(vm + c);
            part = fmaf(xo[3], v4.w, fmaf(xo[2], v4.z, fmaf(xo[1], v4.y, fmaf(xo[0], v4.x, part))));
          }
        }
      } else if (live) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (c + i >= D) continue;
          xq[i] = __fmul_rn((float)code_at(codes + r * qw, c + i, qw, D, q4), sc);
          xo[i] = Elem<Tdo>::load(dout, r * D + c + i);
          if (vm) part = fmaf(xo[i], vm[c + i], part);
        }
      }
      store4(tq + r * (DP + 8) + c, xq);
      store4(to + r * (DP + 8) + c, xo);
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (c0 == 0) vt[r] = part;
  }
}

// ---- dK/dV: the dequantizing load stage of dkv_tc_kernel ------------------

// A dequantized query tile: bf16 tiles (QT x LD) and fp32 rows, all in the
// converted buffer; Sᵀ and dK both read Q̃.
template <int DP>
struct QTile {
  static constexpr int QT = DkvTile<DP>::QT, LD = DkvTile<DP>::LD;
  static constexpr int BYTES = 2 * QT * LD * 2 + 3 * QT * 4;
  __nv_bfloat16* q;
  __nv_bfloat16* qk;
  __nv_bfloat16* o;
  float* vt;
  float* lse;
  float* delta;
  __device__ __forceinline__ QTile(unsigned char* base, unsigned char*) {
    q = qk = reinterpret_cast<__nv_bfloat16*>(base);
    o = q + QT * LD;
    vt = reinterpret_cast<float*>(o + QT * LD);
    lse = vt + QT;
    delta = lse + QT;
  }
};

template <typename Tdo, int DP>
struct QuantLoad {
  using G = DkvTile<DP>;
  using Tile = QTile<DP>;
  static constexpr int NRAW = 2;
  static constexpr bool HEAD_TERMS = true;  // the corr row and the Q-mean term
  // Staging buffer: Q codes, dO (up to fp32), LSE, δ, Q's row scales.
  static constexpr int RAW_Q = 0;
  static constexpr int RAW_O = G::QT * DP;
  static constexpr int RAW_L = RAW_O + G::QT * DP * 4;
  static constexpr int RAW_D = RAW_L + G::QT * 4;
  static constexpr int RAW_S = RAW_D + G::QT * 4;
  static constexpr int RAW_BYTES = RAW_S + G::QT * 4;

  // Q̃ carries the softmax scale, so dK is stored as summed.
  static __device__ __forceinline__ float dk_scale(const BwdParams&) { return 1.f; }

  // K̃ and Ṽ of key rows [k0, k0 + 64), and the V mean vm (0 without it).
  static __device__ __forceinline__ void stage_kv(__nv_bfloat16* sK, __nv_bfloat16* sV,
                                                  float* sVm, const BwdParams& p, long long kbh,
                                                  int k0) {
    const bool k4 = p.int4 & 2, v4 = p.int4 & 4;
    const long long r0 = kbh * p.Sk + k0;
    const int n = min(64, p.Sk - k0);
    deq_rows<DP, 64>(sK, static_cast<const int8_t*>(p.k) + r0 * (k4 ? p.D / 2 : p.D),
                     p.ks_rows ? p.ks + r0 : nullptr, p.ks_rows ? 0.f : p.ks[kbh], n, p.D, k4,
                     p.wide);
    deq_rows<DP, 64>(sV, static_cast<const int8_t*>(p.v) + r0 * (v4 ? p.D / 2 : p.D),
                     p.vs_rows ? p.vs + r0 : nullptr, p.vs_rows ? 0.f : p.vs[kbh], n, p.D, v4,
                     p.wide);
    for (int c = threadIdx.x; c < DP; c += blockDim.x)
      sVm[c] = p.vm && c < p.D ? p.vm[kbh * p.D + c] : 0.f;
  }

  // Issue the copies of query rows [q0, q0 + QT) of head qbh into `raw`.
  static __device__ __forceinline__ void issue(unsigned char* raw, const BwdParams& p,
                                               long long qbh, int q0, bool vec) {
    const int qw = p.int4 & 1 ? p.D / 2 : p.D;
    const int n = min(G::QT, p.Sq - q0);
    const long long r0 = qbh * p.Sq + q0;
    copy_bytes(raw + RAW_Q, static_cast<const unsigned char*>(p.q) + r0 * qw, n * qw, vec);
    copy_bytes(raw + RAW_O,
               reinterpret_cast<const unsigned char*>(static_cast<const Tdo*>(p.dout) + r0 * p.D),
               n * p.D * (int)sizeof(Tdo), vec);
    copy_bytes(raw + RAW_L, reinterpret_cast<const unsigned char*>(p.lse + r0), n * 4, vec);
    copy_bytes(raw + RAW_D, reinterpret_cast<const unsigned char*>(p.delta + r0), n * 4, vec);
    if (p.qs_rows)
      copy_bytes(raw + RAW_S, reinterpret_cast<const unsigned char*>(p.qs + r0), n * 4, vec);
  }

  // Q̃, bf16(dO), the vm term, LSE and δ from `raw` into tile `t`.
  static __device__ __forceinline__ void stage(const unsigned char* raw, const Tile& t,
                                               const float* sVm, const BwdParams& p,
                                               long long qbh, int q0) {
    const int n = min(G::QT, p.Sq - q0);
    deq_q_rows<Tdo, DP, G::QT, G::NTHR>(
        t.q, t.o, t.vt, reinterpret_cast<const int8_t*>(raw + RAW_Q),
        reinterpret_cast<const Tdo*>(raw + RAW_O),
        p.qs_rows ? reinterpret_cast<const float*>(raw + RAW_S) : nullptr,
        p.qs_rows ? 0.f : p.qs[qbh], p.vm ? sVm : nullptr, n, p.D, p.int4 & 1, p.D % 8 == 0);
    const float* rl = reinterpret_cast<const float*>(raw + RAW_L);
    const float* rd = reinterpret_cast<const float*>(raw + RAW_D);
    for (int r = threadIdx.x; r < G::QT; r += blockDim.x) {
      t.lse[r] = r < n ? rl[r] : 0.f;
      t.delta[r] = r < n ? rd[r] : 0.f;
    }
  }
};

// ---- dQ: the dequantizing load stage of dq_tc_kernel ----------------------

template <typename Tdo, int DP>
struct QuantDqLoad {
  static constexpr int KT = DqTile<DP>::KT, LD = DqTile<DP>::LD;
  static constexpr int NRAW = 2, AHEAD = 2, IN_FLIGHT = 0;
  // The dequantized key tile: K̃, Ṽ (bf16) and the corr row (its per-key
  // score term) in the converted buffer.
  struct Kv {
    static constexpr int BYTES = 2 * KT * LD * 2 + KT * 4;
    __nv_bfloat16* k;
    __nv_bfloat16* v;
    float* c;
    __device__ __forceinline__ Kv(unsigned char* base, unsigned char*) {
      k = reinterpret_cast<__nv_bfloat16*>(base);
      v = k + KT * LD;
      c = reinterpret_cast<float*>(v + KT * LD);
    }
    __device__ __forceinline__ float score(float x, int kj) const { return __fadd_rn(x, c[kj]); }
  };
  // Staging buffer of a key tile: K codes, V codes, K's and V's row
  // scales, the corr row.
  static constexpr int RAW_K = 0;
  static constexpr int RAW_V = KT * DP;
  static constexpr int RAW_KS = 2 * KT * DP;
  static constexpr int RAW_VS = RAW_KS + KT * 4;
  static constexpr int RAW_C = RAW_VS + KT * 4;
  static constexpr int RAW_BYTES = RAW_C + KT * 4;

  // Q̃, bf16(dO), the vm term, LSE and δ of query rows [q0, q0 + 64).
  static __device__ __forceinline__ void stage_q(__nv_bfloat16* sQ, __nv_bfloat16* sO, float* sRow,
                                                 const BwdParams& p, long long qbh, long long kbh,
                                                 int q0) {
    const bool q4 = p.int4 & 1;
    const int n = min(64, p.Sq - q0);
    const long long r0 = qbh * p.Sq + q0;
    deq_q_rows<Tdo, DP, 64, NT>(
        sQ, sO, sRow, static_cast<const int8_t*>(p.q) + r0 * (q4 ? p.D / 2 : p.D),
        static_cast<const Tdo*>(p.dout) + r0 * p.D, p.qs_rows ? p.qs + r0 : nullptr,
        p.qs_rows ? 0.f : p.qs[qbh], p.vm ? p.vm + kbh * p.D : nullptr, n, p.D, q4, p.wide);
    for (int r = threadIdx.x; r < 64; r += blockDim.x) {
      sRow[64 + r] = r < n ? p.lse[r0 + r] : 0.f;
      sRow[128 + r] = r < n ? p.delta[r0 + r] : 0.f;
    }
  }

  // Issue the copies of key rows [k0, k0 + KT) into `raw`.
  static __device__ __forceinline__ void issue(unsigned char* raw, const BwdParams& p,
                                               long long qbh, long long kbh, int k0, bool vec) {
    const int kw = p.int4 & 2 ? p.D / 2 : p.D, vw = p.int4 & 4 ? p.D / 2 : p.D;
    const int n = min(KT, p.Sk - k0);
    const long long r0 = kbh * p.Sk + k0;
    copy_bytes(raw + RAW_K, static_cast<const unsigned char*>(p.k) + r0 * kw, n * kw, vec);
    copy_bytes(raw + RAW_V, static_cast<const unsigned char*>(p.v) + r0 * vw, n * vw, vec);
    if (p.ks_rows)
      copy_bytes(raw + RAW_KS, reinterpret_cast<const unsigned char*>(p.ks + r0), n * 4, vec);
    if (p.vs_rows)
      copy_bytes(raw + RAW_VS, reinterpret_cast<const unsigned char*>(p.vs + r0), n * 4, vec);
    if (p.corr)
      copy_bytes(raw + RAW_C, reinterpret_cast<const unsigned char*>(p.corr + qbh * p.Sk + k0),
                 n * 4, vec);
  }

  // K̃, Ṽ and the corr row (0 without it) from `raw` into `kv`.
  static __device__ __forceinline__ void stage(const unsigned char* raw, const Kv& kv,
                                               const BwdParams& p, long long kbh, int k0) {
    const int n = min(KT, p.Sk - k0);
    deq_rows<DP, KT>(kv.k, reinterpret_cast<const int8_t*>(raw + RAW_K),
                     p.ks_rows ? reinterpret_cast<const float*>(raw + RAW_KS) : nullptr,
                     p.ks_rows ? 0.f : p.ks[kbh], n, p.D, p.int4 & 2, p.D % 8 == 0);
    deq_rows<DP, KT>(kv.v, reinterpret_cast<const int8_t*>(raw + RAW_V),
                     p.vs_rows ? reinterpret_cast<const float*>(raw + RAW_VS) : nullptr,
                     p.vs_rows ? 0.f : p.vs[kbh], n, p.D, p.int4 & 4, p.D % 8 == 0);
    const float* rc = reinterpret_cast<const float*>(raw + RAW_C);
    for (int r = threadIdx.x; r < KT; r += blockDim.x) kv.c[r] = p.corr && r < n ? rc[r] : 0.f;
  }
};

template <typename Tdo, typename Tout, int DP, bool SPARSE>
cudaError_t launch(BwdParams p, bool dkv, cudaStream_t stream) {
  p.wide = p.D % 8 == 0 && aligned({p.q, p.k, p.v, p.dout, p.vm}, 16);
  if (dkv) {
    const long long qw = p.int4 & 1 ? p.D / 2 : p.D;
    // Query tiles by cp.async when every tile's rows start 16-byte aligned
    // (a walk's tiles start at multiples of 16 rows when its map tiles do).
    const int vec = aligned({p.q, p.dout, p.lse, p.delta, p.qs}, 16) && p.Sq % 4 == 0 &&
                    p.Sq * qw % 16 == 0 &&
                    p.Sq * (long long)p.D * (long long)sizeof(Tdo) % 16 == 0 &&
                    (!SPARSE || p.sm.bq % 16 == 0);
    return launch_dkv_tc<QuantLoad<Tdo, DP>, Bf16Mma, Tout, DP, false, SPARSE>(p, vec, stream);
  }
  const long long kw = p.int4 & 2 ? p.D / 2 : p.D, vw = p.int4 & 4 ? p.D / 2 : p.D;
  // Key tiles by cp.async when every tile's rows start 16-byte aligned.
  const int vec = aligned({p.k, p.v, p.ks, p.vs, p.corr}, 16) && p.Sk % 4 == 0 &&
                  p.Sk * kw % 16 == 0 && p.Sk * vw % 16 == 0 && (!SPARSE || p.sm.bk % 16 == 0);
  return launch_dq_tc<QuantDqLoad<Tdo, DP>, Bf16Mma, Tout, DP, false, SPARSE>(p, vec, stream);
}

template <typename Tdo, typename Tout, bool SPARSE>
cudaError_t launch_d(const BwdParams& p, bool dkv, cudaStream_t stream) {
  if (p.D <= 64) return launch<Tdo, Tout, 64, SPARSE>(p, dkv, stream);
  if (p.D <= 128) return launch<Tdo, Tout, 128, SPARSE>(p, dkv, stream);
  return launch<Tdo, Tout, 256, SPARSE>(p, dkv, stream);
}

template <typename Tdo, typename Tout>
cudaError_t launch_walk(const BwdParams& p, bool dkv, cudaStream_t stream) {
  return p.sm.map ? launch_d<Tdo, Tout, true>(p, dkv, stream)
                  : launch_d<Tdo, Tout, false>(p, dkv, stream);
}

int dispatch(BwdParams p, bool dkv, int do_dtype, int out_dtype, const void* map,
             const void* fetch, int bq, int bk, int nq, int nk, int width, long long msb,
             long long msh, long long fsb, long long fsh, void* stream) {
  if (p.D < 1 || p.D > 256 || p.Hkv < 1 || p.Hq % p.Hkv != 0 || (p.int4 && p.D % 2) ||
      do_dtype < 0 || do_dtype > 1 || out_dtype < 0 || out_dtype > 1 ||
      !sparse_map(&p.sm, map, fetch, bq, bk, nq, nk, width, msb, msh, fsb, fsh))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (do_dtype == 0)
    return out_dtype == 0 ? launch_walk<float, float>(p, dkv, st)
                          : launch_walk<float, __nv_bfloat16>(p, dkv, st);
  return out_dtype == 0 ? launch_walk<__nv_bfloat16, float>(p, dkv, st)
                        : launch_walk<__nv_bfloat16, __nv_bfloat16>(p, dkv, st);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. q (B, Hq, Sq, D | D/2) and k/v
// (B, Hkv, Sk, D | D/2) int8 codes (packed INT4 where `int4` says so),
// contiguous, D <= 256; scales float32 (B, H, S) or (B, H) per the *_rows
// flags; dout (B, Hq, Sq, D) in do_dtype; lse, delta (B, Hq, Sq) float32;
// qm (B, Hq, D), vm (B, Hkv, D), corr (B, Hq, Sk) float32 or null; bias
// float32 with element strides (or null). umfa_quant_bwd_dq writes
// out0 = dQ (B, Hq, Sq, D); umfa_quant_bwd_dkv writes out0 = dK and
// out1 = dV (B, Hkv, Sk, D); both in out_dtype. map (null: no walk): the
// block-sparse map (Bm, Hm, nq, nk) int32 of bq x bk tiles and fetch, its
// compacted table (fetch_kv for dQ, fetch_q for dK/dV; (Bm, Hm, nq | nk,
// width)), with the element strides of their batch and head (0 =
// broadcast). Each returns the cudaError_t of its launch.
#define UMFA_QBWD_ARGS                                                                          \
  const void *q, const void *k, const void *v, const void *qs, const void *ks, const void *vs, \
      const void *dout, const void *lse, const void *delta, const void *qm, const void *vm,    \
      const void *corr, const void *bias, void *out0, void *out1, int B, int Hq, int Hkv,      \
      int Sq, int Sk, int D, int qs_rows, int ks_rows, int vs_rows, long long bsb,              \
      long long bsh, long long bsq, long long bsk, float scale, int left, int right, int int4, \
      int do_dtype, int out_dtype, const void *map, const void *fetch, int bq, int bk, int nq,   \
      int nk, int width, long long msb, long long msh, long long fsb, long long fsh, void *stream
#define UMFA_QBWD_PARAMS                                                                     \
  BwdParams {                                                                                \
    q, k, v, static_cast<const float*>(qs), static_cast<const float*>(ks),                   \
        static_cast<const float*>(vs), dout, static_cast<const float*>(lse),                 \
        static_cast<const float*>(delta), static_cast<const float*>(qm),                     \
        static_cast<const float*>(vm), static_cast<const float*>(corr),                      \
        static_cast<const float*>(bias), out0, out1, B, Hq, Hkv, Sq, Sk, D, qs_rows,         \
        ks_rows, vs_rows, bsb, bsh, bsq, bsk, scale, left, right, int4                       \
  }

extern "C" int umfa_quant_bwd_dq(UMFA_QBWD_ARGS) {
  return dispatch(UMFA_QBWD_PARAMS, false, do_dtype, out_dtype, map, fetch, bq, bk, nq, nk, width,
                  msb, msh, fsb, fsh, stream);
}

extern "C" int umfa_quant_bwd_dkv(UMFA_QBWD_ARGS) {
  return dispatch(UMFA_QBWD_PARAMS, true, do_dtype, out_dtype, map, fetch, bq, bk, nq, nk, width,
                  msb, msh, fsb, fsh, stream);
}

// Dynamic shared memory of the dQ (dkv = 0) or dK/dV (dkv = 1) kernel for
// head dim D, in bytes (0 if it does not take D; the same for both dO
// dtypes).
extern "C" int umfa_quant_bwd_smem_bytes(int D, int dkv) {
  if (D < 1 || D > 256) return 0;
  if (dkv)
    return D <= 64    ? dkv_smem_bytes<QuantLoad<float, 64>, Bf16Mma, 64>()
           : D <= 128 ? dkv_smem_bytes<QuantLoad<float, 128>, Bf16Mma, 128>()
                      : dkv_smem_bytes<QuantLoad<float, 256>, Bf16Mma, 256>();
  return D <= 64    ? dq_smem_bytes<QuantDqLoad<float, 64>, Bf16Mma, 64>()
         : D <= 128 ? dq_smem_bytes<QuantDqLoad<float, 128>, Bf16Mma, 128>()
                    : dq_smem_bytes<QuantDqLoad<float, 256>, Bf16Mma, 256>();
}
