// Quantized (INT8/INT4) attention forward on pre-quantized operands, for
// Hopper, sm_90a, on the tensor cores.
//
// Replaces umfa_tpu/ops/quant_attention.py:74 `_quant_fwd_kernel` (host
// `quantized_attention_forward`, quant_attention.py:295) for INT8 or INT4
// operands (each its own), symmetric or asymmetric, with per-row or
// per-tensor scales, the Q-mean correction row, bias, causal/window and
// GQA, head dims up to 256 (D % 4 == 0; templates 64, 128, 256, a smaller
// D zero-padded to the template width, where int8 zeros add nothing to
// the dot), its block-sparse walk (`block_map`/`fetch_ids`,
// quant_attention.py:371-387), and the integer P·V of pv_int8 (below).
//
// What bounds it on this card: at the serving prefill (B8 Hq16 Hkv8, 4032
// causal queries against the 4096-row INT8 cache, D 64) the work is
// operation-bound: 2·D int8 ops per visible (query, key) pair for QKᵀ
// (1,979 TOP/s) plus 2·D bf16 flops for P·V (989 TFLOP/s), against one
// byte per element of Q/K/V and four per element of the fp32 output. What
// holds this mma.sync design far above that bound is the per-pair work
// around the products: two exactly rounded scale multiplies and the mask
// in each pass, then the accurate expf, the l sum and the bf16 rounding of
// P in the second, on 16 warps an SM.
//
// What this design does about it (`quant_attn_fwd_tc_kernel`, the shape of
// flash_fwd.cu's `flash_fwd_tc_kernel`):
//   * one block of 8 warps per (128-row query tile, q head, batch), issued
//     heaviest first; each warp owns 16 whole query rows, so row maxima and
//     sums need only quad shuffles; two blocks an SM at D <= 128;
//   * QKᵀ by mma.sync m16n8k32 s8 x s8 -> s32: exact, like the __dp4a it
//     replaces. Int8 tiles are padded to DP + 16 bytes a row and read by
//     the bf16 ldmatrix loaders viewing each row as 16-bit words (mma.cuh).
//     Q's int8 tile is staged once; at D <= 128 its A fragments stay in
//     registers for the whole walk, at D 256 they are read from shared
//     memory;
//   * the int8 K and V tiles of 64 keys and their scales arrive by cp.async
//     into three buffers, two tiles ahead (16-byte copies when D % 16 == 0
//     and the operands are 16-byte aligned, 4-byte copies otherwise); rows
//     past Sk and columns past D are zero-filled by the copy. An INT4
//     operand (split-halves nibbles) is unpacked into the same int8 tile
//     while it is staged, by plain loads and stores in the same ring
//     (`unpack_tile`), so the int8 QKᵀ runs as it is: the card's integer
//     tensor-core rate is int8's. The per-key rows (the Q-mean corr row,
//     the asymmetric zero points and row sums) stream with the key tile
//     like its scales. Key tiles
//     hidden from the whole block are never loaded, a warp skips a tile its
//     rows cannot see, and masks and bias are applied only on tiles that
//     cross a mask edge or carry a bias;
//   * each V tile is dequantized once per block, a step ahead, into one of
//     two padded bf16 tiles, bf16(bf16(v) · bf16(v_scale)), so a step needs
//     one barrier; the scores of each 16-key chunk go straight from the
//     s32 accumulators through the softmax into the A fragment of P·V,
//     mma.sync m16n8k16 bf16 -> fp32, with V's B fragments through
//     ldmatrix.trans.
//
// Two passes over the visible keys, kept on purpose: the first runs QKᵀ
// alone for the exact row max m (it copies no V), the second forms
// P = expf(s - m) against that final max. P is then rounded to bf16 where
// the plain version and the reference round it; a one-pass online softmax
// rounds against a running max and put this kernel's LSE ~1e-3 from the
// plain version's, over its 1e-4 gate. The first pass costs one more int8
// QKᵀ and its scaling for every visible tile.
//
// Arithmetic held to the reference (quant_attention.py:166-256):
//   s = float(int32 dot); asymmetric, s − zq·rs_k − zk·rs_q + (D·zq)·zk,
//   rounded fp32 steps in that order (zero points and row sums exact in
//   fp32); then · q_scale · k_scale, two rounded multiplies with the
//   softmax scale already folded into q_scale by the host; then rounded
//   adds of the corr row (scale folded in) and of the bias (never
//   contracted, so both passes get the same bits); index mask (causal,
//   window, KV tail) -> -1e30 and P = 0 (a -1e30 bias is not an index
//   mask); l sums the fp32 P; P·V takes bf16(P) and the dequantized V tile
//   bf16(bf16(v)·bf16(v_scale)), or, asymmetric, bf16(P·v_scale) and the
//   integer V codes, less Σ P·v_scale·zv in fp32; accumulated in fp32;
//   output fp32; a row with no visible key writes out = 0 and LSE -1e30;
//   q head h reads kv head h / (Hq / Hkv);
//   block-sparse (a map given, the SPARSE instantiations; the others
//   compile as without it): key j is walked by query i iff the map tile
//   (i / block_q, j / block_k) is not SKIP; unwalked keys are hidden like
//   index-masked ones. Both passes walk the block's compacted key row
//   (fetch_kv, clipped to the band; common.cuh `SparseWalk`), counted once
//   and run twice, its 64-key tiles from each map tile's first key; the
//   bias is read only on tiles that are not FULL for the block, and a
//   block that straddles map tiles looks up each element's own tile.
//
// pv_int8 (the PV instantiations, VAR 0 and 1; quant_attention.py:219-229):
// V's scale is constant over each group of keys (the host checks: BLOCK
// per KV tile, a multiple of 32 keys, or one group), so it factors out of
// an integer P·V. P's codes rint(127·p) (0..127, p against the final max,
// 0 on hidden lanes) go from the score registers into the u8 A fragment of
// mma.sync m16n8k32 u8 x s8 -> s32 (IMMA) as they stand, the V codes into
// its B fragments from a D-major tile transposed a step ahead (in place of
// the dequantized bf16 tile; `transpose_codes`, mma.cuh); each 32-key
// step's exact s32 sum converts once: acc += Σ · fp32(sv · fp32(1/127)); l
// sums the fp32 P. Where the reference walks one KV tile its running max is
// the final max, so the codes agree.
#include "common.cuh"
#include "mma.cuh"

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
  const float* corr;  // (B, Hq, Sk) the Q-mean row, softmax scale folded in, or null
  // Asymmetric (or null): zero points laid out as the scales, row sums
  // (B, H, S) of the codes, as fp32.
  const float* qz;
  const float* qr;
  const float* kz;
  const float* kr;
  const float* vz;
  float* out;
  float* lse;
  int B, Hq, Hkv, Sq, Sk, D;
  int qs_rows, ks_rows, vs_rows;  // 1 = one scale per row, 0 = one per (b, h)
  long long bsb, bsh, bsq, bsk;
  int left, right;
  int vec;  // D % 16 == 0 and q/k/v 16-byte aligned: 16-byte copies
  int q4, k4, v4;  // INT4 operands, D / 2 packed bytes a row
  float dz;  // the head dim of the zero-point term (before any padding)
  SparseMap sm;  // read only by the SPARSE instantiations: the map and fetch_kv
  int pv;  // pv_int8: the integer P·V (the PV instantiations)
};

constexpr float PV_SCALE = 1.f / 127.f;  // the reference's fp32(1/127)

// Tile geometry: 8 warps of 16 query rows each, BQ = 128 query rows a
// block, 64-key tiles in three buffers (tile i computed, tile i + 1 landed
// and its V dequantized, tile i + 2 in flight) and the dequantized V in
// two. At D <= 128 two blocks an SM (registers capped at 128).
template <int DP>
struct Cfg {
  static constexpr int NW = 8;
  static constexpr int NTH = 32 * NW;
  static constexpr int BQ = 16 * NW;
  static constexpr int MINB = DP <= 128 ? 2 : 1;
  static constexpr int LD8 = DP + 16;  // bytes per int8 row
  static constexpr int LDV = DP + 8;   // bf16 elements per dequantized V row
  // Shared memory, in bytes: the Q tile, the int8 K and V tiles, the
  // dequantized bf16 V tiles, the K and V scales. Each part a multiple of 16.
  static constexpr int Q = 0;
  static constexpr int K = Q + BQ * LD8;            // [3][BK][LD8]
  static constexpr int V = K + 3 * BK * LD8;        // [3][BK][LD8]
  static constexpr int VB = V + 3 * BK * LD8;       // [2][BK][LDV] bf16
  static constexpr int KS = VB + 2 * BK * LDV * 2;  // [3][BK] fp32
  static constexpr int VS = KS + 3 * BK * 4;        // [3][BK] fp32
  static constexpr int BYTES = VS + 3 * BK * 4;
  // The variants' per-key rows: corr, K's zero points and row sums, V's
  // zero points.
  static constexpr int CR = BYTES;                  // [3][BK] fp32 each
  static constexpr int KZ = CR + 3 * BK * 4;
  static constexpr int KR = KZ + 3 * BK * 4;
  static constexpr int VZ = KR + 3 * BK * 4;
  static constexpr int BYTES_VAR = VZ + 3 * BK * 4;
  // pv_int8: the dequantized tiles' bytes hold the two transposed V code
  // tiles [2][DP][LDT] that the integer P·V reads.
  static constexpr int LDT = BK + 16;
  static_assert(2 * DP * LDT <= 2 * BK * LDV * 2, "the code tiles fit in the bf16 V tiles");
};

// Rows [r0, r0 + R) of an int8 (n, D) matrix into a tile of row stride
// DP + 16 bytes by cp.async from NTH threads (the caller commits); rows
// past n and columns past D are zero-filled. vec: 16-byte copies, else
// 4-byte ones.
template <int DP, int R, int NTH>
__device__ __forceinline__ void copy_tile(int8_t* dst, const int8_t* src, int r0, int n, int D,
                                          bool vec) {
  constexpr int LD = DP + 16;
  if (vec) {
    constexpr int CH = DP / 16;
    static_assert(R * CH % NTH == 0, "whole sweeps");
#pragma unroll
    for (int it = 0; it < R * CH / NTH; ++it) {
      const int e = threadIdx.x + it * NTH, r = e / CH, c = (e % CH) * 16;
      const bool ok = r0 + r < n && c < D;
      cp_async16(dst + r * LD + c, ok ? src + (long long)(r0 + r) * D + c : src, ok ? 16 : 0);
    }
  } else {
    constexpr int CW = DP / 4;
    static_assert(R * CW % NTH == 0, "whole sweeps");
#pragma unroll 4
    for (int it = 0; it < R * CW / NTH; ++it) {
      const int e = threadIdx.x + it * NTH, r = e / CW, c = (e % CW) * 4;
      const bool ok = r0 + r < n && c < D;
      cp_async4(dst + r * LD + c, ok ? src + (long long)(r0 + r) * D + c : src, ok ? 4 : 0);
    }
  }
}

// The same rows of a packed INT4 (n, D / 2) matrix, unpacked into int8
// codes (split halves: byte j holds element j, low nibble, and j + D / 2)
// by plain loads and stores, a 4-byte word of packed codes a thread: its
// low nibbles are columns 4w..4w+3, its high ones D/2 + 4w..; each nibble
// sign-extended to a byte by a byte-wise subtract (__vsub4). D % 8 == 0 and
// src 4-byte aligned; rows past n and columns past D are zero.
template <int DP, int R, int NTH>
__device__ __forceinline__ void unpack_tile(int8_t* dst, const int8_t* src, int r0, int n,
                                            int D) {
  constexpr int LD = DP + 16, WR = DP / 8;  // at most DP / 8 packed words a row
  const int h = D / 2, hw = h / 4;
  for (int e = threadIdx.x; e < R * WR; e += NTH) {
    const int r = e / WR, w = e - r * WR;
    if (w >= hw) continue;
    uint32_t pk = 0;
    if (r0 + r < n) pk = *reinterpret_cast<const uint32_t*>(src + (long long)(r0 + r) * h + 4 * w);
    const uint32_t lo = __vsub4((pk & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
    const uint32_t hi = __vsub4(((pk >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
    *reinterpret_cast<uint32_t*>(dst + r * LD + 4 * w) = lo;
    *reinterpret_cast<uint32_t*>(dst + r * LD + h + 4 * w) = hi;
  }
  const int zw = (DP - D) / 4;  // zero words past D
  for (int e = threadIdx.x; e < R * zw; e += NTH) {
    const int r = e / zw;
    *reinterpret_cast<uint32_t*>(dst + r * LD + D + 4 * (e - r * zw)) = 0u;
  }
}

// VAR 0: symmetric INT8, two blocks an SM at D <= 128. VAR 1: INT4 operands
// and the corr row; VAR 2: ASYMMETRIC (INT4 and corr too). The variants
// are their own instantiations, so the symmetric INT8 kernel compiles none
// of their code. They keep two blocks an SM at D 64 (under its 128
// registers they spill 24 and 64 bytes a thread, and ran 3.5 and 4.2 ms at
// the training shape against 5.1 and 4.9 with one block) and one at D 128
// (two spilled 184 and 328 bytes).
template <int DP, int VAR, bool SPARSE, bool PV = false>
__global__ void __launch_bounds__(Cfg<DP>::NTH, VAR ? (DP <= 64 ? 2 : 1) : Cfg<DP>::MINB)
    quant_attn_fwd_tc_kernel(const QParams p) {
  using L = Cfg<DP>;
  constexpr int NTH = L::NTH, BQ_ = L::BQ;
  constexpr int LDW = L::LD8 / 2;   // int8 row stride in 16-bit words
  constexpr int KS = DP / 32;       // 32-deep steps of QKᵀ
  constexpr int NA = DP / 8;        // 8-column accumulator tiles of out
  constexpr bool QREG = DP <= 128;  // Q's A fragments held in registers
  constexpr bool ASYM = VAR == 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* sQ = reinterpret_cast<int8_t*>(smem_raw + L::Q);
  int8_t* sK = reinterpret_cast<int8_t*>(smem_raw + L::K);
  int8_t* sV = reinterpret_cast<int8_t*>(smem_raw + L::V);
  __nv_bfloat16* sVb = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::VB);
  uint8_t* sVT = reinterpret_cast<uint8_t*>(smem_raw + L::VB);  // PV: the transposed codes
  float* sKs = reinterpret_cast<float*>(smem_raw + L::KS);
  float* sVs = reinterpret_cast<float*>(smem_raw + L::VS);
  // The variants' per-key rows: corr, K's zero points and row sums, V's
  // zero points.
  float* sCr = reinterpret_cast<float*>(smem_raw + L::CR);
  float* sKz = reinterpret_cast<float*>(smem_raw + L::KZ);
  float* sKr = reinterpret_cast<float*>(smem_raw + L::KR);
  float* sVz = reinterpret_cast<float*>(smem_raw + L::VZ);
  const __nv_bfloat16* wQ = reinterpret_cast<const __nv_bfloat16*>(sQ);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ_, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const bool q4 = VAR && p.q4, k4 = VAR && p.k4, v4 = VAR && p.v4;
  const int8_t* q = p.q + ((long long)b * p.Hq + h) * p.Sq * (q4 ? p.D / 2 : p.D);
  const int8_t* k = p.k + ((long long)b * p.Hkv + hk) * p.Sk * (k4 ? p.D / 2 : p.D);
  const int8_t* v = p.v + ((long long)b * p.Hkv + hk) * p.Sk * (v4 ? p.D / 2 : p.D);
  const float* qs = p.qs + ((long long)b * p.Hq + h) * (p.qs_rows ? p.Sq : 1);
  const float* ks = p.ks + ((long long)b * p.Hkv + hk) * (p.ks_rows ? p.Sk : 1);
  const float* vs = p.vs + ((long long)b * p.Hkv + hk) * (p.vs_rows ? p.Sk : 1);
  const float* bias = p.bias ? p.bias + b * p.bsb + h * p.bsh : nullptr;
  const bool has_corr = VAR && p.corr;
  const float* corr = has_corr ? p.corr + ((long long)b * p.Hq + h) * p.Sk : nullptr;
  const long long kvh = (long long)b * p.Hkv + hk;
  const float* kz = ASYM ? p.kz + kvh * (p.ks_rows ? p.Sk : 1) : nullptr;
  const float* kr = ASYM ? p.kr + kvh * p.Sk : nullptr;
  const float* vz = ASYM ? p.vz + kvh * (p.vs_rows ? p.Sk : 1) : nullptr;

  int k_lo, k_hi;
  visible_keys(q0, min(q0 + BQ_, p.Sq) - 1, p.Sk, p.left, p.right, &k_lo, &k_hi);
  const int t_lo = k_lo / BK;
  int n_t = k_hi >= k_lo ? k_hi / BK - t_lo + 1 : 0;
  // SPARSE: the walk from its start, the position of the next tile to copy
  // (w_is) and of the step's tile (w_at); both passes start again at
  // w_start.
  SparseWalk sw;
  WalkPos w_start{0, -1, 0, 0}, w_is, w_at;
  if constexpr (SPARSE) {
    sw = sparse_walk(p.sm, true, b, h, 1, q0, min(q0 + BQ_, p.Sq) - 1, k_lo, k_hi, BK, p.Sk);
    if (n_t > 0) {
      w_start = walk_start(sw);
      n_t = walk_count(sw, w_start);
    }
    w_is = w_at = w_start;
  }
  // Steps [0, n_t) are pass 1 (QKᵀ and the row max, K only), steps
  // [n_t, 2 n_t) pass 2 (P against the final max, P·V), over the same
  // tiles. Step i reads buffer i % 3; tile i + 2 is copied meanwhile.
  const int steps = 2 * n_t;
  auto k0_of = [&](int i) { return (t_lo + (i < n_t ? i : i - n_t)) * BK; };
  auto issue = [&](int i) {  // called once for each i, in order
    if (i < steps) {
      int k0;
      if constexpr (SPARSE) {
        if (i == n_t) w_is = w_start;
        k0 = walk_take(sw, w_is).first;
      } else {
        k0 = k0_of(i);
      }
      const int buf = i % 3;
      const bool with_v = i >= n_t;
      if constexpr (VAR == 0) {
        copy_tile<DP, BK, NTH>(sK + buf * BK * L::LD8, k, k0, p.Sk, p.D, p.vec);
        if (with_v) copy_tile<DP, BK, NTH>(sV + buf * BK * L::LD8, v, k0, p.Sk, p.D, p.vec);
        if (tid < BK)
          copy_scale(sKs + buf * BK, ks, p.ks_rows, k0, tid, p.Sk);
        else if (with_v && tid < 2 * BK)
          copy_scale(sVs + buf * BK, vs, p.vs_rows, k0, tid - BK, p.Sk);
      } else {
        if (k4)
          unpack_tile<DP, BK, NTH>(sK + buf * BK * L::LD8, k, k0, p.Sk, p.D);
        else
          copy_tile<DP, BK, NTH>(sK + buf * BK * L::LD8, k, k0, p.Sk, p.D, p.vec);
        if (with_v && v4)
          unpack_tile<DP, BK, NTH>(sV + buf * BK * L::LD8, v, k0, p.Sk, p.D);
        else if (with_v)
          copy_tile<DP, BK, NTH>(sV + buf * BK * L::LD8, v, k0, p.Sk, p.D, p.vec);
        // The per-key rows of the tile, BK threads each.
        for (int e = tid; e < (ASYM ? 6 : 3) * BK; e += NTH) {
          const int j = e % BK, o = buf * BK;
          switch (e / BK) {
            case 0: copy_scale(sKs + o, ks, p.ks_rows, k0, j, p.Sk); break;
            case 1: if (with_v) copy_scale(sVs + o, vs, p.vs_rows, k0, j, p.Sk); break;
            case 2: if (has_corr) copy_scale(sCr + o, corr, 1, k0, j, p.Sk); break;
            case 3: copy_scale(sKz + o, kz, p.ks_rows, k0, j, p.Sk); break;
            case 4: copy_scale(sKr + o, kr, 1, k0, j, p.Sk); break;
            default: if (with_v) copy_scale(sVz + o, vz, p.vs_rows, k0, j, p.Sk);
          }
        }
      }
    }
    cp_async_commit();  // empty groups keep the count of groups uniform
  };
  if (steps > 0) {  // lands with tile 0
    if (q4)
      unpack_tile<DP, BQ_, NTH>(sQ, q, q0, p.Sq, p.D);
    else
      copy_tile<DP, BQ_, NTH>(sQ, q, q0, p.Sq, p.D, p.vec);
  }
  issue(0);
  issue(1);

  // The V tile of step i, bf16(bf16(v) · bf16(vs)) (asymmetric: bf16(v),
  // the scale goes on P), into dequantized buffer i & 1: four codes a
  // thread a row, the same column of each row.
  auto dequant = [&](int i) {
    constexpr int W = DP / 4;
    static_assert(BK * W % NTH == 0, "whole sweeps");
    const int8_t* cV = sV + (i % 3) * BK * L::LD8;
    const float* cVs = sVs + (i % 3) * BK;
    __nv_bfloat16* dst = sVb + (i & 1) * BK * L::LDV;
#pragma unroll
    for (int it = 0; it < BK * W / NTH; ++it) {
      const int e = tid + it * NTH, r = e / W, c = (e % W) * 4;
      const char4 x = *reinterpret_cast<const char4*>(cV + r * L::LD8 + c);
      const float sc = ASYM ? 1.f : round_bf16(cVs[r]);
      uint2 y;
      y.x = pack_bf16x2(__fmul_rn((float)x.x, sc), __fmul_rn((float)x.y, sc));
      y.y = pack_bf16x2(__fmul_rn((float)x.z, sc), __fmul_rn((float)x.w, sc));
      *reinterpret_cast<uint2*>(dst + r * L::LDV + c) = y;
    }
  };

  const int rw = warp * 16;                       // the warp's first row in the tile
  const int row0 = q0 + rw + g, row1 = row0 + 8;  // this thread's two rows
  const float qsc[2] = {row0 < p.Sq ? qs[p.qs_rows ? row0 : 0] : 0.f,
                        row1 < p.Sq ? qs[p.qs_rows ? row1 : 0] : 0.f};
  // Asymmetric: Q's zero points and row sums of the thread's two rows, and
  // D·zq.
  float qzr[2] = {0.f, 0.f}, qrs[2] = {0.f, 0.f}, dzq[2] = {0.f, 0.f};
  if constexpr (ASYM) {
    const float* qz = p.qz + ((long long)b * p.Hq + h) * (p.qs_rows ? p.Sq : 1);
    const float* qr = p.qr + ((long long)b * p.Hq + h) * p.Sq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = i ? row1 : row0;
      if (row < p.Sq) {
        qzr[i] = qz[p.qs_rows ? row : 0];
        qrs[i] = qr[row];
        dzq[i] = __fmul_rn(p.dz, qzr[i]);
      }
    }
  }
  uint32_t qf[QREG ? KS : 1][4];

  // This thread's scores of keys k0 + 16 c + [0, 16) of the K tile wK:
  // s = fl(fl(dot · q_scale) · k_scale), + bias tb, index-masked to
  // MASK_VALUE (keys at or past kend hidden, and SPARSE, where the block
  // straddles map tiles, each element's own tile); element (jj, e) is row
  // e < 2 ? row0 : row1, key k0 + 16 c + 8 jj + 2 tq + (e & 1). With `edge`
  // (the tile crosses a mask edge or carries a bias) returns the bits
  // 4 jj + e of the visible. The variants take the dot less the zero-point
  // terms (in the reference's order) and add the corr row after the scales.
  int kend = 0;                // SPARSE: the step's key limit and bias (set in the loop)
  const float* tb = nullptr;
  auto chunk = [&](const int8_t* cK, const float* cKs, int k0, int c, bool edge,
                   float (&s)[2][4]) -> unsigned {
    const __nv_bfloat16* wK = reinterpret_cast<const __nv_bfloat16*>(cK);
    int si[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
    for (int kc = 0; kc < KS; ++kc) {
      uint32_t a[4];
      if (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[QREG ? kc : 0][e];
      } else {
        load_a(a, wQ, LDW, rw, kc * 16, lane);
      }
      uint32_t b0[2], b1[2];
      load_b_nk(b0, b1, wK, LDW, c * 16, kc * 16, lane);
      mma_s8(si[0], a, b0);
      mma_s8(si[1], a, b1);
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const float2 kq = *reinterpret_cast<const float2*>(cKs + 16 * c + 8 * jj + 2 * tq);
      if constexpr (VAR == 0) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[jj][e] = __fmul_rn(__fmul_rn((float)si[jj][e], qsc[e >> 1]), e & 1 ? kq.y : kq.x);
      } else {
        const int o = (cKs - sKs) + 16 * c + 8 * jj + 2 * tq;  // the tile's per-key rows
        float2 kzv = make_float2(0.f, 0.f), krv = kzv, crv = kzv;
        if constexpr (ASYM) {
          kzv = *reinterpret_cast<const float2*>(sKz + o);
          krv = *reinterpret_cast<const float2*>(sKr + o);
        }
        if (has_corr) crv = *reinterpret_cast<const float2*>(sCr + o);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = (float)si[jj][e];
          if constexpr (ASYM) {
            const float zk = e & 1 ? kzv.y : kzv.x;
            x = __fsub_rn(x, __fmul_rn(qzr[e >> 1], e & 1 ? krv.y : krv.x));
            x = __fsub_rn(x, __fmul_rn(zk, qrs[e >> 1]));
            x = __fadd_rn(x, __fmul_rn(dzq[e >> 1], zk));
          }
          s[jj][e] = __fmul_rn(__fmul_rn(x, qsc[e >> 1]), e & 1 ? kq.y : kq.x);
          if (has_corr) s[jj][e] = __fadd_rn(s[jj][e], e & 1 ? crv.y : crv.x);
        }
      }
    }
    unsigned vis = 0xffu;
    if (edge) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? row0 : row1, col = k0 + 16 * c + 8 * jj + 2 * tq + (e & 1);
          if (key_visible(row, col, p.Sq, SPARSE ? kend : p.Sk, p.left, p.right) &&
              (!SPARSE || sw.fetch || walk_has(sw, 0, row, col))) {
            const float* bb = SPARSE ? tb : bias;
            if (bb) s[jj][e] = __fadd_rn(s[jj][e], bb[row * p.bsq + col * p.bsk]);
          } else {
            s[jj][e] = MASK_VALUE;
            vis &= ~(1u << (4 * jj + e));
          }
        }
    }
    return vis;
  };

  float m[2] = {MASK_VALUE, MASK_VALUE}, l[2] = {0.f, 0.f};
  float zsum[2] = {0.f, 0.f};  // asymmetric: Σ P·v_scale·zv of the two rows
  float acc[NA][4];
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < steps; ++i) {
    // The next pass-2 step's V is dequantized a step ahead (one barrier a
    // step), so then tile i + 1 must have landed too; else only tile i.
    const bool deq = i + 1 >= n_t && i + 1 < steps;
    if (deq)
      cp_async_wait<0>();
    else
      cp_async_wait<1>();
    __syncthreads();  // those tiles landed; every warp is done with step i - 1
    issue(i + 2);     // into the buffer step i - 1 read
    if (QREG && i == 0) {
#pragma unroll
      for (int kc = 0; kc < (QREG ? KS : 1); ++kc) load_a(qf[kc], wQ, LDW, rw, kc * 16, lane);
    }
    if (deq) {
      if constexpr (PV)
        transpose_codes<DP, NTH, BK>(sVT + ((i + 1) & 1) * DP * L::LDT,
                                     sV + ((i + 1) % 3) * BK * L::LD8);
      else
        dequant(i + 1);
    }
    if (i == n_t) {
      m[0] = quad_max(m[0]);
      m[1] = quad_max(m[1]);
    }

    // The step's first key; SPARSE: its key limit (keys at or past it are
    // hidden) and its bias (none read on a FULL tile).
    int k0;
    if constexpr (SPARSE) {
      if (i == n_t) w_at = w_start;
      const WalkTile t = walk_take(sw, w_at);
      k0 = t.first;
      kend = t.end;
      tb = t.full ? nullptr : bias;
    } else {
      k0 = k0_of(i);
    }
    // Rows rw..rw+15 of the tile against keys k0..k0+63: none visible, all
    // visible (and all rows real), or an edge.
    const int r_lo = q0 + rw, r_hi = r_lo + 15;
    const bool none = k0 >= (SPARSE ? kend : p.Sk) || (p.right >= 0 && k0 > r_hi + p.right) ||
                      (p.left >= 0 && k0 + BK - 1 < r_lo - p.left);
    if (none) continue;
    const bool all = k0 + BK <= (SPARSE ? kend : p.Sk) && r_hi < p.Sq &&
                     (p.right < 0 || k0 + BK - 1 <= r_lo + p.right) &&
                     (p.left < 0 || k0 >= r_hi - p.left) && (!SPARSE || sw.fetch != nullptr);
    const bool edge = !all || (SPARSE ? tb : bias);
    const int8_t* cK = sK + (i % 3) * BK * L::LD8;
    const float* cKs = sKs + (i % 3) * BK;
    if (i < n_t) {
      // Pass 1: the exact row max over every visible key, QKᵀ alone.
#pragma unroll
      for (int c = 0; c < BK / 16; ++c) {
        float s[2][4];
        chunk(cK, cKs, k0, c, edge, s);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          m[0] = fmaxf(m[0], fmaxf(s[jj][0], s[jj][1]));
          m[1] = fmaxf(m[1], fmaxf(s[jj][2], s[jj][3]));
        }
      }
    } else if constexpr (PV) {
      // Pass 2, integer P·V: the codes rint(127·P) of two 16-key chunks
      // are the u8 A fragment of a 32-deep step, the V codes its s8 B
      // fragments; l sums the fp32 P.
      const uint8_t* cT = sVT + (i & 1) * DP * L::LDT + 4 * tq;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        float sc[2][2][4];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const unsigned vis = chunk(cK, cKs, k0, 2 * u + h2, edge, sc[h2]);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sc[h2][jj][e] = !edge || ((vis >> (4 * jj + e)) & 1u)
                                  ? expf(sc[h2][jj][e] - m[e >> 1])
                                  : 0.f;
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            l[0] += sc[h2][jj][0] + sc[h2][jj][1];
            l[1] += sc[h2][jj][2] + sc[h2][jj][3];
          }
        }
        uint32_t a[4];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            uint32_t w = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j)  // byte j: key 2 tq + (j & 1) + 8 (j >> 1)
              w |= (uint32_t)(int)rintf(__fmul_rn(sc[h2][j >> 1][2 * r + (j & 1)], 127.f))
                   << (8 * j);
            a[2 * h2 + r] = w;
          }
        // V's scale, one over the step (the host's groups are 32-aligned).
        const float wv = __fmul_rn(sVs[(i % 3) * BK + 32 * u], PV_SCALE);
#pragma unroll
        for (int n = 0; n < NA; ++n) {
          const uint8_t* bp = cT + (8 * n + g) * L::LDT + 32 * u;
          const uint32_t bf[2] = {*reinterpret_cast<const uint32_t*>(bp),
                                  *reinterpret_cast<const uint32_t*>(bp + 16)};
          int ic[4] = {0, 0, 0, 0};
          mma_u8s8(ic, a, bf);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = fmaf((float)ic[e], wv, acc[n][e]);
        }
      }
    } else {
      // Pass 2: P = expf(s - m) against the final max; l sums the fp32 P,
      // P·V takes bf16(P) and the dequantized V tile (asymmetric:
      // bf16(P·v_scale) and the V codes, the zero points summed aside).
      const __nv_bfloat16* cVb = sVb + (i & 1) * BK * L::LDV;
#pragma unroll
      for (int c = 0; c < BK / 16; ++c) {
        float s[2][4];
        const unsigned vis = chunk(cK, cKs, k0, c, edge, s);
        if (edge) {
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[jj][e] = (vis >> (4 * jj + e)) & 1u ? expf(s[jj][e] - m[e >> 1]) : 0.f;
        } else {
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[jj][e] = expf(s[jj][e] - m[e >> 1]);
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          l[0] += s[jj][0] + s[jj][1];
          l[1] += s[jj][2] + s[jj][3];
        }
        if constexpr (ASYM) {
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int kc = (i % 3) * BK + 16 * c + 8 * jj + 2 * tq;
            const float2 sv = *reinterpret_cast<const float2*>(sVs + kc);
            const float2 zv = *reinterpret_cast<const float2*>(sVz + kc);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s[jj][e] = __fmul_rn(s[jj][e], e & 1 ? sv.y : sv.x);
              zsum[e >> 1] += __fmul_rn(s[jj][e], e & 1 ? zv.y : zv.x);
            }
          }
        }
        uint32_t a[4];
        pack_a(a, s[0], s[1]);
#pragma unroll
        for (int dn = 0; dn < DP / 16; ++dn) {
          uint32_t b0[2], b1[2];
          load_b_kn(b0, b1, cVb, L::LDV, c * 16, dn * 16, lane);
          mma_bf16(acc[2 * dn], a, b0);
          mma_bf16(acc[2 * dn + 1], a, b1);
        }
      }
    }
  }

  float* out = p.out + ((long long)b * p.Hq + h) * p.Sq * p.D;
  float* lse = p.lse + ((long long)b * p.Hq + h) * p.Sq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i ? row1 : row0;
    const float lsum = quad_sum(l[i]);
    if constexpr (ASYM) {
      const float zs = quad_sum(zsum[i]);
#pragma unroll
      for (int n = 0; n < NA; ++n) {
        acc[n][2 * i] = __fsub_rn(acc[n][2 * i], zs);
        acc[n][2 * i + 1] = __fsub_rn(acc[n][2 * i + 1], zs);
      }
    }
    if (row >= p.Sq) continue;
    const bool empty = lsum == 0.f;
    const float l_safe = empty ? 1.f : lsum;
#pragma unroll
    for (int n = 0; n < NA; ++n) {
      const int col = 8 * n + 2 * tq;  // D % 4 == 0: col < D means col + 1 < D
      if (col < p.D)
        *reinterpret_cast<float2*>(out + (long long)row * p.D + col) =
            make_float2(acc[n][2 * i] / l_safe, acc[n][2 * i + 1] / l_safe);
    }
    if (tq == 0) lse[row] = empty ? MASK_VALUE : m[i] + logf(l_safe);
  }
}

template <int DP, int VAR, bool SPARSE, bool PV = false>
cudaError_t launch_var(const QParams& p, cudaStream_t stream) {
  constexpr int smem = VAR ? Cfg<DP>::BYTES_VAR : Cfg<DP>::BYTES;
  const auto kernel = quant_attn_fwd_tc_kernel<DP, VAR, SPARSE, PV>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  constexpr int bq = Cfg<DP>::BQ, nth = Cfg<DP>::NTH;
  const dim3 grid((p.Sq + bq - 1) / bq, p.Hq, p.B);
  kernel<<<grid, nth, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP, bool SPARSE>
cudaError_t launch_walk(const QParams& p, cudaStream_t stream) {
  if (p.pv)  // symmetric only (the entry checks)
    return p.q4 || p.k4 || p.v4 || p.corr ? launch_var<DP, 1, SPARSE, true>(p, stream)
                                          : launch_var<DP, 0, SPARSE, true>(p, stream);
  if (p.kz) return launch_var<DP, 2, SPARSE>(p, stream);
  if (p.q4 || p.k4 || p.v4 || p.corr) return launch_var<DP, 1, SPARSE>(p, stream);
  return launch_var<DP, 0, SPARSE>(p, stream);
}

template <int DP>
cudaError_t launch(const QParams& p, cudaStream_t stream) {
  return p.sm.map ? launch_walk<DP, true>(p, stream) : launch_walk<DP, false>(p, stream);
}

bool takes(int D) { return D >= 4 && D <= 256 && D % 4 == 0; }

}  // namespace

// q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D): contiguous int8, D <= 256 and
// D % 4 == 0, 4-byte aligned; an operand flagged INT4 (int4 bit 1 Q, 2 K,
// 4 V) is (…, D / 2) packed split-halves, D % 8 == 0. Scales contiguous float32. corr
// (B, Hq, Sk) float32 or null. Asymmetric: qz, kz, vz zero points laid out
// as the scales and qr (B, Hq, Sq), kr (B, Hkv, Sk) row sums, all float32
// (or all null); dz the head dim of the zero-point term. out (B, Hq, Sq, D)
// and lse (B, Hq, Sq) float32. map (null: no walk): the block-sparse map
// (Bm, Hm, nq, nk) int32 of block_q x block_k tiles and fetch, its
// compacted key-tile table fetch_kv (Bm, Hm, nq, width), with the element
// strides of their batch and head (0 = broadcast). pv (symmetric only): the
// integer P·V, V's scale constant over every 32-key step of the walk.
// Returns the cudaError_t of the launch.
extern "C" int umfa_quant_attn_fwd(const void* q, const void* k, const void* v, const void* qs,
                                   const void* ks, const void* vs, const void* bias,
                                   const void* corr, const void* qz, const void* qr,
                                   const void* kz, const void* kr, const void* vz, void* out,
                                   void* lse, int B, int Hq, int Hkv, int Sq, int Sk, int D,
                                   int qs_rows, int ks_rows, int vs_rows, long long bsb,
                                   long long bsh, long long bsq, long long bsk, int left,
                                   int right, int int4, int dz, const void* map,
                                   const void* fetch, int block_q, int block_k, int nq, int nk,
                                   int width, long long msb, long long msh, long long fsb,
                                   long long fsh, int pv, void* stream) {
  const bool asym = qz || qr || kz || kr || vz;
  SparseMap sm;
  if (!takes(D) || Hkv < 1 || Hq % Hkv != 0 || int4 < 0 || int4 > 7 || (int4 && D % 8) ||
      (asym && !(qz && qr && kz && kr && vz)) || (pv && asym) ||
      !sparse_map(&sm, map, fetch, block_q, block_k, nq, nk, width, msb, msh, fsb, fsh))
    return cudaErrorInvalidValue;
  const int vec = D % 16 == 0 && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                                   reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const QParams p{static_cast<const int8_t*>(q),
                  static_cast<const int8_t*>(k),
                  static_cast<const int8_t*>(v),
                  static_cast<const float*>(qs),
                  static_cast<const float*>(ks),
                  static_cast<const float*>(vs),
                  static_cast<const float*>(bias),
                  static_cast<const float*>(corr),
                  static_cast<const float*>(qz),
                  static_cast<const float*>(qr),
                  static_cast<const float*>(kz),
                  static_cast<const float*>(kr),
                  static_cast<const float*>(vz),
                  static_cast<float*>(out),
                  static_cast<float*>(lse),
                  B, Hq, Hkv, Sq, Sk, D,
                  qs_rows, ks_rows, vs_rows,
                  bsb, bsh, bsq, bsk,
                  left, right, vec, int4 & 1, (int4 >> 1) & 1, (int4 >> 2) & 1, (float)dz, sm, pv};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64) return launch<64>(p, st);
  if (D <= 128) return launch<128>(p, st);
  return launch<256>(p, st);
}

// Dynamic shared memory of the kernel that umfa_quant_attn_fwd launches for
// head dim D, in bytes (0 if it does not take D).
extern "C" int umfa_quant_attn_fwd_smem_bytes(int D) {
  if (!takes(D)) return 0;
  return D <= 64 ? Cfg<64>::BYTES : D <= 128 ? Cfg<128>::BYTES : Cfg<256>::BYTES;
}
