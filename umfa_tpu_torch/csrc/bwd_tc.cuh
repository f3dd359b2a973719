// Tensor-core bodies of the attention backward for Hopper, sm_90a: dK/dV
// (`dkv_tc_kernel`) and dQ (`dq_tc_kernel`).
//
// Each body takes its load stage and its product policy as template
// parameters. The stage copies a tile's raw operands into a staging buffer
// (cp.async, two steps ahead) and turns them into the tiles the products
// read (one step ahead), so one barrier a step orders everything.
// `csrc/quant_bwd.cu` gives both bodies stages that dequantize int8/int4
// codes into converted bf16 tiles (two staging buffers); `csrc/flash_bwd.cu`
// gives both stages that copy bf16 or fp32 rows straight into padded tiles,
// which the products read where they landed (three staging buffers: one
// being read, one landing, one being filled). The policy is `Bf16Mma`
// (bf16 tiles, mma.sync m16n8k16 bf16 -> fp32) or `Tf32x3Mma` (fp32 tiles,
// every product as three mma.sync m16n8k8 tf32 -> fp32 on split operands),
// from mma_policy.cuh, which the forward body (fwd_tc.cuh) shares. The
// arithmetic the bodies hold to (the reference's rounding points) is in
// each including file's header.
//
// Both keep one owner per output tile, no atomics, and a deterministic
// result: the dK/dV block sums its GQA group in registers, the dQ block
// walks its key tiles in order.
//
// RING (a template parameter, so the other instantiations compile as
// without it): one rank's ring step (`csrc/ring_attn.cu`). What the step
// sees is the band mask (left, right) plus two limits, query rows below
// q_lo and keys at or past k_hi hidden; the fp32 gradients fold into the
// buffers they are stored to, written at the rank's first step and added
// to (the old value plus scale times the sum, each rounded once) after it.
// A block that sees nothing after the first step returns without a store.
//
// SPARSE (a template parameter as RING is; the dense stages of
// bwd_dense.cuh and the quantized ones of quant_bwd.cu take it): the walks
// restricted to a block-sparse map (common.cuh `SparseWalk`). The dQ block
// walks the compacted key row of its map query tile in order
// (deterministic, as the dense walk); the dK/dV block walks, for each
// query head of its GQA group in turn, that head's own compacted query row
// (a per-head map gives each head its own), the group still summed in
// registers by one owner. A head's per-head work (the corr row read at its
// first tile, the Q-mean term added at its last) runs at the walk's own
// head boundaries, and not at all for a head that walks no tile of the
// block. Indices past a map tile's end are hidden like the tails; the bias
// is read only on tiles that are not FULL for the block; a block that
// straddles map tiles looks up each element's own tile.
#pragma once

#include <initializer_list>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"
#include "mma_policy.cuh"

namespace umfa {

// The arguments of the backward kernels (dense and quantized). Dense
// kernels read q, k, v and dout in the input type and leave the
// quantized-only fields null or 0.
struct BwdParams {
  const void* q;  // dense: (B, Hq, Sq, D); quantized: int8 codes (D, or D/2 packed INT4)
  const void* k;  // (B, Hkv, Sk, D | D/2)
  const void* v;
  const float* qs;  // quantized: scales (B, H, S | 1), Q's with the softmax scale folded in
  const float* ks;
  const float* vs;
  const void* dout;
  const float* lse;
  const float* delta;
  const float* qm;    // quantized: (B, Hq, D) or null
  const float* vm;    // quantized: (B, Hkv, D) or null
  const float* corr;  // quantized: (B, Hq, Sk), times scale, or null
  const float* bias;
  void* out0;  // dQ, or dK
  void* out1;  // unused, or dV
  int B, Hq, Hkv, Sq, Sk, D;
  int qs_rows, ks_rows, vs_rows;
  long long bsb, bsh, bsq, bsk;
  float scale;
  int left, right;
  int int4;  // bit 0: Q, bit 1: K, bit 2: V
  int wide;  // set by the launcher: rows of q, k, v, dout (and vm) may be read from
             // global memory by vector loads (D and the pointers' alignment allow it)
  // Read only by the RING instantiations: query rows below q_lo and keys at
  // or past k_hi are hidden; first: store the step's gradients, else add them.
  int q_lo, k_hi, first;
  SparseMap sm;  // read only by the SPARSE instantiations: the map and fetch_kv (dQ) or fetch_q (dK/dV)
};

// Whether every pointer is a multiple of `bytes` (null counts as aligned):
// the launchers' test for cp.async and vector loads.
inline bool aligned(std::initializer_list<const void*> ptrs, uintptr_t bytes) {
  uintptr_t bits = 0;
  for (const void* q : ptrs) bits |= reinterpret_cast<uintptr_t>(q);
  return bits % bytes == 0;
}

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

// Four consecutive values as fp32 (16-byte aligned fp32, 8-byte aligned bf16).
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

// Four values as bf16 pairs at dst (8-byte aligned), each rounded once.
__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float (&x)[4]) {
  uint2 w;
  w.x = pack_bf16x2(x[0], x[1]);
  w.y = pack_bf16x2(x[2], x[3]);
  *reinterpret_cast<uint2*>(dst) = w;
}

// Four fp32 values at dst (16-byte aligned).
__device__ __forceinline__ void store4(float* dst, const float (&x)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
}

// out[i] = x (Elem<Tout>'s rounding); under RING (fp32 out) after the first
// step out[i] + x, rounded once: the fold of a ring step into its buffer.
template <bool RING, typename Tout>
__device__ __forceinline__ void store_grad(Tout* out, long long i, float x, int first) {
  if constexpr (RING) {
    static_assert(std::is_same<Tout, float>::value, "a ring step folds into fp32 buffers");
    out[i] = first ? x : __fadd_rn(out[i], x);
  } else {
    Elem<Tout>::store(out, i, x);
  }
}

// A bf16 pair (lower index in the low half) times s, each value rounded to
// bf16 once: the reference's bf16(q·scale), on a register of a tile or of
// an A fragment.
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t w, float s) {
  return pack_bf16x2(__fmul_rn(__uint_as_float(w << 16), s),
                     __fmul_rn(__uint_as_float(w & 0xffff0000u), s));
}

// Rows [0, ROWS) and columns [c0, c0 + W) of a bf16 or fp32 matrix with
// rows of D elements (src: its first row) into a tile of row stride LD;
// rows at or past n and columns at or past D are 0. vec (D and c0
// multiples of 16 bytes' worth of elements, src 16-byte aligned): by
// 16-byte cp.async with zero fill, else by plain loads and stores. n >= 1.
template <int ROWS, int W, int LD, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int n, int D, int c0, bool vec) {
  constexpr int E = 16 / (int)sizeof(T);  // elements a 16-byte piece
  constexpr int CH = W / E;               // 16-byte pieces a row
  for (int e = threadIdx.x; e < ROWS * CH; e += blockDim.x) {
    const int r = e / CH, c = (e - r * CH) * E;
    T* d = dst + r * LD + c;
    const int col = c0 + c;
    if (vec) {
      const int live = r < n ? max(0, min(E, D - col)) : 0;
      cp_async16(d, live ? src + (long long)r * D + col : src, (int)sizeof(T) * live);
    } else {
#pragma unroll
      for (int i = 0; i < E; ++i)
        d[i] = r < n && col + i < D ? src[(long long)r * D + col + i] : static_cast<T>(0.f);
    }
  }
}

// Rows [0, ROWS) of an fp32 vector (src: its first row) by 4-byte cp.async;
// rows at or past n are 0. n >= 1.
template <int ROWS>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, int n) {
  for (int r = threadIdx.x; r < ROWS; r += blockDim.x)
    cp_async4(dst + r, r < n ? src + r : src, r < n ? 4 : 0);
}

// The fp32 bodies at D 256 (WIDE32) split each product's depth between
// warps: warp w holds the C fragments (s, dp) of its rows over depth slice
// w / STRIDE, and each of the NSLICE warps of a row group adds the group's
// partials in slice order, so all of them hold the same sums (one owner's
// result, computed NSLICE times). part: 2·N·4 floats a thread, stored
// [element][thread]. Every thread of the block calls it (a barrier); `live`
// is false for warps whose rows see nothing this step, as for their whole
// row group.
template <int NSLICE, int STRIDE, int N>
__device__ __forceinline__ void sum_slices(float (&s)[N][4], float (&dp)[N][4], float* part,
                                           bool live) {
  constexpr int NTH = NSLICE * STRIDE * 32;
  const int tid = threadIdx.x, slice = (tid >> 5) / STRIDE;
  const int own = tid - slice * STRIDE * 32;  // the thread of slice 0 with these elements
  if (live) {
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        part[(4 * j + e) * NTH + tid] = s[j][e];
        part[(4 * (N + j) + e) * NTH + tid] = dp[j][e];
      }
  }
  __syncthreads();
  if (!live) return;
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* ps = part + (4 * j + e) * NTH + own;
      const float* pd = part + (4 * (N + j) + e) * NTH + own;
      float x = ps[0], y = pd[0];
#pragma unroll
      for (int c = 1; c < NSLICE; ++c) {
        x = __fadd_rn(x, ps[c * STRIDE * 32]);
        y = __fadd_rn(y, pd[c * STRIDE * 32]);
      }
      s[j][e] = x;
      dp[j][e] = y;
    }
}

// ---- dK/dV ---------------------------------------------------------------
//
// One block of KB/16 · SPLIT warps per (KB-key tile, kv head, batch). Warp
// w owns keys 16(w % (KB/16))..+15 of the tile and columns
// [(w / (KB/16))·DW, +DW) of their dK and dV (DW = DP / SPLIT), in fp32 mma
// accumulators for the whole walk over the GQA group's query heads and
// their visible query tiles (QT rows each). Per query tile, with keys as
// the rows of every product:
//   Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ   (A: K, V; B: Q, dO via ldmatrix)
//   Pᵀ, dSᵀ on the fragments; colsum(dS) in fp32 registers
//   dV += Pᵀ·dO, dK += dSᵀ·Q   (A straight from the Pᵀ and dSᵀ
//   accumulators, bf16-rounded under Bf16Mma; B via ldmatrix.trans, or
//   shared loads under Tf32x3Mma)
// At D 256 one warp's dK and dV (16 keys × 256 columns, two fp32 tiles)
// would take 256 registers a thread, over the limit of 255: SPLIT = 2 puts
// two warps on each key group, each recomputing Sᵀ and dPᵀ and owning half
// the columns (bf16). fp32 (WIDE32): SPLIT = 4 warps on each key group,
// each owning a quarter of the columns and forming Sᵀ and dPᵀ over that
// quarter of the depth alone; `sum_slices` adds the four partials.
//
// Tiles and occupancy as measured best at the training shape (B8 Hq16 Hkv8
// S4096 D64 bf16; 32-query tiles with the K/V fragments from shared memory
// and three blocks an SM beat 64-query tiles, fragments held in registers,
// and two or four blocks an SM). fp32 tiles take twice the bytes: two
// blocks an SM at D 64, one at D 128. fp32 at D 256 (WIDE32): 64 keys of
// K and V alone take 134 KB, and the dense stage's three staging buffers
// of 32-row Q and dO tiles 200 KB more; so 32-key blocks (8 warps: two key
// groups, four depth slices) and 16-row query tiles, with 16 KB for the
// partials: 217,600 bytes. Two key groups with two column halves each,
// both recomputing Sᵀ and dPᵀ over the whole depth, took 138 ms at the
// training shape, slower than the plain version (124 ms).
template <int DP, class Mma = Bf16Mma>
struct DkvTile {
  using T = typename Mma::T;
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr bool WIDE32 = F32 && DP > 128;
  static constexpr int KB = WIDE32 ? 32 : 64;     // keys a block
  static constexpr int QT = WIDE32 ? 16 : 32;     // query rows per tile
  static constexpr int LD = DP + Mma::PAD;       // row stride in shared memory
  static constexpr int SPLIT = WIDE32 ? 4 : DP > 128 ? 2 : 1;  // warps on one key group
  static constexpr int NTHR = KB / 16 * 32 * SPLIT;
  static constexpr int MINB = (F32 ? DP <= 64 ? 2 : 1                   // blocks an SM holds
                                   : DP <= 64 ? 3 : DP <= 128 ? 2 : 1);
  static constexpr int KV_BYTES = 2 * KB * LD * (int)sizeof(T) + DP * 4;  // K, V, vm (fp32)
  static constexpr int PART_BYTES = WIDE32 ? QT * 4 * NTHR : 0;  // 2·(QT/8)·4 floats a thread
};

// The load stage `Load` of dkv_tc_kernel provides:
//   Tile                       the query tile the products read, built from
//       a converted buffer (Tile::BYTES) and a staging buffer: tiles of
//       Mma::T q (the Q operand of Sᵀ), qk (that of dK), o (dO), row stride
//       LD, and per row vt (a term added to dP), lse, delta;
//   NRAW, RAW_BYTES            the staging buffers (2, or 3 when the Tile
//       reads its staging buffer) and their size;
//   HEAD_TERMS                 whether it has per-head terms (the corr row,
//       the Q-mean term), which a walk takes at each head's own boundaries;
//   dk_scale(p)                the factor on dK at the store;
//   stage_kv(sK, sV, sVm, ..)  K, V of the block's KB keys (Mma::T, LD) and vm;
//   issue(raw, p, qbh, q0, vec)  the copies of a query tile's raw operands;
//   stage(raw, t, sVm, p, qbh, q0)  raw -> the converted part of tile t.
template <class Load, class Mma, int DP>
constexpr int dkv_smem_bytes() {
  return DkvTile<DP, Mma>::KV_BYTES + 2 * Load::Tile::BYTES + Load::NRAW * Load::RAW_BYTES +
         DkvTile<DP, Mma>::PART_BYTES;
}

template <class Load, class Mma, typename Tout, int DP, bool RING = false, bool SPARSE = false>
__global__ void __launch_bounds__(DkvTile<DP, Mma>::NTHR, DkvTile<DP, Mma>::MINB)
    dkv_tc_kernel(const BwdParams p, const int vec) {
  using G = DkvTile<DP, Mma>;
  using T = typename Mma::T;
  using Tile = typename Load::Tile;
  constexpr int QT = G::QT, LD = G::LD, KB = G::KB;
  constexpr int KW = KB / 16;          // key groups of 16 a block (a power of two)
  constexpr int NQ = QT / 8;           // 8-query tiles of Sᵀ and dPᵀ
  constexpr int DW = DP / G::SPLIT;    // columns of dK and dV a warp owns
  constexpr int NA = DW / 8;           // their 8-column tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + KB * LD;
  float* sVm = reinterpret_cast<float*>(sV + KB * LD);
  unsigned char* tiles = reinterpret_cast<unsigned char*>(sVm + DP);  // [2][Tile::BYTES]
  unsigned char* raw = tiles + 2 * Tile::BYTES;                       // [NRAW][RAW_BYTES]
  float* part = reinterpret_cast<float*>(raw + Load::NRAW * Load::RAW_BYTES);  // WIDE32
  auto raw_of = [&](int i) { return raw + (i % Load::NRAW) * Load::RAW_BYTES; };
  auto tile_of = [&](int i) { return Tile(tiles + (i & 1) * Tile::BYTES, raw_of(i)); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int kr = (G::SPLIT > 1 ? warp & (KW - 1) : warp) * 16;  // its first key row in the tile
  const int c0 = G::SPLIT > 1 ? (warp >> (KW == 4 ? 2 : 1)) * DW : 0;  // its first column
  const int k0 = blockIdx.x * KB, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.Hq / p.Hkv;
  const long long kbh = (long long)b * p.Hkv + hk;
  const int key0 = k0 + kr + g, key1 = key0 + 8;  // this thread's two key rows

  int q_lo, q_hi;
  visible_queries(k0, min(k0 + KB, p.Sk) - 1, p.Sq, p.left, p.right, &q_lo, &q_hi);
  if constexpr (RING) {
    q_lo = max(q_lo, p.q_lo);
    if (k0 >= p.k_hi) q_hi = -1;
  }
  const int t_lo = q_lo / QT;
  const int n_t = q_hi >= q_lo ? q_hi / QT - t_lo + 1 : 0;
  int total = group * n_t;  // (head, query tile) steps, head-major
  if constexpr (RING) {
    if (n_t == 0 && !p.first) return;  // adds nothing to the buffers
  }
  auto head_of = [&](int i) { return (long long)b * p.Hq + hk * group + i / n_t; };
  auto q0_of = [&](int i) { return (t_lo + i % n_t) * QT; };
  // SPARSE: the walk's position of the next tile to copy, and the tiles of
  // steps i and i + 1 (copied already).
  SparseWalk sw;
  WalkPos w_iss;
  WalkTile ta{}, tb{};
  auto qbh_of = [&](const WalkTile& t) { return (long long)b * p.Hq + hk * group + t.h; };
  if constexpr (SPARSE) {
    sw = sparse_walk(p.sm, false, b, hk * group, group, k0, min(k0 + KB, p.Sk) - 1, q_lo, q_hi,
                     QT, p.Sq);
    total = 0;
    if (n_t > 0) {
      w_iss = walk_start(sw);
      total = walk_count(sw, w_iss);
    }
  }

  // Pipeline: step i's raw operands are copied two steps ahead and
  // converted one step ahead, so one barrier a step orders everything.
  if constexpr (SPARSE) {
    if (total > 0) {
      ta = walk_take(sw, w_iss);
      Load::issue(raw_of(0), p, qbh_of(ta), ta.first, vec);
    }
    cp_async_commit();
    if (total > 1) {
      tb = walk_take(sw, w_iss);
      Load::issue(raw_of(1), p, qbh_of(tb), tb.first, vec);
    }
    cp_async_commit();
  } else {
    if (total > 0) Load::issue(raw_of(0), p, head_of(0), q0_of(0), vec);
    cp_async_commit();
    if (total > 1) Load::issue(raw_of(1), p, head_of(1), q0_of(1), vec);
    cp_async_commit();
  }
  Load::stage_kv(sK, sV, sVm, p, kbh, k0);
  cp_async_wait<1>();
  __syncthreads();
  if (total > 0) {
    if constexpr (SPARSE)
      Load::stage(raw_of(0), tile_of(0), sVm, p, qbh_of(ta), ta.first);
    else
      Load::stage(raw_of(0), tile_of(0), sVm, p, head_of(0), q0_of(0));
  }

  float dk[NA][4], dv[NA][4];
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  float cs[2] = {0.f, 0.f};  // this thread's part of colsum(dS), per key row
  float corr[2] = {0.f, 0.f};
  int h_prev = -1;  // SPARSE: the head of the step before

  for (int i = 0; i < total; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // tile i converted, raw i + 1 landed, step i - 1 done
    WalkTile tw{};  // SPARSE: step i's tile (rows at or past tw.end hidden)
    if constexpr (SPARSE) {
      WalkTile tc{};
      if (i + 2 < total) {
        tc = walk_take(sw, w_iss);
        Load::issue(raw_of(i + 2), p, qbh_of(tc), tc.first, vec);
      }
      cp_async_commit();
      if (i + 1 < total) Load::stage(raw_of(i + 1), tile_of(i + 1), sVm, p, qbh_of(tb), tb.first);
      tw = ta;
      ta = tb;
      tb = tc;
    } else {
      if (i + 2 < total) Load::issue(raw_of(i + 2), p, head_of(i + 2), q0_of(i + 2), vec);
      cp_async_commit();
      if (i + 1 < total)
        Load::stage(raw_of(i + 1), tile_of(i + 1), sVm, p, head_of(i + 1), q0_of(i + 1));
    }

    const long long qbh = SPARSE ? qbh_of(tw) : head_of(i);
    const int q0 = SPARSE ? tw.first : q0_of(i);
    const Tile t = tile_of(i);
    // The head's first and last tile of the walk (SPARSE: where the head
    // changes; ta is step i + 1's tile), for stages with per-head terms.
    constexpr bool HEADS = SPARSE && Load::HEAD_TERMS;
    bool head_first = false, head_last = false;
    if constexpr (HEADS) {
      head_first = tw.h != h_prev;
      head_last = i + 1 == total || ta.h != tw.h;
      h_prev = tw.h;
    }
    if ((SPARSE ? head_first : i % n_t == 0) && p.corr) {
      const float* cr = p.corr + qbh * p.Sk;
      corr[0] = key0 < p.Sk ? cr[key0] : 0.f;
      corr[1] = key1 < p.Sk ? cr[key1] : 0.f;
    }

    // This warp's keys [kw, kw + 15] against queries [q0, q0 + QT).
    const int kw = k0 + kr, qe = q0 + QT - 1;
    const bool none = kw >= p.Sk || q0 >= (SPARSE ? tw.end : p.Sq) ||
                      (p.right >= 0 && kw > qe + p.right) ||
                      (p.left >= 0 && kw + 15 < q0 - p.left) ||
                      (RING && (kw >= p.k_hi || qe < p.q_lo));
    const bool all = kw + 15 < p.Sk && qe < (SPARSE ? tw.end : p.Sq) &&
                     (p.right < 0 || kw + 15 <= q0 + p.right) &&
                     (p.left < 0 || kw >= qe - p.left) &&
                     (!RING || (kw + 15 < p.k_hi && q0 >= p.q_lo)) &&
                     (!SPARSE || sw.fetch != nullptr);
    float s[NQ][4], dp[NQ][4];
    if (!none) {
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      if constexpr (G::WIDE32) {  // over the warp's depth slice, the columns it owns
        Mma::template scores<DW, QT, Mma::QK_CHAIN>(s, dp, sK + c0, sV + c0, t.q + c0, t.o + c0,
                                                    LD, kr, lane);
      } else {
        Mma::template scores<DP, QT>(s, dp, sK, sV, t.q, t.o, LD, kr, lane);
      }
    }
    if constexpr (G::WIDE32) sum_slices<G::SPLIT, KW>(s, dp, part, !none);
    if (!none) {
      // Element (j, e): key e < 2 ? key0 : key1, query q0 + 8j + 2tq + (e & 1).
      // SPARSE: no bias read on a FULL tile.
      const float* bias = p.bias && !(SPARSE && tw.full)
                              ? p.bias + b * p.bsb + (qbh - (long long)b * p.Hq) * p.bsh
                              : nullptr;
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = e < 2 ? key0 : key1, qi = 8 * j + 2 * tq + (e & 1), row = q0 + qi;
          float pr = 0.f, ds = 0.f;
          if (all || ((!RING || row >= p.q_lo) &&
                      key_visible(row, key, SPARSE ? tw.end : p.Sq, RING ? p.k_hi : p.Sk,
                                  p.left, p.right) &&
                      (!SPARSE || sw.fetch || walk_has(sw, tw.h, key, row)))) {
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

      Mma::template grads<QT, NA>(dv, dk, s, dp, t.o, t.qk, LD, c0, lane);
    }

    if (SPARSE ? head_last : i % n_t == n_t - 1) {
      // The head's last tile: dK += scale · colsum(dS)ᵀ · qm of this head.
      if (p.qm) {
        const float* qm = p.qm + qbh * p.D;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float sc = p.scale * quad_sum(cs[r]);
#pragma unroll
          for (int n = 0; n < NA; ++n) {
            const int col = c0 + 8 * n + 2 * tq;
            if (col < p.D) dk[n][2 * r] = fmaf(sc, qm[col], dk[n][2 * r]);
            if (col + 1 < p.D) dk[n][2 * r + 1] = fmaf(sc, qm[col + 1], dk[n][2 * r + 1]);
          }
        }
      }
      cs[0] = cs[1] = 0.f;
    }
  }

  const float dks = Load::dk_scale(p);
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
        const int col = c0 + 8 * n + 2 * tq + c;
        if (col < p.D) {
          store_grad<RING>(dkp, (long long)key * p.D + col, dks * dk[n][2 * r + c], p.first);
          store_grad<RING>(dvp, (long long)key * p.D + col, dv[n][2 * r + c], p.first);
        }
      }
  }
}

template <class Load, class Mma, typename Tout, int DP, bool RING = false, bool SPARSE = false>
cudaError_t launch_dkv_tc(const BwdParams& p, int vec, cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes<Load, Mma, DP>();
  constexpr int nthr = DkvTile<DP, Mma>::NTHR, kb = DkvTile<DP, Mma>::KB;
  const auto kernel = dkv_tc_kernel<Load, Mma, Tout, DP, RING, SPARSE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sk + kb - 1) / kb, p.Hkv, p.B);
  kernel<<<grid, nthr, smem, stream>>>(p, vec);
  return cudaGetLastError();
}

// ---- dQ ------------------------------------------------------------------
//
// One block of 4 warps per (64-row query tile, q head, batch), the last
// query tiles (which see the most keys under a causal mask) first; warp w
// owns query rows 16w..16w+15 and their dQ in fp32 mma accumulators (fp32
// at D 256, WIDE32: 8 warps, warp w rows 16(w % 4)..+15 and half the
// columns of their dQ, S and dP formed over that half of the depth and
// added by `sum_slices`). Q and
// dO are staged once as tiles with the per-row LSE, δ and dP term. Per
// visible key tile of KT keys:
//   S = Q·Kᵀ and dP = dO·Vᵀ   (A: Q, dO via ldmatrix; B: K, V stored
//   [key][d], via ldmatrix)
//   P, dS on the fragments
//   dQ += dS·K   (A straight from the dS accumulators, bf16-rounded under
//   Bf16Mma; B via ldmatrix.trans, or shared loads under Tf32x3Mma)
// bf16: at D > 64 the key tile is 32 keys, so two blocks an SM fit at D 128
// and one at D 256 (where dQ alone holds 128 fp32 registers a thread).
// fp32: 32 keys, two blocks an SM at D 64, one at D 128; 16 at D 256, where
// Q and dO alone take 133 KB and the stage holds two key tiles, not three
// (its `AHEAD`), and the partials 16 KB: 216,832 bytes.
template <int DP, class Mma = Bf16Mma>
struct DqTile {
  static constexpr bool F32 = sizeof(typename Mma::T) == 4;
  static constexpr bool WIDE32 = F32 && DP > 128;
  static constexpr int SLICES = WIDE32 ? 2 : 1;  // warps on one 16-row group
  static constexpr int NTHR = NT * SLICES;
  static constexpr int KT = WIDE32 ? 16 : DP <= 64 && !F32 ? 64 : 32;  // keys a step
  static constexpr int LD = DP + Mma::PAD;
  static constexpr int MINB = F32 ? DP <= 64 ? 2 : 1 : DP <= 64 ? 3 : DP <= 128 ? 2 : 1;
  static constexpr int PART_BYTES = WIDE32 ? KT * 4 * NTHR : 0;  // `sum_slices`
};

// The load stage `Load` of dq_tc_kernel provides:
//   Kv                        the key tile the products read, built from a
//       converted buffer (Kv::BYTES) and a staging buffer: tiles of Mma::T
//       k, v (row stride LD) and score(x, kj), the score x of key kj plus
//       the stage's per-key term (or x itself);
//   NRAW, RAW_BYTES           the staging buffers (2, or 3 when Kv reads its
//       staging buffer) and their size;
//   AHEAD                     how many steps ahead a key tile is copied: 2,
//       or 1 when Kv reads its staging buffer from two of them;
//   IN_FLIGHT                 the copies that may still be in flight at a
//       step's barrier: 0 when `stage` converts the next tile, which must
//       have landed by then (or when it was copied one step ahead), 1 when
//       it does not;
//   stage_q(sQ, sO, sRow, p, qbh, kbh, q0)  Q and dO of the block's 64
//       rows (Mma::T, LD) and per row the dP term, LSE and δ (sRow[0..63],
//       [64..127], [128..191]);
//   issue(raw, p, qbh, kbh, k0, vec)   the copies of a key tile's raw operands;
//   stage(raw, kv, p, kbh, k0)         raw -> the converted part of kv.
template <class Load, class Mma, int DP>
constexpr int dq_smem_bytes() {
  return 2 * 64 * DqTile<DP, Mma>::LD * (int)sizeof(typename Mma::T) + 3 * 64 * 4 +
         2 * Load::Kv::BYTES + Load::NRAW * Load::RAW_BYTES + DqTile<DP, Mma>::PART_BYTES;
}

template <class Load, class Mma, typename Tout, int DP, bool RING = false, bool SPARSE = false>
__global__ void __launch_bounds__(DqTile<DP, Mma>::NTHR, DqTile<DP, Mma>::MINB)
    dq_tc_kernel(const BwdParams p, const int vec) {
  using G = DqTile<DP, Mma>;
  using T = typename Mma::T;
  using Kv = typename Load::Kv;
  constexpr int KT = G::KT, LD = G::LD;
  constexpr int NS = KT / 8;            // 8-key tiles of S and dP
  constexpr int DW = DP / G::SLICES;    // columns of dQ a warp owns
  constexpr int NA = DW / 8;            // their 8-column tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sO = sQ + 64 * LD;
  float* sRow = reinterpret_cast<float*>(sO + 64 * LD);               // dP term, LSE, δ
  unsigned char* kvb = reinterpret_cast<unsigned char*>(sRow + 3 * 64);  // [2][Kv::BYTES]
  unsigned char* raw = kvb + 2 * Kv::BYTES;                              // [NRAW][RAW_BYTES]
  float* part = reinterpret_cast<float*>(raw + Load::NRAW * Load::RAW_BYTES);  // WIDE32
  auto raw_of = [&](int i) { return raw + (i % Load::NRAW) * Load::RAW_BYTES; };
  auto kv_of = [&](int i) { return Kv(kvb + (i & 1) * Kv::BYTES, raw_of(i)); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * 64, h = blockIdx.y, b = blockIdx.z;
  const long long qbh = (long long)b * p.Hq + h;
  const long long kbh = (long long)b * p.Hkv + h / (p.Hq / p.Hkv);

  int k_lo, k_hi;
  visible_keys(q0, min(q0 + 64, p.Sq) - 1, p.Sk, p.left, p.right, &k_lo, &k_hi);
  if constexpr (RING) {
    k_hi = min(k_hi, p.k_hi - 1);
    if (min(q0 + 64, p.Sq) <= p.q_lo) k_hi = -1;
  }
  const int t_lo = k_lo / KT;
  int n_t = k_hi >= k_lo ? k_hi / KT - t_lo + 1 : 0;
  if constexpr (RING) {
    if (n_t == 0 && !p.first) return;  // adds nothing to the buffer
  }
  // SPARSE: the walk's position of the next tile to copy, and the tiles of
  // steps i and i + 1 (i + 1 copied already when AHEAD is 2).
  SparseWalk sw;
  WalkPos w_iss;
  WalkTile ta{}, tb{};
  if constexpr (SPARSE) {
    sw = sparse_walk(p.sm, true, b, h, 1, q0, min(q0 + 64, p.Sq) - 1, k_lo, k_hi, KT, p.Sk);
    if (n_t > 0) {
      w_iss = walk_start(sw);
      n_t = walk_count(sw, w_iss);
    }
  }

  // Pipeline as in dkv_tc_kernel: key tile i copied AHEAD steps ahead,
  // converted one step ahead, one barrier a step.
  constexpr int AHEAD = Load::AHEAD;
  if constexpr (SPARSE) {
    if (n_t > 0) {
      ta = walk_take(sw, w_iss);
      Load::issue(raw_of(0), p, qbh, kbh, ta.first, vec);
    }
    cp_async_commit();
    if (AHEAD > 1 && n_t > 1) {
      tb = walk_take(sw, w_iss);
      Load::issue(raw_of(1), p, qbh, kbh, tb.first, vec);
    }
    cp_async_commit();
  } else {
    if (n_t > 0) Load::issue(raw_of(0), p, qbh, kbh, t_lo * KT, vec);
    cp_async_commit();
    if (AHEAD > 1 && n_t > 1) Load::issue(raw_of(1), p, qbh, kbh, (t_lo + 1) * KT, vec);
    cp_async_commit();
  }
  Load::stage_q(sQ, sO, sRow, p, qbh, kbh, q0);
  cp_async_wait<1>();
  __syncthreads();
  if (n_t > 0) Load::stage(raw_of(0), kv_of(0), p, kbh, SPARSE ? ta.first : t_lo * KT);

  const int rw = (G::WIDE32 ? warp & 3 : warp) * 16;  // the warp's first row in the tile
  const int c0 = G::WIDE32 ? (warp >> 2) * DW : 0;      // its first column of dQ
  const int row0 = q0 + rw + g, row1 = row0 + 8;       // this thread's two rows
  const float vt[2] = {sRow[rw + g], sRow[rw + g + 8]};
  const float lse[2] = {sRow[64 + rw + g], sRow[64 + rw + g + 8]};
  const float dlt[2] = {sRow[128 + rw + g], sRow[128 + rw + g + 8]};
  const float* bias = p.bias ? p.bias + b * p.bsb + h * p.bsh : nullptr;

  float acc[NA][4];
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < n_t; ++i) {
    cp_async_wait<Load::IN_FLIGHT>();
    __syncthreads();  // key tile i landed and converted, step i - 1 done
    WalkTile tw{};  // SPARSE: step i's tile (keys at or past tw.end hidden)
    if constexpr (SPARSE) {
      WalkTile tc{};
      if (i + AHEAD < n_t) {
        tc = walk_take(sw, w_iss);
        Load::issue(raw_of(i + AHEAD), p, qbh, kbh, tc.first, vec);
      }
      cp_async_commit();
      if (AHEAD == 1) tb = tc;
      if (i + 1 < n_t) Load::stage(raw_of(i + 1), kv_of(i + 1), p, kbh, tb.first);
      tw = ta;
      ta = tb;
      tb = tc;
    } else {
      if (i + AHEAD < n_t)
        Load::issue(raw_of(i + AHEAD), p, qbh, kbh, (t_lo + i + AHEAD) * KT, vec);
      cp_async_commit();
      if (i + 1 < n_t) Load::stage(raw_of(i + 1), kv_of(i + 1), p, kbh, (t_lo + i + 1) * KT);
    }

    const int k0 = SPARSE ? tw.first : (t_lo + i) * KT;
    const Kv kv = kv_of(i);

    // This warp's rows [r_lo, r_lo + 15] against keys [k0, k0 + KT).
    const int r_lo = q0 + rw, r_hi = r_lo + 15, ke = k0 + KT - 1;
    const bool none = r_lo >= p.Sq || k0 >= (SPARSE ? tw.end : p.Sk) ||
                      (p.right >= 0 && k0 > r_hi + p.right) ||
                      (p.left >= 0 && ke < r_lo - p.left) ||
                      (RING && (k0 >= p.k_hi || r_hi < p.q_lo));
    const bool all = r_hi < p.Sq && ke < (SPARSE ? tw.end : p.Sk) &&
                     (p.right < 0 || ke <= r_lo + p.right) &&
                     (p.left < 0 || k0 >= r_hi - p.left) &&
                     (!RING || (ke < p.k_hi && r_lo >= p.q_lo)) &&
                     (!SPARSE || sw.fetch != nullptr);
    if (!G::WIDE32 && none) continue;

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    if constexpr (G::WIDE32) {  // over the warp's depth slice, the columns it owns
      if (!none)
        Mma::template scores<DW, KT, Mma::QK_CHAIN>(s, dp, sQ + c0, sO + c0, kv.k + c0,
                                                    kv.v + c0, LD, rw, lane);
      sum_slices<G::SLICES, 4>(s, dp, part, !none);
      if (none) continue;
    } else {
      Mma::template scores<DP, KT>(s, dp, sQ, sO, kv.k, kv.v, LD, rw, lane);
    }

    // Element (j, e): row e < 2 ? row0 : row1, key k0 + 8j + 2tq + (e & 1).
    const float* tbias = SPARSE && tw.full ? nullptr : bias;  // SPARSE: none read on a FULL tile
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, row = r ? row1 : row0, kj = 8 * j + 2 * tq + (e & 1), key = k0 + kj;
        float ds = 0.f;
        if (all || ((!RING || row >= p.q_lo) &&
                    key_visible(row, key, p.Sq, RING ? p.k_hi : SPARSE ? tw.end : p.Sk, p.left,
                                p.right) &&
                    (!SPARSE || sw.fetch || walk_has(sw, 0, row, key)))) {
          float x = kv.score(s[j][e], kj);
          if (tbias) x = __fadd_rn(x, tbias[row * p.bsq + key * p.bsk]);
          const float pr = expf(x - lse[r]);
          ds = __fmul_rn(pr, __fadd_rn(dp[j][e], vt[r]) - dlt[r]);
        }
        dp[j][e] = ds;
      }

    Mma::template grad<KT, NA>(acc, dp, kv.k, LD, c0, lane);
  }

  Tout* dq = static_cast<Tout*>(p.out0) + qbh * p.Sq * p.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int n = 0; n < NA; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = c0 + 8 * n + 2 * tq + c;
        if (col < p.D)
          store_grad<RING>(dq, (long long)row * p.D + col, p.scale * acc[n][2 * r + c], p.first);
      }
  }
}

template <class Load, class Mma, typename Tout, int DP, bool RING = false, bool SPARSE = false>
cudaError_t launch_dq_tc(const BwdParams& p, int vec, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<Load, Mma, DP>();
  const auto kernel = dq_tc_kernel<Load, Mma, Tout, DP, RING, SPARSE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  constexpr int nthr = DqTile<DP, Mma>::NTHR;
  const dim3 grid((p.Sq + 63) / 64, p.Hq, p.B);
  kernel<<<grid, nthr, smem, stream>>>(p, vec);
  return cudaGetLastError();
}

}  // namespace umfa
