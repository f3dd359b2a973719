// Shared pieces of the attention kernels: tile geometry, element access,
// the reference's rounding points and masking constant, and the error-string
// export every kernel library carries.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace umfa {

// The common tile geometry: one block of NT threads (4 warps) per 64-row
// query tile, 64-key K/V tiles; kernels that differ say so.
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 128;

// Large-but-finite mask value of the reference (flash_fwd.py:41-43): -inf
// would turn the online-softmax rescale exp(m_prev - m_new) into NaN.
constexpr float MASK_VALUE = -1e30f;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T> struct Elem;

template <> struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p, long long i) { return p[i]; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void store(float* p, long long i, float x) { p[i] = x; }
};

template <> struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
    return __bfloat162float(p[i]);
  }
  static __device__ __forceinline__ float round(float x) { return round_bf16(x); }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float x) {
    p[i] = __float2bfloat16_rn(x);
  }
};

// Key index range [lo, hi] that query rows [q0, q_last] can see under the
// top-left aligned window (left, right), -1 = unbounded; causal is folded
// into right = 0 by the host. lo > hi when nothing is visible.
__device__ __forceinline__ void visible_keys(int q0, int q_last, int sk, int left,
                                             int right, int* lo, int* hi) {
  *lo = left >= 0 ? max(0, q0 - left) : 0;
  *hi = right >= 0 ? min(sk - 1, q_last + right) : sk - 1;
}

// The transpose of `visible_keys`: query index range [lo, hi] that can see
// some key of [k0, k_last]. lo > hi when none can.
__device__ __forceinline__ void visible_queries(int k0, int k_last, int sq, int left,
                                                int right, int* lo, int* hi) {
  *lo = right >= 0 ? max(0, k0 - right) : 0;
  *hi = left >= 0 ? min(sq - 1, k_last + left) : sq - 1;
}

__device__ __forceinline__ bool key_visible(int row, int col, int sq, int sk, int left,
                                            int right) {
  return row < sq && col < sk && (left < 0 || col >= row - left) &&
         (right < 0 || col <= row + right);
}

// ---- Block-sparse walks (the SPARSE instantiations) --------------------------
//
// A block-sparse map (ops/block_mask.py) as the kernels read it: tile
// (i, j) of bq query rows and bk keys is walked iff map[i][j] != SKIP, and
// FULL tiles have every in-bounds pair visible (their bias is 0). `fetch`
// is a compacted table of width entries a row: for each map tile of the
// block's own side, its walked tiles of the other side in increasing order,
// then negative padding (fetch_kv for the forward and dQ, whose blocks are
// query rows; fetch_q for dK/dV, whose blocks are keys). Element strides of
// the batch and head dimensions, 0 where the map broadcasts. A null map
// means no walk; only the SPARSE instantiations read any of it.
struct SparseMap {
  const int* map;    // (Bm, Hm, nq, nk)
  const int* fetch;  // (Bm, Hm, nq | nk, width)
  int bq, bk, nq, nk, width;
  long long msb, msh, fsb, fsh;
};

constexpr int MAP_SKIP = 0, MAP_FULL = 2;

// The walk of one block: the map tiles ("groups") of the walked side that
// some index of the block's own range walks, in increasing order, clipped
// to the band [lo, hi]; in each group its kernel tiles of kt indices from
// the group's first index in the band (not aligned to kt: a kernel tile
// never spans two groups), the last clipped to the group's end. Where the
// block's own range lies in one map tile, the walk reads that tile's
// compacted row; where it straddles two or more (a map tile that the
// kernel's tile does not divide), it scans the map for tiles that any of
// them walks, and each element then looks up its own tile's class. dK/dV
// walks the `heads` query heads of its GQA group one after another, each
// its own row of the map (head strides 0 when the map broadcasts).
struct SparseWalk {
  const int* map;    // the map at (batch, first head)
  const int* fetch;  // the compacted row of the block's own tile (first head), or null
  long long mh, fh;  // head strides of the map and the table
  int own_s, walk_s; // map strides of an own tile and a walked tile
  int a0, a1;        // the block's own tiles
  int width, bo, bt, kt, lo, hi, lim, heads;
};

struct WalkPos {
  int h, g, j, s;  // head, group (-1: the walk has ended), kernel tile in the group, table cursor
};

// A kernel tile of the walk: its first index, the end of its group (indices
// at or past it are hidden), whether the group is FULL for the block, and
// its head.
struct WalkTile {
  int first, end;
  bool full;
  int h;
};

// keys_walked: the forward and dQ (blocks of query rows [own0, own1] walk
// keys); else dK/dV (blocks of keys walk query rows). [lo, hi]: the band,
// lo <= hi; lim: the walked side's length.
__device__ __forceinline__ SparseWalk sparse_walk(const SparseMap& m, bool keys_walked, int b,
                                                  int h0, int heads, int own0, int own1, int lo,
                                                  int hi, int kt, int lim) {
  SparseWalk w;
  w.bo = keys_walked ? m.bq : m.bk;
  w.bt = keys_walked ? m.bk : m.bq;
  w.own_s = keys_walked ? m.nk : 1;
  w.walk_s = keys_walked ? 1 : m.nk;
  w.a0 = own0 / w.bo;
  w.a1 = own1 / w.bo;
  w.map = m.map + b * m.msb + h0 * m.msh;
  w.fetch = w.a0 == w.a1 ? m.fetch + b * m.fsb + h0 * m.fsh + (long long)w.a0 * m.width : nullptr;
  w.mh = m.msh;
  w.fh = m.fsh;
  w.width = m.width;
  w.kt = kt;
  w.lo = lo;
  w.hi = hi;
  w.lim = lim;
  w.heads = heads;
  return w;
}

// The next group of head p.h after p.g that holds band indices, or -1.
__device__ __forceinline__ int walk_next_group(const SparseWalk& w, WalkPos& p) {
  if (w.fetch) {
    const int* f = w.fetch + p.h * w.fh;
    while (p.s < w.width) {
      const int id = f[p.s++];
      if (id < 0 || id * w.bt > w.hi) break;  // the row's end, or past the band (ids ascend)
      if (id * w.bt + w.bt > w.lo) return id;
    }
    return -1;
  }
  const int* m = w.map + p.h * w.mh;
  for (int t = max(p.g + 1, w.lo / w.bt); t * w.bt <= w.hi; ++t)
    for (int a = w.a0; a <= w.a1; ++a)
      if (m[a * w.own_s + t * w.walk_s] != MAP_SKIP) return t;
  return -1;
}

// Enter the next group, moving to the next head at a head's end.
__device__ __forceinline__ void walk_group(const SparseWalk& w, WalkPos& p) {
  int g = walk_next_group(w, p);
  while (g < 0 && p.h + 1 < w.heads) {
    ++p.h;
    p.g = -1;
    p.s = 0;
    g = walk_next_group(w, p);
  }
  p.g = g;
  p.j = g < 0 ? 0 : (max(g * w.bt, w.lo) - g * w.bt) / w.kt;
}

__device__ __forceinline__ WalkPos walk_start(const SparseWalk& w) {
  WalkPos p{0, -1, 0, 0};
  walk_group(w, p);
  return p;
}

__device__ __forceinline__ void walk_next(const SparseWalk& w, WalkPos& p) {
  const int base = p.g * w.bt;
  if (base + (p.j + 1) * w.kt <= min(base + w.bt - 1, w.hi))
    ++p.j;
  else
    walk_group(w, p);
}

// Kernel tiles from p to the walk's end.
__device__ __forceinline__ int walk_count(const SparseWalk& w, WalkPos p) {
  int n = 0;
  while (p.g >= 0) {
    const int base = p.g * w.bt;
    n += (min(base + w.bt - 1, w.hi) - base) / w.kt - p.j + 1;
    walk_group(w, p);
  }
  return n;
}

// p moved n kernel tiles on (to the walk's end at most).
__device__ __forceinline__ WalkPos walk_skip(const SparseWalk& w, WalkPos p, int n) {
  while (n > 0 && p.g >= 0) {
    const int base = p.g * w.bt;
    const int after = (min(base + w.bt - 1, w.hi) - base) / w.kt - p.j;  // later tiles of the group
    if (n <= after) {
      p.j += n;
      return p;
    }
    n -= after + 1;
    walk_group(w, p);
  }
  return p;
}

__device__ __forceinline__ WalkTile walk_tile(const SparseWalk& w, const WalkPos& p) {
  const int base = p.g * w.bt;
  const bool full =
      w.fetch != nullptr && w.map[p.h * w.mh + w.a0 * w.own_s + p.g * w.walk_s] == MAP_FULL;
  return WalkTile{base + p.j * w.kt, min(base + w.bt, w.lim), full, p.h};
}

// The tile at p, and p moved to the next one.
__device__ __forceinline__ WalkTile walk_take(const SparseWalk& w, WalkPos& p) {
  const WalkTile t = walk_tile(w, p);
  walk_next(w, p);
  return t;
}

// Whether own index `own` walks index `idx` (head h): where the block
// straddles own tiles, each element's own tile decides.
__device__ __forceinline__ bool walk_has(const SparseWalk& w, int h, int own, int idx) {
  return w.map[h * w.mh + (own / w.bo) * w.own_s + (idx / w.bt) * w.walk_s] != MAP_SKIP;
}

// The walk arguments of the C entries as a SparseMap; false when they are
// not a map the kernels take (a null map is no walk and always taken).
inline bool sparse_map(SparseMap* m, const void* map, const void* fetch, int bq, int bk, int nq,
                       int nk, int width, long long msb, long long msh, long long fsb,
                       long long fsh) {
  *m = SparseMap{static_cast<const int*>(map), static_cast<const int*>(fetch), bq, bk, nq, nk,
                 width, msb, msh, fsb, fsh};
  return map == nullptr || (fetch != nullptr && bq > 0 && bk > 0 && nq > 0 && nk > 0 && width > 0);
}

}  // namespace umfa

extern "C" const char* umfa_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
