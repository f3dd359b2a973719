// Tensor-core body of the attention forward for Hopper, sm_90a
// (`fwd_tc_kernel`): the dense forward (csrc/flash_fwd.cu) and one rank's
// ring forward step (csrc/ring_attn.cu).
//
// The FA2 shape on mma.sync: one block of 4 warps per (64-row query tile,
// q head, batch; fp32 at D 256: 8 warps per 128-row tile), the last query
// tiles (which see the most keys under a causal mask) first; each warp
// owns 16 whole query rows, so the row max and row sum need only quad
// shuffles. Q is staged once (and, where it fits, held in registers as A
// fragments for the whole walk); K and V tiles of KT keys are
// double-buffered in shared memory, cp.async bringing step i + 1 while
// step i is computed; rows past the key limit and columns past D are
// zero-filled by the copy. S = Q·Kᵀ into fp32 fragments; the mask and the
// bias are applied on the fragments, element by element only on tiles that
// cross a mask edge or carry a bias; tiles nobody in the block sees are
// never loaded, and a warp skips a tile its rows cannot see. P leaves the S
// accumulators as A fragments of P·V (no trip through shared memory).
//
// The product policy (mma_policy.cuh) is a template parameter: `Bf16Mma`
// (bf16 tiles, KT = 64, mma.sync m16n8k16) or `Tf32x3Mma` (fp32 tiles,
// KT = 32 or 16 at D 256, every product as three mma.sync m16n8k8 tf32 on
// split operands; the scores keep big·big and the small products in
// separate accumulators, and each tile's P·V goes into a zeroed fragment
// that an fp32 add puts on the running sum, so no mma chain is long). For P·V's A fragment the tf32
// policy permutes the keys inside each 8-key step (mma.cuh
// `tf32_a_from_c`), and reads V's B fragment in the same order by two
// scalar shared loads (rows padded to D + 4 floats: free of bank conflicts).
//
// The walk: the running max is seeded by a K-only pre-pass before any P is
// formed. Dense (RING = false): one pre-pass over the first PRE tiles (512
// keys), then every visible tile with the online softmax update and P·V.
// Ring (RING = true): the keys fall in groups of block_k (the reference's
// key tiles); for each group that holds visible keys, its visible tiles
// (KT keys, clipped to the group) first for the group's row max, then for P
// and P·V, so that P is rounded against the running max of whole groups as
// the reference rounds it. The including file's header gives the rounding
// points each mode holds to.
//
// SPARSE (a template parameter, so the dense and ring instantiations
// compile as without it): the dense walk restricted to a block-sparse map
// (common.cuh `SparseWalk`): the block walks the map's walked key tiles
// (from the compacted row of its map query tile), in each its KT-key tiles
// from the tile's first key in the band; the K-only pre-pass takes the
// last PRE walked tiles: a row's first walked keys are often another
// document's, hidden by the bias, while the keys nearest the diagonal are
// its own, so a row that sees only keys of its last PRE walked tiles (the
// first rows of a causal document, a window of up to PRE tiles) rounds P
// against its final max, as the plain version does. Keys past a map tile's end are hidden
// like the KV tail, and the bias is read only on tiles that are not FULL
// for the block (a BlockMask's bias is 0 on FULL tiles); where the block
// straddles map query tiles, each element looks up its own tile's class.
//
// ROPE (a template parameter, so the other instantiations compile as
// without it; not combined with RING or SPARSE): rotate-half RoPE inside
// the kernel (the reference's flash_fwd.py:284-293, :374-378, :425-431).
// Q is rotated in fp32 as it is staged, element c against element c ± D/2
// of its row and table row q0 + r, then scaled and rounded once to its
// type; each staged K tile (the pre-pass's too: an unrotated pre-pass
// would seed the running max from the wrong scores) is rotated in shared
// memory in fp32 and rounded to its type after its copy landed and before
// any product reads it, a barrier after. Each product and sum of the
// rotation is rounded on its own (no FMA), as the plain version computes
// it. Rows past Sk stay zero. Rotated Q and K never reach device memory.
//
// RING (a template parameter, so the dense instantiations compile as
// without it): what the step sees is the band (left, right) plus two
// limits, query rows below q_lo and keys at or past k_hi hidden; the step's
// (o_step, lse_step) merge into the running (o, lse), or are written at the
// rank's first step. One warp owns each row, so a __syncwarp orders the
// quad's reads of the old LSE before its owner's write. A block that sees
// nothing after the first step stores nothing. One owner per output tile,
// no atomics: the step is deterministic.
#pragma once

#include "common.cuh"
#include "mma.cuh"
#include "mma_policy.cuh"

namespace umfa {

// The arguments of the forward body. The dense forward leaves the ring's
// fields 0.
struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  void* out;  // the ring: o, read (unless first) and written
  float* lse;
  int B, Hq, Hkv, Sq, Sk, D;
  long long bsb, bsh, bsq, bsk;
  float scale;
  int left, right;
  int vec;  // K/V rows by 16-byte cp.async (D and the pointers' alignment allow it)
  // Read only by the RING instantiations: query rows below q_lo and keys at
  // or past k_hi are hidden; keys fall in groups of block_k; first: write
  // (o, lse), else merge into them.
  int q_lo, k_hi, block_k, first;
  SparseMap sm;  // read only by the SPARSE instantiations: the map and fetch_kv
  // Read only by the ROPE instantiations: the rotate-half angle tables,
  // fp32, at least max(Sq, Sk) rows of D/2 (query row i and key row j
  // take table row i and j).
  const float* rope_cos;
  const float* rope_sin;
  int rope_vec;  // D % 8 == 0 and both tables 16-byte aligned: 4 pairs a load
};

// Rotate-half RoPE of one element x against its partner (the element
// D/2 away in the same row) at angle (cs, sn): x·cos − partner·sin in the
// lower half, x·cos + partner·sin in the upper; products and sum rounded
// one at a time (no FMA contraction), as the plain version rounds them.
__device__ __forceinline__ float rope_rotate(float x, float partner, float cs, float sn,
                                             bool lower) {
  const float a = __fmul_rn(x, cs), b = __fmul_rn(partner, sn);
  return lower ? __fsub_rn(a, b) : __fadd_rn(a, b);
}

// Rotate the pair (c, c + h2) of a row in shared memory, in fp32, each
// element rounded back to T.
template <typename T>
__device__ __forceinline__ void rope_rotate_pair(T* row, int c, int h2, float cs, float sn) {
  const float x1 = Elem<T>::load(row, c), x2 = Elem<T>::load(row, c + h2);
  Elem<T>::store(row, c, rope_rotate(x1, x2, cs, sn, true));
  Elem<T>::store(row, c + h2, rope_rotate(x2, x1, cs, sn, false));
}

// Rotate rows [0, ROWS) of a staged K tile (row stride LD, key k0 + r in
// row r) in place; rows at or past sk stay as they are (zero). Each thread
// owns whole pairs. The table reads are L2 hits whose latency, not their
// bytes, bounds the pass: with `vec` a thread takes 4 pairs of a row at
// once (one 16-byte load of each table) and several groups are in flight.
template <int ROWS, int DP, int LD, int NT, typename T>
__device__ __forceinline__ void rope_rotate_tile(T* sK, int k0, int sk, int d, bool vec,
                                                 const float* cos_t, const float* sin_t) {
  const int h2 = d >> 1;
  if (vec) {
    constexpr int G4 = DP / 8;  // groups of 4 pairs in a padded row
#pragma unroll 4
    for (int e = threadIdx.x; e < ROWS * G4; e += NT) {
      const int r = e / G4, c = (e - r * G4) * 4;
      if (k0 + r >= sk || c >= h2) continue;
      const long long t = (long long)(k0 + r) * h2 + c;
      const float4 cs = __ldg(reinterpret_cast<const float4*>(cos_t + t));
      const float4 sn = __ldg(reinterpret_cast<const float4*>(sin_t + t));
      T* row = sK + r * LD;
      rope_rotate_pair(row, c, h2, cs.x, sn.x);
      rope_rotate_pair(row, c + 1, h2, cs.y, sn.y);
      rope_rotate_pair(row, c + 2, h2, cs.z, sn.z);
      rope_rotate_pair(row, c + 3, h2, cs.w, sn.w);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * h2; e += NT) {
      const int r = e / h2, c = e - r * h2;
      if (k0 + r >= sk) continue;
      const long long t = (long long)(k0 + r) * h2 + c;
      rope_rotate_pair(sK + r * LD, c, h2, __ldg(cos_t + t), __ldg(sin_t + t));
    }
  }
}

// Tiles and occupancy. bf16: 64-key tiles, four blocks an SM at D 64 (the
// dense forward; registers capped at 128), three in ring mode (WALK: the
// ring's and the block-sparse walks, whose state takes registers). fp32: 32-key
// tiles (52 KB of shared memory at D 64, 99 KB at D 128), three blocks an
// SM at D 64 (6 % faster at the prefill than two with Q split once into
// registers), two at D 128. fp32 at D 256 (WIDE32): a 64-row block would
// hold one block of 4 warps an SM (the Q tile alone is 66 KB, and each
// warp's out accumulator 128 registers), so the block takes 128 query rows
// on 8 warps and 16-key tiles: (128 + 4·16) · 260 · 4 = 199,680 bytes, one
// block an SM, 8 warps, 255 registers a thread; each warp's step is the
// D 128 step's mma count (32 k-steps over 2 key tiles, 2 k-steps over 32
// output tiles).
template <int DP, class Mma, bool WALK>
struct FwdTile {
  using T = typename Mma::T;
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr bool WIDE32 = F32 && DP > 128;
  static constexpr int BQ = WIDE32 ? 128 : umfa::BQ;        // query rows a block
  static constexpr int NT = BQ / 16 * 32;                   // a warp per 16 rows
  static constexpr int KT = WIDE32 ? 16 : F32 ? 32 : 64;    // keys a tile
  static constexpr int LD = DP + Mma::PAD;                  // row stride in shared memory
  static constexpr int PRE = 512 / KT;                      // dense: tiles of the pre-pass
  static constexpr int MINB =
      WIDE32 ? 1 : F32 ? (DP <= 64 ? 3 : 2) : DP <= 64 ? (WALK ? 3 : 4) : 1;
  static constexpr int SMEM = (BQ + 4 * KT) * LD * (int)sizeof(T);  // Q, [2][K, V]
};

// Rows [k0, k0 + ROWS) of K (and of V, with_v) into one buffer of row
// stride LD; rows at or past kend and columns past D are zero. With `vec`
// by 16-byte cp.async (the caller commits the group); else by plain loads
// and stores.
template <int ROWS, int DP, int LD, typename T>
__device__ __forceinline__ void load_kv_tile(T* sK, T* sV, const T* k, const T* v, int k0,
                                             int kend, int D, bool vec, bool with_v) {
  constexpr int E = 16 / (int)sizeof(T), CH = DP / E;
  if (vec) {
    for (int e = threadIdx.x; e < ROWS * CH; e += blockDim.x) {
      const int r = e / CH, c = (e - r * CH) * E;
      const bool ok = k0 + r < kend && c < D;
      const long long i = ok ? (long long)(k0 + r) * D + c : 0;
      cp_async16(sK + r * LD + c, k + i, ok ? 16 : 0);
      if (with_v) cp_async16(sV + r * LD + c, v + i, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DP; e += blockDim.x) {
      const int r = e / DP, c = e - r * DP;
      const bool ok = k0 + r < kend && c < D;
      const long long i = (long long)(k0 + r) * D + c;
      sK[r * LD + c] = ok ? k[i] : static_cast<T>(0.f);
      if (with_v) sV[r * LD + c] = ok ? v[i] : static_cast<T>(0.f);
    }
  }
}

// acc *= alpha, row by row (C fragments: elements 0, 1 of row g, 2, 3 of g + 8).
template <int NA>
__device__ __forceinline__ void scale_rows(float (&acc)[NA][4], const float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < NA; ++n) {
    acc[n][0] *= alpha[0];
    acc[n][1] *= alpha[0];
    acc[n][2] *= alpha[1];
    acc[n][3] *= alpha[1];
  }
}

// The ring walk of one block: the groups of bk keys that hold visible keys
// [lo, hi], in each its visible tiles of kt keys (clipped to the group) twice,
// first for the row max (pre), then for P and P·V.
struct RingWalk {
  int lo, hi, bk, kt;
  int g, j, j_lo, j_hi, pre;  // the step: group, tile, the group's tiles, pass
  __device__ __forceinline__ void enter(int group) {
    g = group;
    const int base = g * bk;
    j_lo = (max(base, lo) - base) / kt;
    j_hi = (min(base + bk - 1, hi) - base) / kt;
    j = j_lo;
    pre = 1;
  }
  __device__ __forceinline__ void next() {
    if (j < j_hi) {
      ++j;
    } else if (pre) {
      pre = 0;
      j = j_lo;
    } else {
      enter(g + 1);
    }
  }
  __device__ __forceinline__ int k0() const { return g * bk + j * kt; }
  // The step's key limit: the group's end, or k_hi before it.
  __device__ __forceinline__ int end(int k_hi) const { return min(g * bk + bk, k_hi); }
  // Steps of the whole walk.
  __device__ __forceinline__ int steps() {
    int n = 0;
    for (int grp = lo / bk; grp <= hi / bk; ++grp) {
      enter(grp);
      n += 2 * (j_hi - j_lo + 1);
    }
    enter(lo / bk);
    return n;
  }
};

template <class Mma, typename Tout, int DP, bool RING = false, bool SPARSE = false,
          bool ROPE = false>
__global__ void __launch_bounds__((FwdTile<DP, Mma, RING || SPARSE>::NT),
                                  (FwdTile<DP, Mma, RING || SPARSE>::MINB))
    fwd_tc_kernel(const FwdParams p) {
  static_assert(!(ROPE && (RING || SPARSE)), "in-kernel RoPE takes the dense walk only");
  using G = FwdTile<DP, Mma, RING || SPARSE>;
  using T = typename Mma::T;
  constexpr int LD = G::LD, KT = G::KT, BQ = G::BQ, NT = G::NT;
  constexpr int NS = KT / 8;  // 8-key tiles of S
  constexpr int NA = DP / 8;  // 8-column tiles of out
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sKV = sQ + BQ * LD;  // [buffer][K, V][KT][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const T* q = static_cast<const T*>(p.q) + ((long long)b * p.Hq + h) * p.Sq * p.D;
  const T* k = static_cast<const T*>(p.k) + ((long long)b * p.Hkv + hk) * p.Sk * p.D;
  const T* v = static_cast<const T*>(p.v) + ((long long)b * p.Hkv + hk) * p.Sk * p.D;
  const float* bias = p.bias ? p.bias + b * p.bsb + h * p.bsh : nullptr;
  // The dense forward's row sum adds the rounded P at D < 128; the ring's
  // the unrounded P.
  const bool sum_rounded = !RING && p.D < 128;

  int k_lo, k_hi;
  visible_keys(q0, min(q0 + BQ, p.Sq) - 1, p.Sk, p.left, p.right, &k_lo, &k_hi);
  if constexpr (RING) {
    k_hi = min(k_hi, p.k_hi - 1);
    if (min(q0 + BQ, p.Sq) <= p.q_lo) k_hi = -1;
  }
  // Dense: steps [0, n_pre) walk the first key tiles for the row max alone
  // (K only); steps [n_pre, n_pre + n_t) walk every visible tile with the
  // softmax update and P·V. A row that sees at most PRE tiles thus rounds P
  // against its final max, as the plain version does.
  const int t_lo = k_lo / KT;
  int n_t = k_hi >= k_lo ? k_hi / KT - t_lo + 1 : 0;
  // SPARSE: the walk from its start (w_start), the step's tile (w_cur) and
  // the next step's (w_nxt).
  SparseWalk sw;
  WalkPos w_start{0, -1, 0, 0}, w_cur, w_nxt;
  if constexpr (SPARSE) {
    sw = sparse_walk(p.sm, true, b, h, 1, q0, min(q0 + BQ, p.Sq) - 1, k_lo, k_hi, KT, p.Sk);
    if (n_t > 0) {
      w_start = walk_start(sw);
      n_t = walk_count(sw, w_start);
    }
    w_cur = walk_skip(sw, w_start, n_t - min(n_t, G::PRE));  // the pre-pass's first tile
  }
  const int n_pre = min(n_t, G::PRE);
  auto tile_of = [&](int i) { return t_lo + (i < n_pre ? i : i - n_pre); };
  int steps = n_pre + n_t;
  RingWalk walk;
  if constexpr (RING) {
    walk = RingWalk{k_lo, k_hi, p.block_k, KT, 0, 0, 0, 0, 1};
    steps = n_t > 0 ? walk.steps() : 0;
    if (steps == 0 && !p.first) return;  // merges nothing into (o, lse)
  }
  if (steps > 0) {
    if constexpr (RING) {
      load_kv_tile<KT, DP, LD>(sKV, sKV + KT * LD, k, v, walk.k0(), walk.end(p.k_hi), p.D,
                               p.vec, false);
    } else if constexpr (SPARSE) {
      load_kv_tile<KT, DP, LD>(sKV, sKV + KT * LD, k, v, walk_tile(sw, w_cur).first, p.Sk, p.D,
                               p.vec, false);
    } else {
      load_kv_tile<KT, DP, LD>(sKV, sKV + KT * LD, k, v, tile_of(0) * KT, p.Sk, p.D, p.vec,
                               false);
    }
    cp_async_commit();
  }

  if constexpr (ROPE) {  // Q rotated and scaled in fp32, rounded once
    const int h2 = p.D >> 1;
#pragma unroll 4
    for (int e = tid; e < BQ * DP; e += NT) {
      const int r = e / DP, c = e - r * DP;
      float x = 0.f;
      if (q0 + r < p.Sq && c < p.D) {
        const long long row = (long long)(q0 + r) * p.D;
        const int lower = c < h2, cc = lower ? c : c - h2;
        const long long t = (long long)(q0 + r) * h2 + cc;
        x = __fmul_rn(rope_rotate(Elem<T>::load(q, row + c),
                                  Elem<T>::load(q, row + (lower ? c + h2 : cc)),
                                  __ldg(p.rope_cos + t), __ldg(p.rope_sin + t), lower),
                      p.scale);
      }
      sQ[r * LD + c] = static_cast<T>(x);
    }
  } else {
    for (int e = tid; e < BQ * DP; e += NT) {
      const int r = e / DP, c = e - r * DP;
      float x = 0.f;
      if (q0 + r < p.Sq && c < p.D) {
        x = Elem<T>::load(q, (long long)(q0 + r) * p.D + c);
        if constexpr (!RING) x = x * p.scale;  // the ring scales the dot, not Q
      }
      sQ[r * LD + c] = static_cast<T>(x);
    }
  }
  __syncthreads();

  const int rw = warp * 16;                       // the warp's first row in the tile
  const int row0 = q0 + rw + g, row1 = row0 + 8;  // this thread's two rows
  typename Mma::template FwdQ<DP> qf;
  qf.load(sQ, LD, rw, lane);

  float m[2] = {MASK_VALUE, MASK_VALUE}, l[2] = {0.f, 0.f};
  float acc[NA][4];
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < steps; ++i) {
    // The step's first key, its key limit (keys at or past it are hidden),
    // and whether it forms P (else it is a pre-pass step).
    int k0, kend;
    bool form_p, full = false;
    if constexpr (RING) {
      k0 = walk.k0();
      kend = walk.end(p.k_hi);
      form_p = !walk.pre;
    } else if constexpr (SPARSE) {
      const WalkTile t = walk_tile(sw, w_cur);
      k0 = t.first;
      kend = t.end;
      full = t.full;
      form_p = i >= n_pre;
    } else {
      k0 = tile_of(i) * KT;
      kend = p.Sk;
      form_p = i >= n_pre;
    }
    const int cur = i & 1;
    if (i + 1 < steps) {
      T* nxt = sKV + (cur ^ 1) * 2 * KT * LD;
      if constexpr (RING) {
        RingWalk w2 = walk;
        w2.next();
        load_kv_tile<KT, DP, LD>(nxt, nxt + KT * LD, k, v, w2.k0(), w2.end(p.k_hi), p.D, p.vec,
                                 !w2.pre);
      } else if constexpr (SPARSE) {
        w_nxt = w_cur;
        if (i + 1 == n_pre)
          w_nxt = w_start;  // the pre-pass ends: the walk starts again, with V
        else
          walk_next(sw, w_nxt);
        load_kv_tile<KT, DP, LD>(nxt, nxt + KT * LD, k, v, walk_tile(sw, w_nxt).first, p.Sk, p.D,
                                 p.vec, i + 1 >= n_pre);
      } else {
        load_kv_tile<KT, DP, LD>(nxt, nxt + KT * LD, k, v, tile_of(i + 1) * KT, p.Sk, p.D,
                                 p.vec, i + 1 >= n_pre);
      }
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (ROPE) {  // the landed K tile, rotated before any product reads it
      rope_rotate_tile<KT, DP, LD, NT>(sKV + cur * 2 * KT * LD, k0, p.Sk, p.D, p.rope_vec,
                                       p.rope_cos, p.rope_sin);
      __syncthreads();
    }
    const T* cK = sKV + cur * 2 * KT * LD;
    const T* cV = cK + KT * LD;

    // Rows rw..rw+15 of the tile against keys k0..k0+KT-1: none visible, all
    // visible (and all rows real), or an edge.
    const int r_lo = q0 + rw, r_hi = r_lo + 15;
    bool none = k0 >= kend || (p.right >= 0 && k0 > r_hi + p.right) ||
                (p.left >= 0 && k0 + KT - 1 < r_lo - p.left);
    bool all = k0 + KT <= kend && r_hi < p.Sq && (p.right < 0 || k0 + KT - 1 <= r_lo + p.right) &&
               (p.left < 0 || k0 >= r_hi - p.left);
    if constexpr (RING) {
      none = none || r_hi < p.q_lo;
      all = all && r_lo >= p.q_lo;
    }
    if constexpr (SPARSE) all = all && sw.fetch != nullptr;
    const float* tb = bias;  // SPARSE: no bias read on a FULL tile
    if constexpr (SPARSE) {
      if (full) tb = nullptr;
    }
    if (!none) {
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      Mma::template qk<DP, KT>(s, qf, sQ, cK, LD, rw, lane);
      if constexpr (RING) {  // s = (q·k) · scale, rounded once
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = __fmul_rn(s[j][e], p.scale);
      }

      // Element (j, e): row e < 2 ? row0 : row1, key k0 + 8j + 2tq + (e & 1).
      unsigned vis = 0xffffffffu;
      if (!all || tb) {
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = e < 2 ? row0 : row1, col = k0 + 8 * j + 2 * tq + (e & 1);
            if (all || ((!RING || row >= p.q_lo) &&
                        key_visible(row, col, p.Sq, kend, p.left, p.right) &&
                        (!SPARSE || sw.fetch || walk_has(sw, 0, row, col)))) {
              if (tb) s[j][e] += tb[row * p.bsq + col * p.bsk];
            } else {
              s[j][e] = MASK_VALUE;
              vis &= ~(1u << (4 * j + e));
            }
          }
      }

      float m_new[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        m_new[0] = fmaxf(m_new[0], fmaxf(s[j][0], s[j][1]));
        m_new[1] = fmaxf(m_new[1], fmaxf(s[j][2], s[j][3]));
      }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_new[r] = quad_max(m_new[r]);
        alpha[r] = Mma::exp(m[r] - m_new[r]);
        m[r] = m_new[r];
      }
      if (form_p) {  // a pre-pass step stops at the row max
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pj = (vis >> (4 * j + e)) & 1u ? Mma::exp(s[j][e] - m_new[e >> 1]) : 0.f;
            const float pr = Mma::round_p(pj);
            rs[e >> 1] += sum_rounded ? pr : pj;
            s[j][e] = pr;
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];
        scale_rows(acc, alpha);
        Mma::template grad<KT, NA>(acc, s, cV, LD, 0, lane);
      } else if constexpr (RING) {  // the ring's pre-pass follows earlier groups' P·V
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] *= alpha[r];
        scale_rows(acc, alpha);
      }
    }
    __syncthreads();  // this buffer is refilled two steps on
    if constexpr (RING) walk.next();
    if constexpr (SPARSE) w_cur = w_nxt;
  }

  if constexpr (RING) {
    // Merge this step's (o_step, lse_step) into the running (o, lse), or
    // write them at the rank's first step; o in its own type.
    Tout* o = static_cast<Tout*>(p.out) + ((long long)b * p.Hq + h) * p.Sq * p.D;
    float* lse = p.lse + ((long long)b * p.Hq + h) * p.Sq;
    float prev[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = i ? row1 : row0;
      prev[i] = !p.first && row < p.Sq ? lse[row] : 0.f;
    }
    __syncwarp();  // the quad has read its rows' old LSE before the owner writes
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = i ? row1 : row0;
      const float lsum = quad_sum(l[i]);
      if (row >= p.Sq) continue;
      const bool empty = lsum == 0.f;
      const float l_safe = empty ? 1.f : lsum;
      const float lse_step = empty ? MASK_VALUE : m[i] + logf(l_safe);
      float w1 = 0.f, w2 = 1.f, lse_new = lse_step;
      if (!p.first) {
        const float m2 = fmaxf(prev[i], lse_step);
        w1 = expf(prev[i] - m2);
        w2 = expf(lse_step - m2);
        const float denom = w1 + w2;
        const float safe = denom == 0.f ? 1.f : denom;
        w1 /= safe;
        w2 /= safe;
        lse_new = m2 + logf(safe);
      }
#pragma unroll
      for (int n = 0; n < NA; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * n + 2 * tq + c;
          if (col >= p.D) continue;
          const long long idx = (long long)row * p.D + col;
          const float o_step = acc[n][2 * i + c] / l_safe;
          Elem<Tout>::store(o, idx, p.first ? o_step : Elem<Tout>::load(o, idx) * w1 + o_step * w2);
        }
      if (tq == 0) lse[row] = lse_new;
    }
  } else {
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
}

template <class Mma, typename Tout, int DP, bool RING = false, bool SPARSE = false,
          bool ROPE = false>
cudaError_t launch_fwd_tc(const FwdParams& p, cudaStream_t stream) {
  using G = FwdTile<DP, Mma, RING || SPARSE>;
  constexpr int smem = G::SMEM;
  const auto kernel = fwd_tc_kernel<Mma, Tout, DP, RING, SPARSE, ROPE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  constexpr int bq = G::BQ, nt = G::NT;
  const dim3 grid((p.Sq + bq - 1) / bq, p.Hq, p.B);
  kernel<<<grid, nt, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace umfa
