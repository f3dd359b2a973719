// Tensor-core bodies of the dense attention at head dims above 256 for
// Hopper, sm_90a: the forward (`fwd_wide_kernel`, a row-max pass and a
// column-slice pass; csrc/flash_fwd.cu), dQ (`dq_wide_kernel`) and dK/dV
// (`dkv_wide_kernel`; csrc/flash_bwd.cu). The D <= 256 bodies (fwd_tc.cuh,
// bwd_tc.cuh) keep whole rows of Q, K or V and an output row's every column
// in one block; at D 512 a 64-row bf16 Q tile alone takes 64 KB and one
// warp's 16 output rows 256 fp32 registers a thread, and at D 1024 nothing
// resident fits. So these bodies hold no operand row across the depth in
// registers, and none in shared memory unless it fits:
//   * every score product (S = Q·Kᵀ, dP = dO·Vᵀ, and their transposes in
//     dK/dV) is built up through the depth in chunks (`WideDims`), each
//     chunk of both operands copied by cp.async into a ring of buffers
//     ahead of its step, so shared memory does not grow with D; the
//     forward keeps its 64-row Q tile resident for the whole walk where
//     that fits a block (bf16 D <= 1280, fp32 D <= 640: `resident`) and
//     streams only K's chunks then;
//   * each block owns one slice of at most DW output columns (of O, dQ, or
//     dK and dV) and recomputes the scores over the full depth for it, so
//     registers do not grow with D either; the slices of a row compute the
//     same S, P (and dP) in the same order and agree bit for bit;
//   * the forward's P is rounded against the row's final max, found by a
//     first launch (the row-max pass, K only) that writes it to a scratch
//     row; the slice pass then sums l = Σ P in fp32 (the D >= 128 rule) and
//     slice 0 alone writes the LSE. A row that sees no key keeps the mask
//     value as its max, l = 0: out exactly 0, LSE -1e30.
// The softmax scale is formed on the product's fragments as they are
// loaded (bf16(q·scale) under Bf16Mma, fl(q·scale) before the split under
// Tf32x3Mma), as flash_dbias.cu does; dK takes the raw Q, scale on its
// accumulator. Each slice tile of the output product (V for P·V, K for
// dS·K, Q and dO for dK and dV) is copied with the first chunk of its step,
// into one of two slice buffers, and read by the D <= 256 bodies' own
// product code (mma_policy.cuh `grad`, `grads`).
//
// What bounds it: at the FLUX VAE mid-block (B1 H1 S16384 D512, bf16,
// non-causal) the forward is 4·S²·D = 5.50e11 flop, 0.556 ms of bf16
// tensor-core time, dQ 6·S²·D and dK/dV 8·S²·D; the reads are tens of MB.
// This design spends more than that on purpose: the row-max pass and each
// slice form S again (the forward does 2·S²·D·(1 + slices) + 2·S²·D, twice
// its bound at D 512 in bf16), and every chunk of K and V (of Q and dO in
// the backward) is read again from L2 for each tile it meets. A simple
// kernel first: wgmma (a warpgroup holds a 64 x 256 fp32 tile in 128
// registers a thread, so one block would form S once for two slices) and
// TMA are later work.
//
// fp32 (and fp16, computed as fp32) run 3xTF32 (Tf32x3Mma): each chunk's
// big·big products go into one zeroed fragment and the small ones into
// another, 4 steps of 8 each (QK_CHAIN), both put on the scores by fp32
// adds, so no mma chain grows with D; the output products keep the
// policy's one-tile chains.
#pragma once

#include "bwd_tc.cuh"

namespace umfa {

// The arguments of the wide bodies.
struct WideParams {
  const void* q;     // (B, Hq, Sq, D)
  const void* k;     // (B, Hkv, Sk, D)
  const void* v;
  const void* dout;  // backward: (B, Hq, Sq, D) in V's type
  float* lse;        // forward: written (B, Hq, Sq); backward: read (+1e30 on empty rows)
  const float* delta;  // backward: (B, Hq, Sq)
  const float* bias;   // fp32, four element strides (0 = broadcast), or null
  float* mrow;         // forward: the row max, (B, Hq, Sq) fp32 scratch
  void* out0;          // out, dQ or dK
  void* out1;          // dV
  int B, Hq, Hkv, Sq, Sk, D;
  long long bsb, bsh, bsq, bsk;
  float scale;
  int left, right;
  int vec;       // rows by 16-byte cp.async (D and every row pointer allow it)
  int out_bf16;  // the outputs' type: 1 bf16, 0 fp32
  int qres;      // forward: the block's Q tile resident over the whole depth (set by the launcher)
};

__device__ __forceinline__ void store_out(void* base, long long i, float x, int bf16) {
  if (bf16)
    Elem<__nv_bfloat16>::store(static_cast<__nv_bfloat16*>(base), i, x);
  else
    Elem<float>::store(static_cast<float*>(base), i, x);
}

// One depth chunk of a score product for one warp's 16 rows:
//   s += A·Bᵀ over the W columns of the chunk, A rows [r0, r0 + 16) of a
//   tile stored [row][d] (row stride lda), B the NB rows of a tile stored
//   [n][d] (row stride ldb); SA (SB): A's (B's) values times `scale`, rounded to the operand
//   type once, on the fragments.
template <class Mma>
struct WideChunk;

template <>
struct WideChunk<Bf16Mma> {
  using T = __nv_bfloat16;
  template <int W, int NB, bool SA, bool SB>
  static __device__ __forceinline__ void product(float (&s)[NB / 8][4], const T* a, int lda,
                                                 const T* b, int ldb, int r0, float scale,
                                                 int lane) {
#pragma unroll
    for (int ks = 0; ks < W / 16; ++ks) {
      uint32_t x[4];
      load_a(x, a, lda, r0, ks * 16, lane);
      if constexpr (SA) {
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = scale_bf16x2(x[i], scale);
      }
#pragma unroll
      for (int jj = 0; jj < NB / 16; ++jj) {
        uint32_t y0[2], y1[2];
        load_b_nk(y0, y1, b, ldb, jj * 16, ks * 16, lane);
        if constexpr (SB) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            y0[i] = scale_bf16x2(y0[i], scale);
            y1[i] = scale_bf16x2(y1[i], scale);
          }
        }
        mma_bf16(s[2 * jj], x, y0);
        mma_bf16(s[2 * jj + 1], x, y1);
      }
    }
  }
};

template <>
struct WideChunk<Tf32x3Mma> {
  using M = Tf32x3Mma;
  template <int N, bool S>
  static __device__ __forceinline__ void split(Tf32Split<N>& f, const uint32_t (&w)[N],
                                               float scale) {
    float x[N];
#pragma unroll
    for (int i = 0; i < N; ++i)
      x[i] = S ? __fmul_rn(__uint_as_float(w[i]), scale) : __uint_as_float(w[i]);
    split_tf32(f, x);
  }

  // Each QK_CHAIN 8-deep steps: big·big into one zeroed fragment, the small
  // products into another, each put on s by an fp32 add.
  template <int W, int NB, bool SA, bool SB>
  static __device__ __forceinline__ void product(float (&s)[NB / 8][4], const float* a, int lda,
                                                 const float* b, int ldb, int r0, float scale,
                                                 int lane) {
    static_assert(W % (8 * M::QK_CHAIN) == 0, "a chunk is whole chains of big·big steps");
#pragma unroll
    for (int k0 = 0; k0 < W / 8; k0 += M::QK_CHAIN)
      chain<NB, SA, SB>(s, a, lda, b, ldb, r0, scale, lane, k0);
  }

  template <int NB, bool SA, bool SB>
  static __device__ __forceinline__ void chain(float (&s)[NB / 8][4], const float* a, int lda,
                                               const float* b, int ldb, int r0, float scale,
                                               int lane, int k0) {
    float hi[NB / 8][4], lo[NB / 8][4];
#pragma unroll
    for (int j = 0; j < NB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) hi[j][e] = lo[j][e] = 0.f;
#pragma unroll
    for (int ks = k0; ks < k0 + M::QK_CHAIN; ++ks) {
      uint32_t w[4];
      load_a(w, M::b16(a), 2 * lda, r0, ks * 16, lane);
      Tf32Split<4> x;
      split<4, SA>(x, w, scale);
#pragma unroll
      for (int jj = 0; jj < NB / 16; ++jj) {
        uint32_t w0[2], w1[2];
        load_b_nk(w0, w1, M::b16(b), 2 * ldb, jj * 16, ks * 16, lane);
        Tf32Split<2> y0, y1;
        split<2, SB>(y0, w0, scale);
        split<2, SB>(y1, w1, scale);
        M::mma_hi_lo(hi[2 * jj], lo[2 * jj], x, y0);
        M::mma_hi_lo(hi[2 * jj + 1], lo[2 * jj + 1], x, y1);
      }
    }
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
      M::add_into(s[j], hi[j]);
      M::add_into(s[j], lo[j]);
    }
  }
};

// load_tile (bwd_tc.cuh) with a row stride known only at run time.
template <int ROWS, int W, typename T>
__device__ __forceinline__ void load_tile_ld(T* dst, int ld, const T* src, int n, int D, int c0,
                                             bool vec) {
  constexpr int E = 16 / (int)sizeof(T), CH = W / E;
  for (int e = threadIdx.x; e < ROWS * CH; e += blockDim.x) {
    const int r = e / CH, c = (e - r * CH) * E, col = c0 + c;
    T* d = dst + r * ld + c;
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

// Depth chunk and slice width of the wide bodies by product policy (the
// plan `umfa_flash_wide_plan` reports). DC, FWD_DC: columns of a chunk (a
// 16-byte multiple of elements; fp32 whole QK_CHAIN chains); DW: output
// columns of a slice, as many as one warp's 16 rows hold in fp32 registers
// beside the scores (256 for the bf16 forward and dQ, 128 for fp32 and for
// dK/dV, which holds two of them).
template <class Mma>
struct WideDims {
  static constexpr bool F32 = sizeof(typename Mma::T) == 4;
  static constexpr int DC = F32 ? 32 : 64;          // dQ, dK/dV
  static constexpr int FWD_DC = F32 ? 64 : 128;     // the forward (three buffers)
  static constexpr int DW = F32 ? 128 : 256;        // the forward, dQ
  static constexpr int DKV_DW = 128;
};

// ---- Forward ---------------------------------------------------------------
//
// One block of 4 warps per (64-row query tile, column slice, q head, batch;
// the last query tiles first), warp w rows 16w..16w+15. Steps walk the
// visible key tiles of KT keys and, inside each, the depth chunks; a step's
// buffer (one of three, copied two steps ahead) holds the chunk of the K
// tile and, unless the Q tile is resident (copied whole with step 0), of
// the Q tile; at a tile's first chunk the tile's V slice goes into one of
// two buffers of its own. STATS: the row-max pass (no V, no slices): m =
// max over the visible scores (bias included), written to mrow. Otherwise: P = exp(S − m) against that final
// max, l += P (fp32), acc += round(P)·V_slice at each tile's last chunk.
template <class Mma>
struct WideFwdTile {
  using T = typename Mma::T;
  static constexpr int KT = 32;  // keys a tile (64 spilled the bf16 slice pass at 255 registers)
  static constexpr int DC = WideDims<Mma>::FWD_DC, DW = WideDims<Mma>::DW;
  static constexpr int LDC = DC + Mma::PAD, LDS = DW + Mma::PAD;
  static constexpr int NBUF = 3;                        // chunk buffers: copies two steps ahead
  static constexpr int QC = 64 * LDC * (int)sizeof(T);  // a Q chunk
  static constexpr int KC = KT * LDC * (int)sizeof(T);  // a K chunk
  static constexpr int CHUNK = QC + KC;                 // a step's buffer: Q and K chunks
  static constexpr int VS = KT * LDS * (int)sizeof(T);  // a V slice
  // The row stride of a resident Q tile at head dim D: whole chunks, padded.
  static __host__ __device__ constexpr int ldq(int D) { return (D + DC - 1) / DC * DC + Mma::PAD; }
  // Dynamic shared memory of a pass (STATS: no V slices) at head dim D:
  // with the Q tile resident where that fits a block (its chunks then
  // leave the step buffers, and L2 serves Q once a block instead of once a
  // key tile; the slice pass holds one block an SM instead of two), else
  // with Q streamed (112,128 bytes, two blocks an SM).
  static __host__ __device__ constexpr int smem(int D, bool stats, bool qres) {
    return qres ? 64 * ldq(D) * (int)sizeof(T) + NBUF * KC + (stats ? 0 : 2 * VS)
                : NBUF * CHUNK + (stats ? 0 : 2 * VS);
  }
  static __host__ __device__ constexpr bool resident(int D) {
    return smem(D, false, true) <= 232448;
  }
};

template <class Mma, bool STATS>
__global__ void __launch_bounds__(NT, STATS ? 3 : 2) fwd_wide_kernel(const WideParams p) {
  using G = WideFwdTile<Mma>;
  using T = typename Mma::T;
  constexpr int KT = G::KT, DC = G::DC, DW = G::DW, LDC = G::LDC, LDS = G::LDS;
  constexpr int NS = KT / 8;  // 8-key tiles of S
  constexpr int NA = DW / 8;  // 8-column tiles of the out slice
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [NBUF step buffers][2 V slices (not STATS)][the resident Q tile (qres)]
  const int step_bytes = p.qres ? G::KC : G::CHUNK;
  T* sV = reinterpret_cast<T*>(smem_raw + G::NBUF * step_bytes);
  T* sQ = sV + (STATS ? 0 : 2 * KT * LDS);
  const int ldq = G::ldq(p.D);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int nsl = STATS ? 1 : (p.D + DW - 1) / DW;
  const int q0 = ((p.Sq + 63) / 64 - 1 - (int)blockIdx.x / nsl) * 64;
  const int slice = blockIdx.x % nsl, c0 = slice * DW;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long qbh = (long long)b * p.Hq + h;
  const long long kbh = (long long)b * p.Hkv + h / (p.Hq / p.Hkv);
  const T* q = static_cast<const T*>(p.q) + (qbh * p.Sq + q0) * p.D;
  const T* k = static_cast<const T*>(p.k) + kbh * p.Sk * p.D;
  const T* v = static_cast<const T*>(p.v) + kbh * p.Sk * p.D;
  const float* bias = p.bias ? p.bias + b * p.bsb + h * p.bsh : nullptr;
  const int nq = min(64, p.Sq - q0);

  int k_lo, k_hi;
  visible_keys(q0, q0 + nq - 1, p.Sk, p.left, p.right, &k_lo, &k_hi);
  const int t_lo = k_lo / KT;
  const int n_t = k_hi >= k_lo ? k_hi / KT - t_lo + 1 : 0;
  const int n_c = (p.D + DC - 1) / DC;
  const int steps = n_t * n_c;

  // Step i (tile i / n_c, chunk i % n_c) into buffer i % NBUF. A tile's V
  // slice is copied with its first chunk, two steps ahead: after the tile
  // two before it (n_c >= 2) read that slice buffer last.
  auto issue = [&](int i) {
    const int t = i / n_c, c = i - t * n_c, k0 = (t_lo + t) * KT, nk = min(KT, p.Sk - k0);
    T* buf = reinterpret_cast<T*>(smem_raw + (i % G::NBUF) * step_bytes);
    if (!p.qres) {
      load_tile<64, DC, LDC>(buf, q, nq, p.D, c * DC, p.vec);
      buf += 64 * LDC;
    }
    load_tile<KT, DC, LDC>(buf, k + (long long)k0 * p.D, nk, p.D, c * DC, p.vec);
    if (!STATS && c == 0)
      load_tile<KT, DW, LDS>(sV + (t & 1) * KT * LDS, v + (long long)k0 * p.D, nk, p.D, c0,
                             p.vec);
  };

  const int rw = warp * 16;                       // the warp's first row in the tile
  const int row0 = q0 + rw + g, row1 = row0 + 8;  // this thread's two rows
  float m[2] = {MASK_VALUE, MASK_VALUE}, l[2] = {0.f, 0.f};
  if constexpr (!STATS) {
    m[0] = row0 < p.Sq ? p.mrow[qbh * p.Sq + row0] : MASK_VALUE;
    m[1] = row1 < p.Sq ? p.mrow[qbh * p.Sq + row1] : MASK_VALUE;
  }
  float acc[STATS ? 1 : NA][4];
#pragma unroll
  for (int n = 0; n < (STATS ? 1 : NA); ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float s[NS][4];

  if (steps > 0) {
    if (p.qres) {  // the whole Q tile, with step 0
      for (int c = 0; c < n_c; ++c) load_tile_ld<64, DC>(sQ + c * DC, ldq, q, nq, p.D, c * DC, p.vec);
    }
    issue(0);
  }
  cp_async_commit();
  if (steps > 1) issue(1);
  cp_async_commit();
  for (int i = 0; i < steps; ++i) {
    const int t = i / n_c, c = i - t * n_c, k0 = (t_lo + t) * KT;
    if (i + 2 < steps) issue(i + 2);
    cp_async_commit();
    cp_async_wait<2>();
    __syncthreads();  // step i landed
    const T* buf = reinterpret_cast<const T*>(smem_raw + (i % G::NBUF) * step_bytes);
    const T* qa = p.qres ? sQ + c * DC : buf;  // this step's Q chunk
    const T* kb = p.qres ? buf : buf + 64 * LDC;

    // Rows rw..rw+15 against keys k0..k0+KT-1: none visible, all visible
    // (and all rows real), or an edge.
    const int r_lo = q0 + rw, r_hi = r_lo + 15;
    const bool none = r_lo >= p.Sq || (p.right >= 0 && k0 > r_hi + p.right) ||
                      (p.left >= 0 && k0 + KT - 1 < r_lo - p.left);
    const bool all = k0 + KT <= p.Sk && r_hi < p.Sq &&
                     (p.right < 0 || k0 + KT - 1 <= r_lo + p.right) &&
                     (p.left < 0 || k0 >= r_hi - p.left);
    if (c == 0) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    }
    if (!none)  // the same products in both passes, so the same S
      WideChunk<Mma>::template product<DC, KT, true, false>(s, qa, p.qres ? ldq : LDC, kb, LDC,
                                                            rw, p.scale, lane);
    if (c == n_c - 1 && !none) {
      // Element (j, e): row e < 2 ? row0 : row1, key k0 + 8j + 2tq + (e & 1).
      unsigned vis = 0xffffffffu;
      if (!all || bias) {
#pragma unroll
        for (int j = 0; j < NS; ++j)
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
      if constexpr (STATS) {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          m[0] = fmaxf(m[0], fmaxf(s[j][0], s[j][1]));
          m[1] = fmaxf(m[1], fmaxf(s[j][2], s[j][3]));
        }
      } else {
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pj = (vis >> (4 * j + e)) & 1u ? Mma::exp(s[j][e] - m[e >> 1]) : 0.f;
            l[e >> 1] += pj;  // the fp32 P (D >= 128)
            s[j][e] = Mma::round_p(pj);
          }
        Mma::template grad<KT, NA>(acc, s, sV + (t & 1) * KT * LDS, LDS, 0, lane);
      }
    }
    __syncthreads();  // this buffer is refilled at the next step's top
  }

  if constexpr (STATS) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? row1 : row0;
      const float mx = quad_max(m[r]);
      if (row < p.Sq && tq == 0) p.mrow[qbh * p.Sq + row] = mx;
    }
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? row1 : row0;
      const float lsum = quad_sum(l[r]);
      if (row >= p.Sq) continue;
      const bool empty = lsum == 0.f;
      const float l_safe = empty ? 1.f : lsum;
      const long long base = (qbh * p.Sq + row) * p.D;
#pragma unroll
      for (int n = 0; n < NA; ++n)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int col = c0 + 8 * n + 2 * tq + cc;
          if (col < p.D) store_out(p.out0, base + col, acc[n][2 * r + cc] / l_safe, p.out_bf16);
        }
      if (slice == 0 && tq == 0) p.lse[qbh * p.Sq + row] = empty ? MASK_VALUE : m[r] + logf(l_safe);
    }
  }
}

// The two launches of the wide forward: the row-max pass, then the slices.
template <class Mma>
cudaError_t launch_fwd_wide(WideParams p, cudaStream_t stream) {
  using G = WideFwdTile<Mma>;
  const auto stats = fwd_wide_kernel<Mma, true>;
  const auto slices = fwd_wide_kernel<Mma, false>;
  if (p.D <= G::DC) return cudaErrorInvalidValue;  // the V slices' reuse needs two chunks a tile
  p.qres = G::resident(p.D);
  const int smem_stats = G::smem(p.D, true, p.qres), smem = G::smem(p.D, false, p.qres);
  cudaError_t err =
      cudaFuncSetAttribute(stats, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_stats);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(slices, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nqt = (p.Sq + 63) / 64, nsl = (p.D + G::DW - 1) / G::DW;
  stats<<<dim3(nqt, p.Hq, p.B), NT, smem_stats, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  slices<<<dim3(nqt * nsl, p.Hq, p.B), NT, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---- dQ ----------------------------------------------------------------------
//
// One block of 4 warps per (64-row query tile, dQ column slice, q head,
// batch; the last query tiles first), warp w rows 16w..16w+15. Steps walk
// the visible key tiles of KT keys and their depth chunks: chunks of Q, dO
// (64 rows), K and V (KT rows); at a tile's first chunk its K slice goes
// into its own buffer. At a tile's last chunk: P = exp(S + bias − LSE),
// dS = P∘(dP − δ), acc += round(dS)·K_slice; dQ = scale · acc.
template <class Mma>
struct WideDqTile {
  using T = typename Mma::T;
  static constexpr int KT = 32;
  static constexpr int DC = WideDims<Mma>::DC, DW = WideDims<Mma>::DW;
  static constexpr int LDC = DC + Mma::PAD, LDS = DW + Mma::PAD;
  static constexpr int QC = 64 * LDC * (int)sizeof(T), KC = KT * LDC * (int)sizeof(T);
  static constexpr int CHUNK = 2 * QC + 2 * KC;  // Q, dO, K, V chunks
  static constexpr int KS = KT * LDS * (int)sizeof(T);  // a K slice
  static constexpr int ROWS = 2 * 64 * 4;               // LSE, δ
  static constexpr int SMEM = ROWS + 2 * CHUNK + 2 * KS;
};

template <class Mma>
__global__ void __launch_bounds__(NT, 2) dq_wide_kernel(const WideParams p) {
  using G = WideDqTile<Mma>;
  using T = typename Mma::T;
  constexpr int KT = G::KT, DC = G::DC, DW = G::DW, LDC = G::LDC, LDS = G::LDS;
  constexpr int NS = KT / 8, NA = DW / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sRow = reinterpret_cast<float*>(smem_raw);  // LSE [64], δ [64]
  unsigned char* chunks = smem_raw + G::ROWS;        // [2][CHUNK]
  T* sKs = reinterpret_cast<T*>(chunks + 2 * G::CHUNK);  // [2][KT][LDS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int nsl = (p.D + DW - 1) / DW;
  const int q0 = ((p.Sq + 63) / 64 - 1 - (int)blockIdx.x / nsl) * 64;
  const int c0 = (blockIdx.x % nsl) * DW;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long qbh = (long long)b * p.Hq + h;
  const long long kbh = (long long)b * p.Hkv + h / (p.Hq / p.Hkv);
  const T* q = static_cast<const T*>(p.q) + (qbh * p.Sq + q0) * p.D;
  const T* dout = static_cast<const T*>(p.dout) + (qbh * p.Sq + q0) * p.D;
  const T* k = static_cast<const T*>(p.k) + kbh * p.Sk * p.D;
  const T* v = static_cast<const T*>(p.v) + kbh * p.Sk * p.D;
  const float* bias = p.bias ? p.bias + b * p.bsb + h * p.bsh : nullptr;
  const int nq = min(64, p.Sq - q0);

  int k_lo, k_hi;
  visible_keys(q0, q0 + nq - 1, p.Sk, p.left, p.right, &k_lo, &k_hi);
  const int t_lo = k_lo / KT;
  const int n_t = k_hi >= k_lo ? k_hi / KT - t_lo + 1 : 0;
  const int n_c = (p.D + DC - 1) / DC;
  const int steps = n_t * n_c;

  auto issue = [&](int i) {
    const int t = i / n_c, c = i - t * n_c, k0 = (t_lo + t) * KT, nk = min(KT, p.Sk - k0);
    T* buf = reinterpret_cast<T*>(chunks + (i & 1) * G::CHUNK);
    load_tile<64, DC, LDC>(buf, q, nq, p.D, c * DC, p.vec);
    load_tile<64, DC, LDC>(buf + 64 * LDC, dout, nq, p.D, c * DC, p.vec);
    load_tile<KT, DC, LDC>(buf + 128 * LDC, k + (long long)k0 * p.D, nk, p.D, c * DC, p.vec);
    load_tile<KT, DC, LDC>(buf + (128 + KT) * LDC, v + (long long)k0 * p.D, nk, p.D, c * DC,
                           p.vec);
    if (c == 0)
      load_tile<KT, DW, LDS>(sKs + (t & 1) * KT * LDS, k + (long long)k0 * p.D, nk, p.D, c0,
                             p.vec);
  };

  for (int r = tid; r < 64; r += NT) {
    sRow[r] = r < nq ? p.lse[qbh * p.Sq + q0 + r] : 0.f;
    sRow[64 + r] = r < nq ? p.delta[qbh * p.Sq + q0 + r] : 0.f;
  }
  if (steps > 0) issue(0);
  cp_async_commit();

  const int rw = warp * 16, row0 = q0 + rw + g, row1 = row0 + 8;
  float acc[NA][4];
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float s[NS][4], dp[NS][4];

  for (int i = 0; i < steps; ++i) {
    const int t = i / n_c, c = i - t * n_c, k0 = (t_lo + t) * KT;
    if (i + 1 < steps) issue(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // step i landed (and, at step 0, the rows)
    const T* buf = reinterpret_cast<const T*>(chunks + (i & 1) * G::CHUNK);

    const int r_lo = q0 + rw, r_hi = r_lo + 15, ke = k0 + KT - 1;
    const bool none = r_lo >= p.Sq || (p.right >= 0 && k0 > r_hi + p.right) ||
                      (p.left >= 0 && ke < r_lo - p.left);
    const bool all = r_hi < p.Sq && ke < p.Sk && (p.right < 0 || ke <= r_lo + p.right) &&
                     (p.left < 0 || k0 >= r_hi - p.left);
    if (c == 0) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
    if (!none) {
      WideChunk<Mma>::template product<DC, KT, true, false>(s, buf, LDC, buf + 128 * LDC, LDC,
                                                            rw, p.scale, lane);
      WideChunk<Mma>::template product<DC, KT, false, false>(dp, buf + 64 * LDC, LDC,
                                                             buf + (128 + KT) * LDC, LDC, rw,
                                                             1.f, lane);
    }
    if (c == n_c - 1 && !none) {
      const float lse[2] = {sRow[rw + g], sRow[rw + g + 8]};
      const float dlt[2] = {sRow[64 + rw + g], sRow[64 + rw + g + 8]};
      // Element (j, e): row e < 2 ? row0 : row1, key k0 + 8j + 2tq + (e & 1).
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, row = r ? row1 : row0, key = k0 + 8 * j + 2 * tq + (e & 1);
          float ds = 0.f;
          if (all || key_visible(row, key, p.Sq, p.Sk, p.left, p.right)) {
            float x = s[j][e];
            if (bias) x = __fadd_rn(x, bias[row * p.bsq + key * p.bsk]);
            ds = __fmul_rn(expf(x - lse[r]), dp[j][e] - dlt[r]);
          }
          dp[j][e] = ds;
        }
      Mma::template grad<KT, NA>(acc, dp, sKs + (t & 1) * KT * LDS, LDS, 0, lane);
    }
    __syncthreads();  // this buffer is refilled at the next step
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    if (row >= p.Sq) continue;
    const long long base = (qbh * p.Sq + row) * p.D;
#pragma unroll
    for (int n = 0; n < NA; ++n)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int col = c0 + 8 * n + 2 * tq + cc;
        if (col < p.D) store_out(p.out0, base + col, p.scale * acc[n][2 * r + cc], p.out_bf16);
      }
  }
}

template <class Mma>
cudaError_t launch_dq_wide(const WideParams& p, cudaStream_t stream) {
  using G = WideDqTile<Mma>;
  const auto kernel = dq_wide_kernel<Mma>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return err;
  const int nsl = (p.D + G::DW - 1) / G::DW;
  kernel<<<dim3((p.Sq + 63) / 64 * nsl, p.Hq, p.B), NT, G::SMEM, stream>>>(p);
  return cudaGetLastError();
}

// ---- dK/dV -------------------------------------------------------------------
//
// One block of 4 warps per (64-key tile, column slice of dK and dV, kv
// head, batch), warp w keys 16w..16w+15 and their dK and dV slice in fp32
// registers for the whole walk: the query heads of the GQA group in turn,
// each over its visible query tiles of QT rows, each tile over the depth
// chunks (chunks of K and V, 64 rows, and of Q and dO, QT rows); at a
// tile's first chunk its raw Q and dO slices, LSE and δ go into their own
// buffer. With keys as the rows of every product: Sᵀ = K·(Q·scale)ᵀ and
// dPᵀ = V·dOᵀ, then at the tile's last chunk Pᵀ and dSᵀ on the fragments,
// dV += round(Pᵀ)·dO_slice and dK += round(dSᵀ)·Q_slice; dK = scale · dK.
template <class Mma>
struct WideDkvTile {
  using T = typename Mma::T;
  static constexpr int QT = WideDims<Mma>::F32 ? 16 : 32;  // query rows a tile
  static constexpr int DC = WideDims<Mma>::DC, DW = WideDims<Mma>::DKV_DW;
  static constexpr int LDC = DC + Mma::PAD, LDS = DW + Mma::PAD;
  static constexpr int KC = 64 * LDC * (int)sizeof(T), QC = QT * LDC * (int)sizeof(T);
  static constexpr int CHUNK = 2 * KC + 2 * QC;  // K, V, Q, dO chunks
  static constexpr int QS = QT * LDS * (int)sizeof(T);
  static constexpr int SL = 2 * QS + 2 * QT * 4;  // Q, dO slices, LSE, δ
  static constexpr int SMEM = 2 * CHUNK + 2 * SL;
};

template <class Mma>
__global__ void __launch_bounds__(NT, 2) dkv_wide_kernel(const WideParams p) {
  using G = WideDkvTile<Mma>;
  using T = typename Mma::T;
  constexpr int QT = G::QT, DC = G::DC, DW = G::DW, LDC = G::LDC, LDS = G::LDS;
  constexpr int NQ = QT / 8, NA = DW / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* slices = smem_raw + 2 * G::CHUNK;  // [2][SL]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int nsl = (p.D + DW - 1) / DW;
  const int k0 = (int)blockIdx.x / nsl * 64, c0 = (blockIdx.x % nsl) * DW;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = p.Hq / p.Hkv;
  const long long kbh = (long long)b * p.Hkv + hk;
  const T* k = static_cast<const T*>(p.k) + (kbh * p.Sk + k0) * p.D;
  const T* v = static_cast<const T*>(p.v) + (kbh * p.Sk + k0) * p.D;
  const int nk = min(64, p.Sk - k0);

  int q_lo, q_hi;
  visible_queries(k0, k0 + nk - 1, p.Sq, p.left, p.right, &q_lo, &q_hi);
  const int t_lo = q_lo / QT;
  const int n_t = q_hi >= q_lo ? q_hi / QT - t_lo + 1 : 0;
  const int n_c = (p.D + DC - 1) / DC;
  const int steps = group * n_t * n_c;  // (head, query tile, chunk), head-major
  auto head_of = [&](int u) { return (long long)b * p.Hq + hk * group + u / n_t; };
  auto q0_of = [&](int u) { return (t_lo + u % n_t) * QT; };

  auto issue = [&](int i) {
    const int u = i / n_c, c = i - u * n_c, q0 = q0_of(u), n = min(QT, p.Sq - q0);
    const long long r0 = head_of(u) * p.Sq + q0;
    T* buf = reinterpret_cast<T*>(smem_raw + (i & 1) * G::CHUNK);
    load_tile<64, DC, LDC>(buf, k, nk, p.D, c * DC, p.vec);
    load_tile<64, DC, LDC>(buf + 64 * LDC, v, nk, p.D, c * DC, p.vec);
    load_tile<QT, DC, LDC>(buf + 128 * LDC, static_cast<const T*>(p.q) + r0 * p.D, n, p.D,
                           c * DC, p.vec);
    load_tile<QT, DC, LDC>(buf + (128 + QT) * LDC, static_cast<const T*>(p.dout) + r0 * p.D, n,
                           p.D, c * DC, p.vec);
    if (c == 0) {
      unsigned char* sl = slices + (u & 1) * G::SL;
      load_tile<QT, DW, LDS>(reinterpret_cast<T*>(sl), static_cast<const T*>(p.q) + r0 * p.D, n,
                             p.D, c0, p.vec);
      load_tile<QT, DW, LDS>(reinterpret_cast<T*>(sl + G::QS),
                             static_cast<const T*>(p.dout) + r0 * p.D, n, p.D, c0, p.vec);
      load_rows_f32<QT>(reinterpret_cast<float*>(sl + 2 * G::QS), p.lse + r0, n);
      load_rows_f32<QT>(reinterpret_cast<float*>(sl + 2 * G::QS + QT * 4), p.delta + r0, n);
    }
  };

  const int kr = warp * 16, key0 = k0 + kr + g, key1 = key0 + 8;  // this thread's two keys
  float dk[NA][4], dv[NA][4];
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  float s[NQ][4], dp[NQ][4];

  if (steps > 0) issue(0);
  cp_async_commit();
  for (int i = 0; i < steps; ++i) {
    const int u = i / n_c, c = i - u * n_c, q0 = q0_of(u);
    if (i + 1 < steps) issue(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // step i landed
    const T* buf = reinterpret_cast<const T*>(smem_raw + (i & 1) * G::CHUNK);

    // This warp's keys [kw, kw + 15] against queries [q0, q0 + QT).
    const int kw = k0 + kr, qe = q0 + QT - 1;
    const bool none = kw >= p.Sk || q0 >= p.Sq || (p.right >= 0 && kw > qe + p.right) ||
                      (p.left >= 0 && kw + 15 < q0 - p.left);
    const bool all = kw + 15 < p.Sk && qe < p.Sq && (p.right < 0 || kw + 15 <= q0 + p.right) &&
                     (p.left < 0 || kw >= qe - p.left);
    if (c == 0) {
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
    if (!none) {
      WideChunk<Mma>::template product<DC, QT, false, true>(s, buf, LDC, buf + 128 * LDC, LDC,
                                                            kr, p.scale, lane);
      WideChunk<Mma>::template product<DC, QT, false, false>(dp, buf + 64 * LDC, LDC,
                                                             buf + (128 + QT) * LDC, LDC, kr,
                                                             1.f, lane);
    }
    if (c == n_c - 1 && !none) {
      const unsigned char* sl = slices + (u & 1) * G::SL;
      const T* qs = reinterpret_cast<const T*>(sl);
      const T* os = reinterpret_cast<const T*>(sl + G::QS);
      const float* lse = reinterpret_cast<const float*>(sl + 2 * G::QS);
      const float* dlt = lse + QT;
      const long long qbh = head_of(u);
      const float* bias =
          p.bias ? p.bias + b * p.bsb + (qbh - (long long)b * p.Hq) * p.bsh : nullptr;
      // Element (j, e): key e < 2 ? key0 : key1, query q0 + 8j + 2tq + (e & 1).
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = e < 2 ? key0 : key1, qi = 8 * j + 2 * tq + (e & 1), row = q0 + qi;
          float pr = 0.f, ds = 0.f;
          if (all || key_visible(row, key, p.Sq, p.Sk, p.left, p.right)) {
            float x = s[j][e];
            if (bias) x = __fadd_rn(x, bias[row * p.bsq + key * p.bsk]);
            pr = expf(x - lse[qi]);
            ds = __fmul_rn(pr, dp[j][e] - dlt[qi]);
          }
          s[j][e] = pr;
          dp[j][e] = ds;
        }
      Mma::template grads<QT, NA>(dv, dk, s, dp, os, qs, LDS, 0, lane);
    }
    __syncthreads();  // this buffer is refilled at the next step
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r ? key1 : key0;
    if (key >= p.Sk) continue;
    const long long base = (kbh * p.Sk + key) * p.D;
#pragma unroll
    for (int n = 0; n < NA; ++n)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int col = c0 + 8 * n + 2 * tq + cc;
        if (col < p.D) {
          store_out(p.out0, base + col, p.scale * dk[n][2 * r + cc], p.out_bf16);
          store_out(p.out1, base + col, dv[n][2 * r + cc], p.out_bf16);
        }
      }
  }
}

template <class Mma>
cudaError_t launch_dkv_wide(const WideParams& p, cudaStream_t stream) {
  using G = WideDkvTile<Mma>;
  const auto kernel = dkv_wide_kernel<Mma>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return err;
  const int nsl = (p.D + G::DW - 1) / G::DW;
  kernel<<<dim3((p.Sk + 63) / 64 * nsl, p.Hkv, p.B), NT, G::SMEM, stream>>>(p);
  return cudaGetLastError();
}

// Rows by 16-byte cp.async when D is a multiple of 16 bytes' worth of
// elements and every operand is 16-byte aligned; else by element copies
// (load_tile), which zero-pad a ragged last chunk alike.
inline int wide_vec(int D, int elem_bytes, std::initializer_list<const void*> ptrs) {
  return D % (16 / elem_bytes) == 0 && aligned(ptrs, 16);
}

// The plan of a wide body for head dim D (kind 0: forward, 1: dQ, 2:
// dK/dV) on bf16 (bf16 = 1) or fp32 inputs: out[0..3] = depth chunk,
// chunks, slice width, slices; out[4] = dynamic shared memory in bytes.
inline void wide_plan(int D, int kind, int bf16, int* out) {
  int dc = bf16 ? WideDims<Bf16Mma>::DC : WideDims<Tf32x3Mma>::DC;
  int dw, smem;
  if (kind == 0) {
    using B = WideFwdTile<Bf16Mma>;
    using F = WideFwdTile<Tf32x3Mma>;
    dc = bf16 ? B::DC : F::DC;
    dw = bf16 ? B::DW : F::DW;
    smem = bf16 ? B::smem(D, false, B::resident(D)) : F::smem(D, false, F::resident(D));
  } else if (kind == 1) {
    dw = bf16 ? WideDqTile<Bf16Mma>::DW : WideDqTile<Tf32x3Mma>::DW;
    smem = bf16 ? WideDqTile<Bf16Mma>::SMEM : WideDqTile<Tf32x3Mma>::SMEM;
  } else {
    dw = bf16 ? WideDkvTile<Bf16Mma>::DW : WideDkvTile<Tf32x3Mma>::DW;
    smem = bf16 ? WideDkvTile<Bf16Mma>::SMEM : WideDkvTile<Tf32x3Mma>::SMEM;
  }
  out[0] = dc;
  out[1] = (D + dc - 1) / dc;
  out[2] = dw;
  out[3] = (D + dw - 1) / dw;
  out[4] = smem;
}

}  // namespace umfa
