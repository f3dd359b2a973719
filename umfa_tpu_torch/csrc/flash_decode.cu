// Flash-decode over the INT8 KV cache, for Hopper, sm_90a: one launch.
//
// Replaces umfa_tpu/serving/decode_kernel.py:38 `_decode_kernel` (host
// `quantized_flash_decode`, decode_kernel.py:118): attention of a few new
// queries per sequence (Tq <= 16, the GQA group folded into R = g·Tq query
// rows) against the whole (B, Hkv, S_max, D) int8 cache with per-row fp32
// scales and an additive length (+ causal) bias.
//
// What bounds it on this card: bytes. Each cache row is D int8 of K and of
// V plus two fp32 scales, against 2·R·D multiply-adds a row for QKᵀ and as
// many for P·V; at the serving geometry (B8 Hkv8 S4096 D64, Tq 1, g 2) one
// call reads ~35.8 MB, ~10.7 us of HBM time.
//
// What this design does about it:
// * Splits in a cluster. One (batch, kv-head) pair alone would give 64
//   blocks for 132 SMs, so the cache rows of each (batch, kv-head, row
//   group) are split over the c blocks (128 threads each) of one thread-
//   block cluster; each block walks `chunk` = ceil(S / c) rows (rounded up
//   to 16; blocks past S walk none). The launch picks c in 1..8 from the
//   occupancy calculator: the c that minimizes waves × rows a block (a
//   cluster's blocks are placed together, so clusters, not blocks, fill
//   the card; at the serving geometry 62 clusters of 8 fit at once at D 64
//   against 64 needed, so c = 7: 448 blocks, one wave).
// * A pipelined walk. A block walks its rows in stages of 64 (16 a warp)
//   through a ring of shared-memory buffers (4 at D <= 64, 3 at D <= 128, 2
//   at D <= 256: 8, 16 or 32 KB of codes a stage) that cp.async fills
//   stages ahead: the stage's K and V rows (16 bytes a copy where rows are
//   16-byte aligned, else 4, else byte loads; each thread the same columns
//   of every few rows), their scales and the stage's bias rows (a thread
//   each), zero-filled past the block's last row. Each warp carries a
//   running (m, l, acc) over its 16 rows of every stage, as the reference's
//   tile walk does over its tiles; acc is rescaled only when a row maximum
//   of the warp moved.
// * Tensor cores. The query rows run in 16-row tiles (RT a block: 2 at R >
//   16 and D <= 128, else 1; rows past a block's RT tiles run in further
//   clusters, each reading the cache again). For bf16 q: mma.sync m16n8k16
//   bf16 -> fp32. QKᵀ takes K's B fragments straight from the int8 stage:
//   a stage row is stored as 64-byte planes (bytes 64c.. of every row in
//   plane c), and lane (g, t) reads 16 bytes of cache row g at byte 16t of
//   a plane, four words of codes, each word one 16-deep step's k indices
//   2t, 2t+1, 2t+8, 2t+9; Q's A fragments take the head dim in the same
//   order (columns 64c + 16t + 4i.. of the Q tile; held in registers at D
//   <= 64, one row tile), which leaves each dot product unchanged. The
//   codes widen to bf16 exactly in registers, with no conversion
//   instruction (two masks and one bf16x2 subtraction a pair). P leaves the
//   score accumulators as A fragments of P·V (`pack_a`); each warp widens
//   its own 16 rows of V, a 64-column plane at a time, into a bf16 tile
//   that ldmatrix.trans reads. Every warp reads only its own rows, so each
//   code is widened once a block. For fp32 q (no driven path: serving is
//   bf16) the same walk runs mma.sync m16n8k8 tf32: q and p·vs split into
//   tf32 big and small parts (the codes are exact in tf32, so two products
//   a term suffice), each K word's four products and each stage's P·V into
//   zeroed fragments added to the scores and to acc by fp32 adds (the
//   tensor cores truncate their sums; the chains stay four mma long).
// * The merge, inside the launch and in a fixed order. After the walk the
//   four warps' states are combined in the block (M_b = max m_w; l_b =
//   Σ e^(m_w - M_b) l_w; acc_b = (acc_0 + acc_1) + (acc_2 + acc_3), each
//   scaled to M_b) in shared memory. After a cluster barrier each block
//   reads the c blocks' (m, l, acc) of its 1/c share of the output
//   elements from their shared memory (distributed shared memory, plain
//   loads through mapped addresses, all in flight together) and writes
//   them, the splits in rank order: M = max m_i, out = Σ e^(m_i - M) acc_i
//   / Σ e^(m_i - M) l_i, a zero sum replaced by 1. A second (relaxed)
//   cluster barrier keeps each block's shared memory alive until its peers
//   have read it. No atomics: two calls on the same inputs give the same
//   bits.
//
// Arithmetic held to the reference (decode_kernel.py:56-115) and to the
// plain version's tile walk: s = (q · widen(k8)) with fp32 sums, then
// s·(ks·scale) + bias with ks·scale formed first, products and sums
// rounded separately (never contracted); m starts at -1e30; p = exp(s -
// m), l sums the fp32 p; P·V uses cdt(p·vs) (the V scale folded into P
// before the rounding to bf16 for bf16 q, none for fp32 q) and the widened
// V; out = acc / l, l = 0 replaced by 1. A slot whose every column carries
// the -1e30 bias (length 0) averages V uniformly over every split, as the
// reference does; rows past S_max count for nothing (p = 0). The one
// difference: for bf16 q, cdt(p·vs) is rounded against the running maximum
// of the warp's walk instead of the tile walk's, so the kernel meets its
// plain version by tolerance (bf16 relerr 1e-2), not bit for bit; fp32
// agrees to rounding order (2e-5).
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

using namespace umfa;

namespace {

constexpr int FD_NT = 128;          // threads a block
constexpr int FD_NW = FD_NT / 32;   // warps a block
constexpr int FD_KT = 64;           // cache rows a stage, 16 a warp
constexpr int FD_SPLIT = 8;         // most blocks a cluster (the portable cluster size)
constexpr int FD_TQ = 16;           // most query positions (Tq) a call
constexpr int FD_LDV = 64 + 8;      // row stride (bf16) of a warp's widened V plane

// Ring depth by template width (the head dim padded to 64, 128 or 256).
template <int DP>
__host__ __device__ constexpr int fd_stages() { return DP <= 64 ? 4 : DP <= 128 ? 3 : 2; }

// Blocks an SM the registers must allow, by the RT·DP/2 accumulators a
// thread holds (128, 168 or 255 registers).
template <int DP, int RT>
__host__ __device__ constexpr int fd_min_blocks() { return RT * DP <= 64 ? 4 : RT * DP <= 128 ? 3 : 2; }

struct DParams {
  const void* q;      // (B, Hkv, R, D) fp32 or bf16, R = g·Tq rows (g, t)
  const int8_t* k;    // (B, Hkv, S, D)
  const float* ks;    // (B, Hkv, S)
  const int8_t* v;
  const float* vs;
  const float* bias;  // element (b, t, j) at b*bsb + t*bst + j*bss
  float* out;         // (B, Hkv, R, D)
  int B, Hkv, R, Tq, S, D;
  long long bsb, bst, bss;
  float scale;
  int chunk;  // cache rows a split walks, a multiple of 16
  int copy;   // how cache rows are copied: 2 by 16 bytes, 1 by 4, 0 by bytes
};

// Byte c of row j of a stage's code tile: plane c / 64 (bytes 64·(c / 64)..
// of every row, row stride 64), so that a warp's 16-byte reads of eight rows
// fall in distinct banks at every head dim.
__device__ __forceinline__ int plane_off(int j, int c) {
  return (c >> 6) * (FD_KT * 64) + j * 64 + (c & 63);
}

// Rows [j0, j0 + n) of one (S, D) int8 matrix into a stage's code tile
// (n >= 1); rows [n, FD_KT) zero-filled. A thread copies the same columns
// of every FD_NT / CH-th row, so no index is divided at run time. Bytes
// past D are left as they are: a code is finite whatever it holds, and the
// Q columns it meets are 0.
template <int DP>
__device__ __forceinline__ void copy_rows(int8_t* dst, const int8_t* src, int j0, int n, int D,
                                          int copy) {
  if (copy == 2) {
    constexpr int CH = DP / 16;  // 16-byte chunks of a padded row
    const int c = 16 * (threadIdx.x % CH);
    const int8_t* s0 = src + (long long)j0 * D + c;
    int8_t* d0 = dst + plane_off(0, c);
    if (c < D) {
#pragma unroll
      for (int j = threadIdx.x / CH; j < FD_KT; j += FD_NT / CH)
        cp_async16(d0 + j * 64, j < n ? s0 + (long long)j * D : s0, j < n ? 16 : 0);
    }
  } else if (copy == 1) {
    constexpr int CH = DP / 4;  // 4-byte words of a padded row
    const int c = 4 * (threadIdx.x % CH);
    const int8_t* s0 = src + (long long)j0 * D + c;
    int8_t* d0 = dst + plane_off(0, c);
    if (c < D) {
#pragma unroll 4
      for (int j = threadIdx.x / CH; j < FD_KT; j += FD_NT / CH)
        cp_async4(d0 + j * 64, j < n ? s0 + (long long)j * D : s0, j < n ? 4 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < FD_KT * D; e += FD_NT) {
      const int j = e / D, c = e - j * D;
      dst[plane_off(j, c)] = j < n ? src[(long long)(j0 + j) * D + c] : int8_t(0);
    }
  }
}

// Two int8 codes of w (bytes 0, 1 with sel 0x4140; bytes 2, 3 with 0x4342)
// as a bf16 pair, the first in the low half, exactly and with no conversion
// instruction: each half becomes 0x43XX, X the code byte; 0x4300 | (X &
// 0x7f) is the bf16 128 + (X & 0x7f), and 0x4300 | (X & 0x80) is 128, or 256
// for a negative code, so their difference is the code.
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t w, uint32_t sel) {
  const uint32_t x = __byte_perm(w, 0x43u, sel);
  const uint32_t hi = x & 0xff7fff7fu, lo = x & 0xff80ff80u;
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&hi),
                                   *reinterpret_cast<const __nv_bfloat162*>(&lo));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// Code e (0..3) of w as fp32 (and tf32: a code has at most 8 significant
// bits), exactly: code + 128 placed in the low mantissa byte of 2^23 is the
// float 2^23 + 128 + code, and one subtraction leaves the code.
constexpr float CODE_BIAS = 8388736.f;  // 2^23 + 128

__device__ __forceinline__ float code_f32(uint32_t w, int e) {
  return __int_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7440u + e)) - CODE_BIAS;
}

__device__ __forceinline__ uint32_t word_of(const int4& x, int i) {
  return static_cast<uint32_t>(i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w);
}

// Rows [0, 16) of a 64-byte code plane (row stride 64) widened into a bf16
// tile of row stride FD_LDV: two 16-byte chunks a lane.
__device__ __forceinline__ void widen_plane(__nv_bfloat16* dst, const int8_t* src, int lane) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int ch = lane + 32 * k, r = ch >> 2, c = 16 * (ch & 3);
    const int4 x = *reinterpret_cast<const int4*>(src + r * 64 + c);
    uint32_t o[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = codes_bf16x2(word_of(x, i), 0x4140u);
      o[2 * i + 1] = codes_bf16x2(word_of(x, i), 0x4342u);
    }
    uint4* d = reinterpret_cast<uint4*>(dst + r * FD_LDV + c);
    d[0] = make_uint4(o[0], o[1], o[2], o[3]);
    d[1] = make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// ---- thread-block clusters (distributed shared memory) ----
// Every block of the cluster has arrived; the shared-memory writes each
// made before it arrived are visible to all.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Every block of the cluster has arrived, with no ordering of memory: what
// a block read of its peers before it arrived has been read (the loaded
// values were used).
__device__ __forceinline__ void cluster_sync_relaxed() {
  asm volatile(
      "barrier.cluster.arrive.relaxed.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The generic address of `p` (in this block's shared memory) in the shared
// memory of block `rank` of the cluster: plain loads through it read the
// peer's copy, and the compiler may keep several in flight.
__device__ __forceinline__ const float* cluster_map(const float* p, int rank) {
  uint64_t a;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(a) : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<const float*>(a);
}

// Shared memory of one launch: the ring, the warps' widened V planes, the
// Q tile (the merge's scratch reuses the ring).
template <int DP, int RT, bool BF16>
int fd_smem_bytes(int tq) {
  const int stage = 2 * FD_KT * DP + (2 + tq) * FD_KT * (int)sizeof(float);
  const int qtile = BF16 ? 16 * RT * (DP + 8) * 2 : 16 * RT * (DP + 4) * 4;
  return fd_stages<DP>() * stage + FD_NW * 16 * FD_LDV * 2 + qtile;
}

// The kernel runs as clusters of gridDim.x blocks (1 to FD_SPLIT, chosen by
// the launch), one cluster per (batch, kv-head, row group).
template <int DP, int RT, bool BF16>
__global__ void __launch_bounds__(FD_NT, (fd_min_blocks<DP, RT>()))
    flash_decode_tc_kernel(const DParams p) {
  constexpr int RB = 16 * RT;        // query rows a block
  constexpr int NA = DP / 8;         // 8-column tiles of out
  constexpr int PLANES = DP / 64;    // 64-byte planes of a code row
  constexpr int NSTAGE = fd_stages<DP>();
  constexpr int LDQ = BF16 ? DP + 8 : DP + 4;
  constexpr bool QREG = BF16 && RT * DP <= 64;  // Q's A fragments held in registers
  using QT = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  static_assert((2 * RB * DP + (2 + 2 * FD_NW) * RB) * 4 <= NSTAGE * 2 * FD_KT * DP,
                "the merge's scratch must fit in the ring");

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x, nsplit = gridDim.x;  // the block's rank in its cluster, its size
  const int nrg = (p.R + RB - 1) / RB;
  const int hk = blockIdx.y / nrg, r0 = (blockIdx.y - hk * nrg) * RB, b = blockIdx.z;
  const int rows = min(RB, p.R - r0);
  const int kbeg = min(p.S, split * p.chunk), kend = min(p.S, kbeg + p.chunk);
  const int nstage = (kend - kbeg + FD_KT - 1) / FD_KT;
  const int stage_bytes = 2 * FD_KT * DP + (2 + p.Tq) * FD_KT * (int)sizeof(float);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw;
  __nv_bfloat16* sVw =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + NSTAGE * stage_bytes) + warp * 16 * FD_LDV;
  QT* sQ = reinterpret_cast<QT*>(smem_raw + NSTAGE * stage_bytes + FD_NW * 16 * FD_LDV * 2);

  const long long bh = (long long)b * p.Hkv + hk;
  const int8_t* kg = p.k + bh * p.S * p.D;
  const int8_t* vg = p.v + bh * p.S * p.D;
  const float* ksg = p.ks + bh * p.S;
  const float* vsg = p.vs + bh * p.S;
  const float* bg = p.bias + b * p.bsb;

  // Stage st: K and V codes, their scales, the Tq bias rows, in flight by
  // cp.async (the caller commits the group). Thread tid copies the scale
  // of row tid % 64 (K's below 64, V's above) and that row's bias in rows
  // tid / 64, tid / 64 + 2, ... of the Tq.
  static_assert(FD_NT == 2 * FD_KT, "a thread per scale of a stage");
  const int jt = tid % FD_KT;
  const float* sc_src = (tid < FD_KT ? ksg : vsg) + kbeg + jt;
  const float* b_src = bg + (long long)(kbeg + jt) * p.bss + (long long)(tid / FD_KT) * p.bst;
  auto load_stage = [&](int st) {
    unsigned char* base = ring + (st % NSTAGE) * stage_bytes;
    int8_t* sK = reinterpret_cast<int8_t*>(base);
    float* sKs = reinterpret_cast<float*>(base + 2 * FD_KT * DP);
    const int j0 = kbeg + st * FD_KT, n = min(FD_KT, kend - j0);
    copy_rows<DP>(sK, kg, j0, n, p.D, p.copy);
    copy_rows<DP>(sK + FD_KT * DP, vg, j0, n, p.D, p.copy);
    const bool ok = jt < n;
    cp_async4(sKs + tid, ok ? sc_src + st * FD_KT : ksg, ok ? 4 : 0);
    const float* bs = b_src + (long long)st * FD_KT * p.bss;
    for (int tt = tid / FD_KT; tt < p.Tq; tt += FD_NT / FD_KT, bs += FD_NT / FD_KT * p.bst)
      cp_async4(sKs + 2 * FD_KT + tt * FD_KT + jt, ok ? bs : bg, ok ? 4 : 0);
  };
#pragma unroll 1
  for (int st = 0; st < NSTAGE - 1; ++st) {
    if (st < nstage) load_stage(st);
    cp_async_commit();
  }

  // The block's query rows as the products take them; rows past `rows`
  // and columns past D are 0.
  {
    const QT* q = static_cast<const QT*>(p.q) + (bh * p.R + r0) * p.D;
    for (int e = tid; e < RB * DP; e += FD_NT) {
      const int r = e / DP, c = e - r * DP;
      sQ[r * LDQ + c] = r < rows && c < p.D ? q[(long long)r * p.D + c] : static_cast<QT>(0.f);
    }
  }
  __syncthreads();

  // The A fragment of 16-deep step ks = 4c + i of the rows of tile rt: lane
  // (g, t) takes columns 64c + 16t + 4i.. of rows g and g + 8, the head dim
  // in the order of the K words (see the header).
  auto q_frag = [&](uint32_t (&a)[4], int rt, int ks) {
    const QT* qr = sQ + (16 * rt + g) * LDQ + 64 * (ks >> 2) + 16 * t + 4 * (ks & 3);
    const uint2 x0 = *reinterpret_cast<const uint2*>(qr);
    const uint2 x1 = *reinterpret_cast<const uint2*>(qr + 8 * LDQ);
    a[0] = x0.x;
    a[1] = x1.x;
    a[2] = x0.y;
    a[3] = x1.y;
  };
  uint32_t qa[QREG ? DP / 16 : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) q_frag(qa[ks], 0, ks);
  }

  // The thread's rows 16 rt + g + 8 i: their bias rows in a stage.
  int brow[RT][2];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int i = 0; i < 2; ++i) brow[rt][i] = ((r0 + 16 * rt + g + 8 * i) % p.Tq) * FD_KT;

  float m[RT][2], l[RT][2], acc[RT][NA][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[rt][i] = MASK_VALUE;
      l[rt][i] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < NA; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[rt][n][e] = 0.f;
  }

#pragma unroll 1
  for (int st = 0; st < nstage; ++st) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // stage st has landed; every warp is done with stage st - 1
    if (st + NSTAGE - 1 < nstage) load_stage(st + NSTAGE - 1);  // into stage st - 1's buffer
    cp_async_commit();
    const int kw = kbeg + st * FD_KT + 16 * warp;  // the warp's first cache row
    if (kw >= kend) continue;

    const unsigned char* base = ring + (st % NSTAGE) * stage_bytes;
    const int8_t* sK = reinterpret_cast<const int8_t*>(base);
    const int8_t* sV = sK + FD_KT * DP;
    const float* sKs = reinterpret_cast<const float*>(base + 2 * FD_KT * DP);
    const float* sVs = sKs + FD_KT;
    const float* sB = sVs + FD_KT;
    const int jb = 16 * warp;  // the warp's first row in the stage

    // S = Q·Kᵀ over the warp's rows: 8-row tile h is cache rows jb + 8h..
    float s[RT][2][4];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[rt][h][e] = 0.f;
#pragma unroll
    for (int c = 0; c < PLANES; ++c) {
      int4 kq[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        kq[h] = *reinterpret_cast<const int4*>(sK + c * FD_KT * 64 + (jb + 8 * h + g) * 64 + 16 * t);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (BF16) {
          uint32_t kb[2][2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            kb[h][0] = codes_bf16x2(word_of(kq[h], i), 0x4140u);
            kb[h][1] = codes_bf16x2(word_of(kq[h], i), 0x4342u);
          }
#pragma unroll
          for (int rt = 0; rt < RT; ++rt) {
            uint32_t a[4];
            if constexpr (QREG) {
#pragma unroll
              for (int e = 0; e < 4; ++e) a[e] = qa[4 * c + i][e];
            } else {
              q_frag(a, rt, 4 * c + i);
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) mma_bf16(s[rt][h], a, kb[h]);
          }
        } else {
          // Word i is two 8-deep steps: codes 0, 1 (k indices t, t + 4) and 2, 3.
          uint32_t kb[2][4];
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) kb[h][e] = __float_as_uint(code_f32(word_of(kq[h], i), e));
#pragma unroll
          for (int rt = 0; rt < RT; ++rt) {
            const QT* qr = sQ + (16 * rt + g) * LDQ + 64 * c + 16 * t + 4 * i;
            const float4 x0 = *reinterpret_cast<const float4*>(qr);
            const float4 x1 = *reinterpret_cast<const float4*>(qr + 8 * LDQ);
            const float q0[4] = {x0.x, x1.x, x0.y, x1.y}, q1[4] = {x0.z, x1.z, x0.w, x1.w};
            Tf32Split<4> a0, a1;
            split_tf32(a0, q0);
            split_tf32(a1, q1);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float d[4] = {0.f, 0.f, 0.f, 0.f};
              const uint32_t b0[2] = {kb[h][0], kb[h][1]}, b1[2] = {kb[h][2], kb[h][3]};
              mma_tf32(d, a0.small, b0);
              mma_tf32(d, a0.big, b0);
              mma_tf32(d, a1.small, b1);
              mma_tf32(d, a1.big, b1);
#pragma unroll
              for (int e = 0; e < 4; ++e) s[rt][h][e] += d[e];
            }
          }
        }
      }
    }

    // s = s·(ks·scale) + bias, rows past the block's last cache row -inf;
    // element (h, e) is row 16 rt + g + 8 (e >> 1), cache row kw + 8h + 2t + (e & 1).
    const bool full = kw + 16 <= kend;
    float vsc[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = jb + 8 * h + 2 * t;
      const float2 k2 = *reinterpret_cast<const float2*>(sKs + j);
      const float2 v2 = *reinterpret_cast<const float2*>(sVs + j);
      const float kscale[2] = {__fmul_rn(k2.x, p.scale), __fmul_rn(k2.y, p.scale)};
      vsc[h][0] = v2.x;
      vsc[h][1] = v2.y;
      const bool ok[2] = {full || kw + 8 * h + 2 * t < kend, full || kw + 8 * h + 2 * t + 1 < kend};
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 bb = *reinterpret_cast<const float2*>(sB + brow[rt][i] + j);
          const float bv[2] = {bb.x, bb.y};
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float& x = s[rt][h][2 * i + u];
            x = ok[u] ? __fadd_rn(__fmul_rn(x, kscale[u]), bv[u]) : -INFINITY;
          }
        }
    }

    // The online softmax update; pv = p·vs (P·V's operand before cdt).
    // acc is rescaled only when a row's maximum moved in some lane of the
    // warp (else every alpha is exactly 1).
    float pv[RT][2][4], alpha[RT][2];
    bool moved = false;
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = fmaxf(fmaxf(s[rt][0][2 * i], s[rt][0][2 * i + 1]),
                         fmaxf(s[rt][1][2 * i], s[rt][1][2 * i + 1]));
        const float m_new = fmaxf(m[rt][i], quad_max(mx));
        moved = moved || m_new != m[rt][i];
        alpha[rt][i] = BF16 ? __expf(m[rt][i] - m_new) : expf(m[rt][i] - m_new);
        m[rt][i] = m_new;
        float rs = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float x = s[rt][h][2 * i + u] - m_new;
            const float pj = BF16 ? __expf(x) : expf(x);
            rs += pj;
            pv[rt][h][2 * i + u] = __fmul_rn(pj, vsc[h][u]);
          }
        l[rt][i] = alpha[rt][i] * l[rt][i] + rs;
      }
    if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int n = 0; n < NA; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[rt][n][e] *= alpha[rt][e >> 1];
    }

    // acc += cdt(pv) · V over the warp's 16 rows, a 64-column plane at a time.
    if constexpr (BF16) {
      uint32_t a[RT][4];
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) pack_a(a[rt], pv[rt][0], pv[rt][1]);
#pragma unroll
      for (int c = 0; c < PLANES; ++c) {
        widen_plane(sVw, sV + c * FD_KT * 64 + jb * 64, lane);
        __syncwarp();
#pragma unroll
        for (int dn = 0; dn < 4; ++dn) {
          uint32_t y0[2], y1[2];
          load_b_kn(y0, y1, sVw, FD_LDV, 0, 16 * dn, lane);
#pragma unroll
          for (int rt = 0; rt < RT; ++rt) {
            mma_bf16(acc[rt][8 * c + 2 * dn], a[rt], y0);
            mma_bf16(acc[rt][8 * c + 2 * dn + 1], a[rt], y1);
          }
        }
        __syncwarp();  // the plane is read before the next one is widened
      }
    } else {
      // Keys permuted inside each 8-row step (`tf32_a_from_c`): logical t is
      // row 2t, t + 4 row 2t + 1; V's B fragment is read in the same order.
      Tf32Split<4> a[RT][2];
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int h = 0; h < 2; ++h) tf32_a_from_c(a[rt][h], pv[rt][h]);
      const unsigned short* vw = reinterpret_cast<const unsigned short*>(sVw);
#pragma unroll
      for (int c = 0; c < PLANES; ++c) {
        widen_plane(sVw, sV + c * FD_KT * 64 + jb * 64, lane);
        __syncwarp();
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          uint32_t y[2][2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            y[h][0] = (uint32_t)vw[(8 * h + 2 * t) * FD_LDV + 8 * n + g] << 16;
            y[h][1] = (uint32_t)vw[(8 * h + 2 * t + 1) * FD_LDV + 8 * n + g] << 16;
          }
#pragma unroll
          for (int rt = 0; rt < RT; ++rt) {
            float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              mma_tf32(d, a[rt][h].small, y[h]);
              mma_tf32(d, a[rt][h].big, y[h]);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[rt][8 * c + n][e] += d[e];
          }
        }
        __syncwarp();
      }
    }
  }

  // ---- the merge ----
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the merge's scratch lives in it
  float* bufA = reinterpret_cast<float*>(ring);  // [RB][DP] warp 1's acc, then the block's
  float* bufB = bufA + RB * DP;                   // [RB][DP] warp 3's acc, then warps 2 + 3
  float* sM = bufB + RB * DP;                     // [RB] the block's m and l
  float* sL = sM + RB;
  float* sWM = sL + RB;                           // [FD_NW][RB] each warp's m and l
  float* sWL = sWM + FD_NW * RB;

#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = 16 * rt + g + 8 * i;
      const float lw = quad_sum(l[rt][i]);
      if (t == 0) {
        sWM[warp * RB + row] = m[rt][i];
        sWL[warp * RB + row] = lw;
      }
    }
  __syncthreads();
  // The block's state: M_b = max m_w, each warp's acc scaled by e^(m_w - M_b).
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = 16 * rt + g + 8 * i;
      float mb = sWM[row];
#pragma unroll
      for (int w = 1; w < FD_NW; ++w) mb = fmaxf(mb, sWM[w * RB + row]);
      const float e = expf(m[rt][i] - mb);
#pragma unroll
      for (int n = 0; n < NA; ++n) {
        acc[rt][n][2 * i] *= e;
        acc[rt][n][2 * i + 1] *= e;
      }
    }
  if (tid < RB) {
    float mb = sWM[tid];
#pragma unroll
    for (int w = 1; w < FD_NW; ++w) mb = fmaxf(mb, sWM[w * RB + tid]);
    float lb = 0.f;
#pragma unroll
    for (int w = 0; w < FD_NW; ++w) lb += expf(sWM[w * RB + tid] - mb) * sWL[w * RB + tid];
    sM[tid] = mb;
    sL[tid] = lb;
  }
  // acc_b = (acc_0 + acc_1) + (acc_2 + acc_3), through two buffers.
  auto acc_io = [&](float* buf, bool load, bool store) {
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int n = 0; n < NA; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float2* d = reinterpret_cast<float2*>(buf + (16 * rt + g + 8 * i) * DP + 8 * n + 2 * t);
          if (load) {
            const float2 o = *d;
            acc[rt][n][2 * i] += o.x;
            acc[rt][n][2 * i + 1] += o.y;
          }
          if (store) *d = make_float2(acc[rt][n][2 * i], acc[rt][n][2 * i + 1]);
        }
  };
  if (warp & 1) acc_io(warp == 1 ? bufA : bufB, false, true);
  __syncthreads();
  if (warp == 0) acc_io(bufA, true, false);
  if (warp == 2) acc_io(bufB, true, true);
  __syncthreads();
  if (warp == 0) acc_io(bufB, true, false);
  if (warp == 0) acc_io(bufA, false, true);

  cluster_sync();  // every block's (sM, sL, bufA) is written and visible to the cluster
  // This block's share of the rows·D output elements; for each, the splits
  // in rank order: M = max m_j, out = Σ e^(m_j - M) acc_j / Σ e^(m_j - M) l_j.
  const float* peer[FD_SPLIT];
#pragma unroll
  for (int j = 0; j < FD_SPLIT; ++j) peer[j] = cluster_map(bufA, j < nsplit ? j : 0);
  const int mo = 2 * RB * DP, lo = mo + RB;  // sM and sL from bufA, in floats
  const int total = rows * p.D, per = (total + nsplit - 1) / nsplit;
  const int e_end = min(total, (split + 1) * per);
  float* out = p.out + (bh * p.R + r0) * p.D;
  for (int e = split * per + tid; e < e_end; e += FD_NT) {
    const int row = e / p.D, col = e - row * p.D;
    float mj[FD_SPLIT], lj[FD_SPLIT], aj[FD_SPLIT], mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < FD_SPLIT; ++j) {
      if (j < nsplit) {
        mj[j] = peer[j][mo + row];
        lj[j] = peer[j][lo + row];
        aj[j] = peer[j][row * DP + col];
        mx = fmaxf(mx, mj[j]);
      }
    }
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int j = 0; j < FD_SPLIT; ++j) {
      if (j < nsplit) {
        const float w = expf(mj[j] - mx);
        lt += w * lj[j];
        at += w * aj[j];
      }
    }
    out[e] = at / (lt == 0.f ? 1.f : lt);
  }
  cluster_sync_relaxed();  // the peers have read this block's shared memory
}

// Clusters of c blocks of this kernel that fit on the card at once (0 if
// none does), by the occupancy calculator.
template <class K>
int active_clusters(K kernel, int smem, int c) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c, 1, 1);
  cfg.blockDim = dim3(FD_NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = c;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, (const void*)kernel, &cfg) != cudaSuccess) {
    (void)cudaGetLastError();
    return 0;
  }
  return n;
}

// The cluster size (the splits of the cache rows) of a launch of `groups`
// clusters: the c in 1..FD_SPLIT that minimizes waves · rows a block, waves
// = ceil(groups / clusters that fit at once), the larger c on a tie. The
// fits are asked once per kernel, Tq and c. (At the serving geometry, 64
// groups at D 64, 62 clusters of 8 fit, so 8 would take a second wave.)
template <int DP, int RT, bool BF16>
int split_count(long long groups, int S, int Tq) {
  static int fit[FD_TQ + 1][FD_SPLIT + 1];  // 0: not asked yet; -1: none fits
  const auto kernel = flash_decode_tc_kernel<DP, RT, BF16>;
  const int smem = fd_smem_bytes<DP, RT, BF16>(Tq);
  int best = 1;
  long long best_cost = -1;
  for (int c = 1; c <= FD_SPLIT; ++c) {
    int& n = fit[Tq][c];
    if (n == 0) {
      (void)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      const int a = active_clusters(kernel, smem, c);
      n = a > 0 ? a : -1;
    }
    if (n < 0) continue;
    const long long cost = (groups + n - 1) / n * ((S + c - 1) / c);
    if (best_cost < 0 || cost <= best_cost) {
      best = c;
      best_cost = cost;
    }
  }
  return best;
}

template <int DP, int RT, bool BF16>
cudaError_t launch(DParams p, cudaStream_t stream) {
  const int smem = fd_smem_bytes<DP, RT, BF16>(p.Tq);
  const auto kernel = flash_decode_tc_kernel<DP, RT, BF16>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nrg = (p.R + 16 * RT - 1) / (16 * RT);
  const int nsplit = split_count<DP, RT, BF16>((long long)p.B * p.Hkv * nrg, p.S, p.Tq);
  p.chunk = ((p.S + nsplit - 1) / nsplit + 15) / 16 * 16;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, p.Hkv * nrg, p.B);
  cfg.blockDim = dim3(FD_NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = nsplit;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int DP_, int RT_, bool BF16_>
struct Inst {
  static constexpr int DP = DP_, RT = RT_;
  static constexpr bool BF16 = BF16_;
};

// f(Inst<...>{}) for the instantiation a call takes: the template width of
// head dim D, and two 16-row tiles a block where more than 16 query rows
// meet a width of at most 128.
template <bool BF16, class F>
int with_instance(int D, int R, F f) {
  if (D <= 64) return R > 16 ? f(Inst<64, 2, BF16>{}) : f(Inst<64, 1, BF16>{});
  if (D <= 128) return R > 16 ? f(Inst<128, 2, BF16>{}) : f(Inst<128, 1, BF16>{});
  return f(Inst<256, 1, BF16>{});
}

template <class F>
int with_instance(int D, int R, int q_bf16, F f) {
  return q_bf16 ? with_instance<true>(D, R, f) : with_instance<false>(D, R, f);
}

}  // namespace

// q (B, Hkv, R, D) contiguous, q_bf16 0 = float32, 1 = bfloat16; k/v
// (B, Hkv, S, D) contiguous int8, D <= 256; ks/vs (B, Hkv, S) float32;
// bias float32 read at b*bsb + t*bst + j*bss (t = row % Tq); out (B, Hkv,
// R, D) float32. Returns the cudaError_t of the launch.
extern "C" int umfa_flash_decode(const void* q, const void* k, const void* ks, const void* v,
                                 const void* vs, const void* bias, void* out, int B, int Hkv,
                                 int R, int Tq, int S, int D, long long bsb, long long bst,
                                 long long bss, float scale, int q_bf16, void* stream) {
  if (D < 1 || D > 256 || B < 1 || Hkv < 1 || R < 1 || Tq < 1 || Tq > FD_TQ || R % Tq != 0 ||
      S < 1 || q_bf16 < 0 || q_bf16 > 1)
    return cudaErrorInvalidValue;
  const uintptr_t kv = reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  const int copy = D % 16 == 0 && kv % 16 == 0 ? 2 : D % 4 == 0 && kv % 4 == 0 ? 1 : 0;
  const DParams p{q,
                  static_cast<const int8_t*>(k),
                  static_cast<const float*>(ks),
                  static_cast<const int8_t*>(v),
                  static_cast<const float*>(vs),
                  static_cast<const float*>(bias),
                  static_cast<float*>(out),
                  B, Hkv, R, Tq, S, D,
                  bsb, bst, bss,
                  scale, 0, copy};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_instance(D, R, q_bf16, [&](auto inst) -> int {
    using I = decltype(inst);
    return launch<I::DP, I::RT, I::BF16>(p, st);
  });
}

// Dynamic shared memory of the launch umfa_flash_decode makes for these
// arguments.
extern "C" int umfa_flash_decode_smem_bytes(int D, int R, int Tq, int q_bf16) {
  return with_instance(D, R, q_bf16, [&](auto inst) -> int {
    using I = decltype(inst);
    return fd_smem_bytes<I::DP, I::RT, I::BF16>(Tq);
  });
}

// Blocks a cluster (splits of the cache rows) of the launch
// umfa_flash_decode makes for these arguments.
extern "C" int umfa_flash_decode_splits(int B, int Hkv, int R, int Tq, int S, int D, int q_bf16) {
  return with_instance(D, R, q_bf16, [&](auto inst) -> int {
    using I = decltype(inst);
    return split_count<I::DP, I::RT, I::BF16>((long long)B * Hkv * ((R + 16 * I::RT - 1) / (16 * I::RT)), S, Tq);
  });
}
