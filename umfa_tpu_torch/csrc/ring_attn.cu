// Ring attention step kernels for Hopper, sm_90a: one launch is one rank's
// work for one ring step.
//
// Replaces umfa_tpu/parallel/ring_pallas.py:99 `_ring_fwd_kernel`
// (`ring_fwd_step`) and ring_pallas.py:529 `_ring_bwd_kernel` (its phase 0,
// `ring_bwd_dkv`, and its phase 1, `ring_bwd_dq`). The TPU kernels also
// move K/V (and dK/dV) between chips with RDMA inside the kernel; here the
// host loop (parallel/ring_pallas.py) launches these kernels per rank and
// step, and a transport (parallel/transport.py) makes the hops between
// them: device copies on a side stream, ordered by CUDA events, on one
// card, or torch.distributed send/recv across processes.
//
// What bounds them on this card: at the full-width ring step (B8 Hq16 Hkv8,
// S_loc 1024, D 64, bf16) a fully visible step does 4·D flops per (query,
// key) pair in the forward (2 products), 8·D in dK/dV (4) and 6·D in dQ
// (3), against reading each operand once: 3.4e10, 6.9e10 and 5.2e10 flop,
// ~35, ~70 and ~52 µs of bf16 tensor-core time, against ~20 µs of HBM time.
// All three are compute-bound.
//
// The backward step (`ring_bwd_dkv`, `ring_bwd_dq`) is the dense backward's
// tensor-core bodies (bwd_tc.cuh `dkv_tc_kernel`, `dq_tc_kernel`) with its
// load stages (bwd_dense.cuh), instantiated with RING = true: bf16 inputs
// by mma.sync m16n8k16 bf16 -> fp32 (`Bf16Mma`), head dims up to 256;
// fp32 inputs by 3xTF32 (`Tf32x3Mma`), up to 128. Tiles, occupancy and the
// cp.async pipeline are those of csrc/flash_bwd.cu, whose header gives the
// rounding points a ring step shares: Q·scale rounded to the input type
// (ring_pallas.py:693); P = exp(s - lse) with the final LSE; dS =
// P∘(dP − δ); dV += round(P)ᵀ·dO, dK += round(dS)ᵀ·Q and dQ += round(dS)·K,
// dK and dQ times scale. Two things differ from the dense backward:
//   * which pairs a step sees. The host reduces the step's global positions
//     (chunk_pos below) to the bodies' band mask plus a first visible query
//     row q_lo and a key limit k_hi, in local indices (ring_pallas.py
//     `_step_mask`): not causal, nothing hidden; the diagonal step (src ==
//     my) local causal (right = 0; under zigzag too, since a chunk's two
//     halves sit in order); contiguous causal with src < my, nothing hidden;
//     zigzag with src < my, keys [0, S/2) only; with src > my, query rows
//     [S/2, S) only. Tiles past the limits are skipped whole, and a block
//     that sees nothing after the first step stores nothing;
//   * the gradients fold into the travelling fp32 dK/dV buffers and the
//     fp32 dQ accumulator: written at the rank's first step (:829-837,
//     :912-923), then added, old + scale·sum, each rounded once, as the
//     plain versions add.
// One owner per output tile and no atomics, so the step is deterministic.
//
// The forward step (`ring_fwd_step_kernel`) is still the first version,
// simple and exact rather than fast: FP32 FMAs on the CUDA cores (exact for
// bf16 operands, full FP32 for fp32 ones: no TF32), so its own ceiling is
// the 67 TFLOP/s FP32 rate. One block of 128 threads per (64-row query
// tile, q head, batch), the thread layout of flash_fwd.cu; tiles are 64 rows
// by 64 keys staged in shared memory as fp32, and 64-key tiles that causal
// masking hides from a whole 64-row tile are skipped (exact: they add 0).
// The reference rounds P to V's type against the running row max of its
// block_k-key tiles; to round against the same max this kernel walks each
// block_k tile twice (its row max first, then P and P·V), one extra QKᵀ
// product. Semantics held to the reference:
//   * global positions: a local row r of ring position c is c·S_loc + r
//     contiguous, or in zigzag half-chunk c (r < S_loc/2) or 2n-1-c
//     (ring_pallas.py:170-178); causal keeps key position <= query
//     position; a hidden score is -1e30 and its P is 0 (:327-345);
//   * s = (q·k) · scale in fp32 (:321-326); P = exp(s - m) against the
//     running max, rounded to V's type for P·V while l sums the unrounded P
//     (:338-355); o_step = acc / l and lse_step = m + log l, a row with
//     l == 0 gets 0 and -1e30 (:363-367); then the merge into the previous
//     (o, lse) (:382-390) or, at the rank's first step, a plain write
//     (:392-395); o is stored in its own type after every step.
#include "bwd_dense.cuh"

using namespace umfa;

namespace {

struct RingStep {
  int B, Hq, Hkv, S, D;  // S = S_loc, the rank's chunk
  float scale;
  int causal, zigzag, n, my, src, first;
};

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int block_k;
  RingStep r;
};

// Global position of local row `row` of the chunk of ring position `slot`
// (the reference's chunk_base). The host keeps 64-row tiles inside one
// zigzag half, so the rows of a tile have consecutive positions.
__device__ __forceinline__ int chunk_pos(const RingStep& r, int slot, int row) {
  if (!r.zigzag) return slot * r.S + row;
  const int half = r.S >> 1;
  return row < half ? slot * half + row : (2 * r.n - 1 - slot) * half + (row - half);
}

// Whether any key of the 64-key tile at position kbase is visible to some
// row of the 64-row tile at position qbase.
__device__ __forceinline__ bool tile_visible(const RingStep& r, int qbase, int kbase) {
  return !r.causal || kbase <= qbase + 63;
}

template <int DP>
constexpr int fwd_smem_bytes() {
  return (BQ * (DP + 1) + BK * (DP + 1) + BK * DP + BQ * (BK + 1)) * (int)sizeof(float);
}

// s[i][j] = scale · (q row 4*ty+i) · (k row tx+8j) over the DP columns.
template <int DP>
__device__ __forceinline__ void fwd_scores(float (&s)[4][8], const float* sQ, const float* sK,
                                           int ty, int tx, float scale) {
  constexpr int QS = DP + 1;
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
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] *= scale;
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT) ring_fwd_step_kernel(const FwdParams p) {
  constexpr int QS = DP + 1;
  constexpr int PS = BK + 1;
  constexpr int NC = DP / 8;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * QS;
  float* sV = sK + BK * QS;
  float* sP = sV + BK * DP;

  const RingStep& r = p.r;
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (r.Hq / r.Hkv);
  const long long qrow = ((long long)b * r.Hq + h) * r.S;
  const long long krow = ((long long)b * r.Hkv + hk) * r.S;
  const T* k = static_cast<const T*>(p.k) + krow * r.D;
  const T* v = static_cast<const T*>(p.v) + krow * r.D;

  // Q as stored: the forward scales the dot, not Q.
  stage_rows<T, DP>(sQ, static_cast<const T*>(p.q) + qrow * r.D, q0, r.S, r.D);
  const int qbase = chunk_pos(r, r.my, q0);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASK_VALUE;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int g0 = 0; g0 < r.S; g0 += p.block_k) {
    // Pass 1: the row max over this block_k tile.
    float mt[4] = {MASK_VALUE, MASK_VALUE, MASK_VALUE, MASK_VALUE};
    for (int k0 = g0; k0 < g0 + p.block_k; k0 += BK) {
      const int kbase = chunk_pos(r, r.src, k0);
      if (!tile_visible(r, qbase, kbase)) continue;
      __syncthreads();  // the previous tile's sK consumed (and sQ staged)
      stage_rows<T, DP>(sK, k, k0, r.S, r.D);
      __syncthreads();
      float s[4][8];
      fwd_scores<DP>(s, sQ, sK, ty, tx, r.scale);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const bool vis = !r.causal || kbase + tx + 8 * j <= qbase + ty * 4 + i;
          mt[i] = fmaxf(mt[i], vis ? s[i][j] : MASK_VALUE);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float m_new = fmaxf(m[i], row_max8(mt[i]));
      const float alpha = expf(m[i] - m_new);
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }

    // Pass 2: P against that max, its row sum, and P·V.
    for (int k0 = g0; k0 < g0 + p.block_k; k0 += BK) {
      const int kbase = chunk_pos(r, r.src, k0);
      if (!tile_visible(r, qbase, kbase)) continue;
      __syncthreads();  // the previous tile's sK/sV/sP consumed
      stage_rows<T, DP>(sK, k, k0, r.S, r.D);
      for (int e = tid; e < BK * DP; e += NT) {
        const int row = e / DP, c = e - row * DP;
        sV[row * DP + c] = c < r.D ? Elem<T>::load(v, (long long)(k0 + row) * r.D + c) : 0.f;
      }
      __syncthreads();
      float s[4][8];
      fwd_scores<DP>(s, sQ, sK, ty, tx, r.scale);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const bool vis = !r.causal || kbase + tx + 8 * j <= qbase + ty * 4 + i;
          const float pj = vis ? expf(s[i][j] - m[i]) : 0.f;
          rs += pj;  // l sums the unrounded P
          sP[(ty * 4 + i) * PS + tx + 8 * j] = Elem<T>::round(pj);
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
          const float vv = sV[kk * DP + tx + 8 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pp[i], vv, acc[i][c]);
        }
      }
    }
  }

  // Merge this step's (o_step, lse_step) into the running (o, lse).
  T* o = static_cast<T*>(p.o) + qrow * r.D;
  float* lse = p.lse + qrow;
  float lse_prev[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) lse_prev[i] = r.first ? 0.f : lse[q0 + ty * 4 + i];
  __syncthreads();  // every lane has read its rows' LSE before any is written
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const bool empty = l[i] == 0.f;
    const float l_safe = empty ? 1.f : l[i];
    const float lse_step = empty ? MASK_VALUE : m[i] + logf(l_safe);
    float w1 = 0.f, w2 = 1.f, lse_new = lse_step;
    if (!r.first) {
      const float m2 = fmaxf(lse_prev[i], lse_step);
      w1 = expf(lse_prev[i] - m2);
      w2 = expf(lse_step - m2);
      const float denom = w1 + w2;
      const float safe = denom == 0.f ? 1.f : denom;
      w1 /= safe;
      w2 /= safe;
      lse_new = m2 + logf(safe);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 8 * c;
      if (col >= r.D) continue;
      const long long idx = (long long)row * r.D + col;
      const float o_step = acc[i][c] / l_safe;
      const float o_new = r.first ? o_step : Elem<T>::load(o, idx) * w1 + o_step * w2;
      Elem<T>::store(o, idx, o_new);
    }
    if (tx == 0) lse[row] = lse_new;
  }
}

template <typename T, int DP>
cudaError_t launch_fwd(const FwdParams& p, cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(ring_fwd_step_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.r.S / BQ, p.r.Hq, p.r.B);
  ring_fwd_step_kernel<T, DP><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const BwdParams& p, bool dkv, cudaStream_t stream) {
  if (p.D <= 64) return launch_dense<T, float, 64, true>(p, dkv, stream);
  if constexpr (sizeof(T) == 2) {
    if (p.D > 128) return launch_dense<T, float, 256, true>(p, dkv, stream);
  }
  return launch_dense<T, float, 128, true>(p, dkv, stream);
}

}  // namespace

#define UMFA_RING_STEP_ARGS                                                                  \
  int B, int Hq, int Hkv, int S, int D, float scale, int causal, int zigzag, int n, int my, \
      int src, int first, int dtype, void *stream
#define UMFA_RING_STEP RingStep{B, Hq, Hkv, S, D, scale, causal, zigzag, n, my, src, first}

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and o). q and o
// (B, Hq, S, D), k and v (B, Hkv, S, D), S the rank's chunk, contiguous,
// D <= 128, S a multiple of 64 (of 128 with zigzag); lse (B, Hq, S)
// float32. o and lse are read (unless first) and written. Returns the
// cudaError_t of the launch.
extern "C" int umfa_ring_fwd_step(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int block_k, UMFA_RING_STEP_ARGS) {
  const RingStep r = UMFA_RING_STEP;
  const int tile = r.zigzag ? 2 * BQ : BQ;
  const bool valid = r.D >= 1 && r.D <= 128 && r.Hkv >= 1 && r.Hq % r.Hkv == 0 && r.S >= tile &&
                     r.S % tile == 0 && r.n >= 1 && r.my >= 0 && r.my < r.n && r.src >= 0 &&
                     r.src < r.n && (dtype == 0 || dtype == 1);
  if (!valid || block_k < BK || block_k % BK != 0 || S % block_k != 0)
    return cudaErrorInvalidValue;
  const FwdParams p{q, k, v, o, static_cast<float*>(lse), block_k, r};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return D <= 64 ? launch_fwd<float, 64>(p, st) : launch_fwd<float, 128>(p, st);
  return D <= 64 ? launch_fwd<__nv_bfloat16, 64>(p, st) : launch_fwd<__nv_bfloat16, 128>(p, st);
}

// q, dout (B, Hq, S, D) and k, v (B, Hkv, S, D) in dtype, contiguous, D <=
// 256 for bfloat16 and <= 128 for float32; lse, delta (B, Hq, S) float32.
// What the step sees, in local indices: the band (left, right; -1 =
// unbounded), query rows from q_lo and keys below k_hi
// (parallel/ring_pallas.py `_step_mask`). umfa_ring_bwd_dq folds dQ into
// out0 (B, Hq, S, D); umfa_ring_bwd_dkv folds dK into out0 and dV into out1
// (B, Hkv, S, D); all float32, written when first, else added to. Each
// returns the cudaError_t of its launch.
#define UMFA_RING_BWD_ARGS                                                                   \
  const void *q, const void *k, const void *v, const void *dout, const void *lse,           \
      const void *delta, void *out0, void *out1, int B, int Hq, int Hkv, int S, int D,      \
      float scale, int left, int right, int q_lo, int k_hi, int first, int dtype, void *stream

static int ring_bwd(UMFA_RING_BWD_ARGS, bool dkv) {
  if ((dtype != 0 && dtype != 1) || D < 1 || D > (dtype == 1 ? 256 : 128) || Hkv < 1 ||
      Hq % Hkv != 0 || S < 1 || left < -1 || right < -1 || q_lo < 0 || q_lo > S || k_hi < 0 ||
      k_hi > S || (dkv && out1 == nullptr))
    return cudaErrorInvalidValue;
  BwdParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out0 = out0;
  p.out1 = out1;
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Sq = p.Sk = S;
  p.D = D;
  p.scale = scale;
  p.left = left;
  p.right = right;
  p.q_lo = q_lo;
  p.k_hi = k_hi;
  p.first = first;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_bwd<float>(p, dkv, st) : launch_bwd<__nv_bfloat16>(p, dkv, st);
}

extern "C" int umfa_ring_bwd_dq(UMFA_RING_BWD_ARGS) {
  return ring_bwd(q, k, v, dout, lse, delta, out0, out1, B, Hq, Hkv, S, D, scale, left, right,
                  q_lo, k_hi, first, dtype, stream, false);
}

extern "C" int umfa_ring_bwd_dkv(UMFA_RING_BWD_ARGS) {
  return ring_bwd(q, k, v, dout, lse, delta, out0, out1, B, Hq, Hkv, S, D, scale, left, right,
                  q_lo, k_hi, first, dtype, stream, true);
}

// Dynamic shared memory of the ring backward's dQ (dkv = 0) or dK/dV
// (dkv = 1) kernel for head dim D and dtype code dtype, in bytes (0 if it
// does not take them).
extern "C" int umfa_ring_bwd_smem_bytes(int D, int dkv, int dtype) {
  if (dtype != 0 && dtype != 1) return 0;
  return dense_smem_bytes(D, dkv, dtype);
}
