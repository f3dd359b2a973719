// Tensor-core rate probe for Hopper, sm_90a: out = Σ over reps of a·(b + eps)
// in fp32, a (M, K) and b (K, N) bf16, with `mma.sync` m16n8k16.
//
// Replaces scripts/d64_ab.py:64 `_mxu_probe_fn`, the TPU's matrix-unit
// probe: a loop of products over operands resident in fast memory, each
// tied to the one before through eps = bf16(max(acc[0, :]) · 1e-38), which
// b + eps rounds away, so that the compiler can neither hoist the
// loop-invariant product nor fold the sum.
//
// What bounds it on this card: 2·M·K·N·reps flops against reading a and b
// once; at reps 1024 it is compute-bound by orders of magnitude. It
// measures the rate that `mma.sync` (not `wgmma`) reaches, from operands in
// shared memory.
//
// Design: one block of 4 warps per 64 x 64 output tile keeps its rows of a
// and its columns of b (as bᵀ) in shared memory for the whole loop, rows
// padded by 8 bf16 so that the eight rows of an ldmatrix phase fall in
// distinct banks; each warp owns a 32 x 32 tile (2 x 4 mma tiles) whose
// fp32 accumulators (two sets, for even and odd 16-deep steps, summed at
// the end) stay in registers, and it loads the fragments of the next
// 16-deep step with ldmatrix while the current step's 8 products run. At
// these shapes (at most 2048 x 256 outputs) 32 x 32 warp tiles give 512
// warps, one per SM sub-partition; each 16-deep step reads 2 KB of shared
// memory for 8 products, so shared-memory bandwidth caps the kernel near
// half the tensor-core peak. The TPU kernel is one invocation over the
// whole output; here eps comes from the first row of each warp's own tile:
// a data dependence of the same kind, which leaves b unchanged as the
// reference's does.
#include "common.cuh"
#include "mma.cuh"

using namespace umfa;

namespace {

constexpr int PT = 64;   // block output tile
constexpr int PAD = 8;   // bf16 padding per shared-memory row

__device__ __forceinline__ uint32_t add_bf16x2(uint32_t x, __nv_bfloat162 y) {
  __nv_bfloat162 v = __hadd2(*reinterpret_cast<__nv_bfloat162*>(&x), y);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The fragments of one 16-deep step of a warp's 32 x 32 tile: A for its two
// 16-row tiles (ldmatrix matrices: rows 0-7 / 8-15 by k 0-7 / 8-15), B for
// its four 8-column tiles from bᵀ (matrices: columns 0-7 / 8-15 of a pair
// of tiles by k 0-7 / 8-15).
struct Frags {
  uint32_t a[2][4];
  uint32_t b[4][2];
};

__device__ __forceinline__ void load_frags(Frags& f, const __nv_bfloat16* sA,
                                           const __nv_bfloat16* sB, int ld, int k0, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) load_a(f.a[i], sA, ld, i * 16, k0, lane);
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) load_b_nk(f.b[2 * jj], f.b[2 * jj + 1], sB, ld, jj * 16, k0, lane);
}

__device__ __forceinline__ void mma_step(float (&acc)[2][4][4], const Frags& f,
                                         __nv_bfloat162 eps) {
  uint32_t b[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    b[j][0] = add_bf16x2(f.b[j][0], eps);
    b[j][1] = add_bf16x2(f.b[j][1], eps);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], f.a[i], b[j]);
}

__global__ void __launch_bounds__(128) mma_probe_kernel(const __nv_bfloat16* a,
                                                        const __nv_bfloat16* b, float* out,
                                                        int M, int K, int N, int reps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = K + PAD;
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][ld], rows of a
  __nv_bfloat16* sB = sA + PT * ld;                                 // [64][ld], columns of b
  const int m0 = blockIdx.x * PT, n0 = blockIdx.y * PT;
  for (int e = threadIdx.x; e < PT * K; e += blockDim.x) {
    const int r = e / K, c = e - r * K;
    sA[r * ld + c] = a[(long long)(m0 + r) * K + c];
  }
  for (int e = threadIdx.x; e < K * PT; e += blockDim.x) {
    const int kk = e / PT, nn = e - kk * PT;
    sB[nn * ld + kk] = b[(long long)kk * N + n0 + nn];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group and column pair
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const __nv_bfloat16* wA = sA + wm * ld;
  const __nv_bfloat16* wB = sB + wn * ld;
  // Even and odd 16-deep steps accumulate apart, 16 independent mma chains
  // a warp, enough to cover the mma latency with one warp per sub-partition.
  float acc[2][2][4][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[p][i][j][c] = 0.f;

  Frags f0, f1;
  for (int rep = 0; rep < reps; ++rep) {
    // Row 0 of the warp tile lives in c0, c1 of the lanes with g == 0.
    float mx = acc[0][0][0][0] + acc[1][0][0][0];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) mx = fmaxf(mx, acc[0][0][j][c] + acc[1][0][j][c]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = __shfl_sync(0xffffffffu, mx, 0);
    const __nv_bfloat16 eps1 = __float2bfloat16_rn(mx * 1e-38f);
    const __nv_bfloat162 eps = __halves2bfloat162(eps1, eps1);
    // Two 16-deep steps per iteration, the next step's fragments loaded
    // while the current step's products run.
    load_frags(f0, wA, wB, ld, 0, lane);
    for (int k0 = 0; k0 < K; k0 += 32) {
      load_frags(f1, wA, wB, ld, k0 + 16, lane);
      mma_step(acc[0], f0, eps);
      if (k0 + 32 < K) load_frags(f0, wA, wB, ld, k0 + 32, lane);
      mma_step(acc[1], f1, eps);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long row = m0 + wm + i * 16 + g;
      const int col = n0 + wn + j * 8 + 2 * t;
      out[row * N + col] = acc[0][i][j][0] + acc[1][i][j][0];
      out[row * N + col + 1] = acc[0][i][j][1] + acc[1][i][j][1];
      out[(row + 8) * N + col] = acc[0][i][j][2] + acc[1][i][j][2];
      out[(row + 8) * N + col + 1] = acc[0][i][j][3] + acc[1][i][j][3];
    }
}

}  // namespace

// a (M, K) and b (K, N) bfloat16 row-major, out (M, N) float32; M and N
// multiples of 64, K a multiple of 32 whose two 64 x (K + 8) tiles fit in
// shared memory. Returns the cudaError_t of the launch.
extern "C" int umfa_mma_probe(const void* a, const void* b, void* out, int M, int K, int N,
                              int reps, void* stream) {
  const int smem = 2 * PT * (K + PAD) * (int)sizeof(__nv_bfloat16);
  if (M < PT || N < PT || M % PT || N % PT || K < 32 || K % 32 || reps < 1 || smem > 232448)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mma_probe_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(M / PT, N / PT);
  mma_probe_kernel<<<grid, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<float*>(out), M, K, N, reps);
  return cudaGetLastError();
}
