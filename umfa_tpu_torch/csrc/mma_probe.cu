// Tensor-core rate probe for Hopper, sm_90a: out = Σ over reps of a·(b + eps)
// in fp32, a (M, K) and b (K, N) bf16, on warpgroup products (`wgmma`).
//
// Replaces scripts/d64_ab.py:64 `_mxu_probe_fn`, the TPU's matrix-unit
// probe: a loop of products over operands resident in fast memory, each
// tied to the one before through eps = bf16(max(acc[0, :]) · 1e-38), which
// rounds away, so that the compiler can neither hoist the loop-invariant
// product nor fold the sum.
//
// What bounds it on this card: 2·M·K·N·reps flops against reading a and b
// once; at reps 1024 it is compute-bound by orders of magnitude. It
// measures the rate `wgmma.mma_async` reaches from operands resident in
// shared memory and registers.
//
// Design. A work item is one 64 x TN output tile (TN 128, or 64 where N is
// not a multiple of 128) over one K slice of 16·STEPS columns; the host's
// plan (utils/mma_probe.py `plan`) splits K until there are at least 256
// items, about two an SM. One warpgroup (128 threads) a block takes one
// item: it stores its slice of a and of bᵀ once into 128-byte swizzled
// shared-memory tiles (wgmma.cuh), then runs every rep as STEPS m64nTNk16
// products. wgmma reads B only from shared memory, so eps goes on the A
// operand, held in registers (RS): each warp keeps the A fragments of its
// 16 rows of a and adds eps to them in place before each rep (a + eps
// rounds back to a, as b + eps does in the reference; the sum of the eps
// added so far rounds away alike). Rep 0, whose eps is 0 (the accumulator
// is zero), reads A from shared memory (SS), which keeps both forms of the
// header checked. eps comes from row 0 of each warp's own 16 rows (the
// reference takes row 0 of the whole sum), and a K-split item takes it
// from its own partial sum: data dependences of the same kind.
//
// Keeping the tensor cores fed: eps needs the accumulator, so each rep
// waits for the last one's group (wait_group 0) before it forms eps. The
// other item on the same SM issues its products meanwhile. Keeping one
// group in flight inside an item instead (two accumulator sets, eps from
// the set two reps back, wait_group 1) was built and measured: ptxas
// serialized it ("wgmma ... serialized due to non wgmma instructions
// reading accumulator registers"), and it ran slower than this. The K
// slices' partial tiles go to a scratch buffer, and a second kernel sums
// the partials of each tile in split order (no atomics: the same bits on
// every call).
#include "common.cuh"
#include "wgmma.cuh"

using namespace umfa;

namespace {

constexpr int PM = 64;  // output rows of a work item (one warpgroup)

__device__ __forceinline__ uint32_t add_bf16x2(uint32_t x, __nv_bfloat162 y) {
  __nv_bfloat162 v = __hadd2(*reinterpret_cast<__nv_bfloat162*>(&x), y);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Columns a tile holds: whole 128-byte lines.
template <int STEPS>
__host__ __device__ constexpr int slice_cols() {
  return 16 * STEPS < 64 ? 64 : 16 * STEPS;
}

// The a and bᵀ tiles, plus room to align them to 1024 bytes.
template <int TN, int STEPS>
__host__ __device__ constexpr int probe_smem_bytes() {
  return 1024 + (PM + TN) * slice_cols<STEPS>() * 2;
}

// One rep: once the previous rep's group has retired, eps from row 0 of
// this warp's rows of the accumulator, added to the A registers, then
// STEPS products committed as one group.
template <int TN, int STEPS>
__device__ __forceinline__ void probe_rep(float (&acc)[TN / 2], uint32_t (&fa)[STEPS][4],
                                          const __nv_bfloat16* sB) {
  wgmma_wait<0>();
  fence_operand(acc);
  // Row 0 of the warp's rows: registers 4j, 4j + 1 of the lanes with g == 0.
  float mx = acc[0];
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) mx = fmaxf(mx, fmaxf(acc[4 * j], acc[4 * j + 1]));
  mx = __shfl_sync(0xffffffffu, quad_max(mx), 0);
  const __nv_bfloat16 e = __float2bfloat16_rn(mx * 1e-38f);
  const __nv_bfloat162 eps = __halves2bfloat162(e, e);
#pragma unroll
  for (int s = 0; s < STEPS; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) fa[s][i] = add_bf16x2(fa[s][i], eps);
  fence_operand(acc);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < STEPS; ++s) wgmma_rs(acc, fa[s], sw128_desc(sB, TN, 16 * s), 1);
  wgmma_commit();
}

template <int TN, int STEPS>
__global__ void __launch_bounds__(128) mma_probe_wg_kernel(const __nv_bfloat16* a,
                                                           const __nv_bfloat16* b, float* out,
                                                           int M, int K, int N, int reps) {
  constexpr int KS = 16 * STEPS;
  constexpr int NR = TN / 2;
  extern __shared__ unsigned char smem_raw[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));  // 64 x KS, SW128
  __nv_bfloat16* sB = sA + PM * slice_cols<STEPS>();                       // TN x KS: bᵀ
  const int m0 = blockIdx.x * PM, n0 = blockIdx.y * TN, k0 = blockIdx.z * KS;
  store_sw128(sA, a + (long long)m0 * K + k0, K, PM, KS);
  store_sw128_t(sB, b + (long long)k0 * N + n0, N, TN, KS);
  fence_proxy_async();
  __syncthreads();

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  uint32_t fa[STEPS][4];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) load_a_sw128(fa[s], sA, PM, 16 * warp, 16 * s, lane);
  float acc[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] = 0.f;

  // Rep 0: eps is 0, A from shared memory.
  fence_operand(acc);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < STEPS; ++s)
    wgmma_ss(acc, sw128_desc(sA, PM, 16 * s), sw128_desc(sB, TN, 16 * s), 1);
  wgmma_commit();
  for (int rep = 1; rep < reps; ++rep) probe_rep<TN, STEPS>(acc, fa, sB);
  wgmma_wait<0>();
  fence_operand(acc);

  float* dst = out + (long long)blockIdx.z * M * N;  // this slice's partial (or out itself)
#pragma unroll
  for (int i = 0; i < NR; i += 2) {
    const long long row = m0 + acc_row(i, tid);
    const int col = n0 + acc_col(i, tid);
    *reinterpret_cast<float2*>(dst + row * N + col) = make_float2(acc[i], acc[i + 1]);
  }
}

// out = Σ_s partial[s] in split order, four floats a thread.
__global__ void __launch_bounds__(256) mma_probe_merge_kernel(const float4* __restrict__ partial,
                                                              float4* __restrict__ out,
                                                              long long n4, int split) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    float4 s = partial[i];
    for (int k = 1; k < split; ++k) {
      const float4 p = partial[k * n4 + i];
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    out[i] = s;
  }
}

template <int TN, int STEPS>
cudaError_t launch_probe(const void* a, const void* b, float* dst, int M, int K, int N, int reps,
                         int split, cudaStream_t st) {
  constexpr int smem = probe_smem_bytes<TN, STEPS>();
  cudaError_t err = cudaFuncSetAttribute(mma_probe_wg_kernel<TN, STEPS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(M / PM, N / TN, split);
  mma_probe_wg_kernel<TN, STEPS><<<grid, 128, smem, st>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), dst, M, K, N,
      reps);
  return cudaGetLastError();
}

template <int TN>
cudaError_t launch_steps(int steps, const void* a, const void* b, float* dst, int M, int K, int N,
                         int reps, int split, cudaStream_t st) {
  switch (steps) {
    case 1: return launch_probe<TN, 1>(a, b, dst, M, K, N, reps, split, st);
    case 2: return launch_probe<TN, 2>(a, b, dst, M, K, N, reps, split, st);
    case 4: return launch_probe<TN, 4>(a, b, dst, M, K, N, reps, split, st);
    case 8: return launch_probe<TN, 8>(a, b, dst, M, K, N, reps, split, st);
    case 16:
      if (TN == 64) return launch_probe<64, 16>(a, b, dst, M, K, N, reps, split, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// a (M, K) and b (K, N) bfloat16 row-major, 16-byte aligned; out (M, N)
// float32. The plan: output tiles 64 x tn (tn 64 or 128, dividing N; M a
// multiple of 64), K split into `split` slices of 16·steps columns (steps
// 1, 2, 4 or 8, or 16 at tn 64); with split > 1, `partial` holds
// split·M·N floats of scratch. Returns the cudaError_t of the launches.
extern "C" int umfa_mma_probe(const void* a, const void* b, void* out, void* partial, int M,
                              int K, int N, int reps, int tn, int split, void* stream) {
  if (M < PM || M % PM || (tn != 64 && tn != 128) || N < tn || N % tn || split < 1 ||
      K % split || reps < 1 || (split > 1 && !partial) ||
      reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(b) % 16)
    return cudaErrorInvalidValue;
  const int ks = K / split;
  if (ks % 16) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(split > 1 ? partial : out);
  cudaError_t err = tn == 128 ? launch_steps<128>(ks / 16, a, b, dst, M, K, N, reps, split, st)
                              : launch_steps<64>(ks / 16, a, b, dst, M, K, N, reps, split, st);
  if (err != cudaSuccess || split == 1) return err;
  const long long n4 = (long long)M * N / 4;
  const int blocks = (int)((n4 + 255) / 256 < 1024 ? (n4 + 255) / 256 : 1024);
  mma_probe_merge_kernel<<<blocks, 256, 0, st>>>(static_cast<const float4*>(partial),
                                                 static_cast<float4*>(out), n4, split);
  return cudaGetLastError();
}

// The probe kernel of the plan's (tn, steps): its dynamic shared memory,
// and the blocks of it one SM holds at once; -1 for a plan it does not take.
namespace {
template <typename F>
int with_probe(int tn, int steps, F f) {
#define UMFA_PROBE_PLAN(T, S) \
  if (tn == T && steps == S) return f(mma_probe_wg_kernel<T, S>, probe_smem_bytes<T, S>());
  UMFA_PROBE_PLAN(128, 1) UMFA_PROBE_PLAN(128, 2) UMFA_PROBE_PLAN(128, 4) UMFA_PROBE_PLAN(128, 8)
  UMFA_PROBE_PLAN(64, 1) UMFA_PROBE_PLAN(64, 2) UMFA_PROBE_PLAN(64, 4) UMFA_PROBE_PLAN(64, 8)
  UMFA_PROBE_PLAN(64, 16)
#undef UMFA_PROBE_PLAN
  return -1;
}
}  // namespace

extern "C" int umfa_mma_probe_smem_bytes(int tn, int steps) {
  return with_probe(tn, steps, [](auto, int smem) { return smem; });
}

extern "C" int umfa_mma_probe_blocks_per_sm(int tn, int steps) {
  return with_probe(tn, steps, [](auto kernel, int smem) {
    int n = -1;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) ==
        cudaSuccess)
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, 128, smem);
    return n;
  });
}
