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

}  // namespace umfa

extern "C" const char* umfa_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
