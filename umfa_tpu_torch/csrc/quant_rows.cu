// One-pass ROW-wise symmetric quantizer for Hopper, sm_90a.
//
// Replaces umfa_tpu/ops/quant_fused.py:40 `_quant_rows_kernel` (host
// `quantize_rows_fused`, quant_fused.py:92): the two-pass route's quantizer.
//
// What bounds it on this card: bytes. Per row it reads D inputs (fp32 or
// bf16) and writes D (or D/2 packed INT4) bytes and one scale, against ~4
// operations per element (2·D more per element with the Hadamard rotation,
// which at D = 64 is still under the card's ~295 flop per byte): at B8 H16
// S4096 D64 bf16 that is ~0.03 ms of HBM time.
//
// What this design does about it: one warp per row, rows strided over the
// grid; each lane holds D/32 elements in registers, so the row is read from
// HBM once and written once, and the absmax is a warp shuffle reduction.
// With the rotation the raw row is staged in shared memory and each lane
// computes its outputs of x·H (H entries ±fp32(1/√D)) in double, rounded
// once. Not tuned: no vector loads.
//
// Arithmetic held to the reference (quant_fused.py:57-73) and to the plain
// version (`quantize_rows_fused_plain`): x·H, minus the mean (fp32), absmax
// over D, scale = max(absmax, 1e-12) / qmax and code = clip(rint(x / scale),
// -qmax-1, qmax), both exact IEEE divisions (rintf rounds half to even);
// INT4 codes packed split-halves: byte j = code j | code j + D/2 << 4.
// The codes and scales equal the plain version's bit for bit (with the
// rotation, unless a double sum lands within ~1e-16 of an fp32 rounding
// boundary, which the two sum in other orders).
#include <math.h>

#include "common.cuh"

using namespace umfa;

namespace {

constexpr int QR_WARPS = 8;
constexpr int QR_MAXD = 256;

template <typename Tin>
__global__ void __launch_bounds__(QR_WARPS * 32)
    quant_rows_kernel(const Tin* __restrict__ x, const float* __restrict__ mean,
                      int8_t* __restrict__ vals, float* __restrict__ scales, long long rows,
                      int S, int D, int qmax, int int4, int hadamard, float hval) {
  __shared__ float s_raw[QR_WARPS][QR_MAXD];
  __shared__ int s_code[QR_WARPS][QR_MAXD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* raw = s_raw[warp];
  int* code = s_code[warp];
  const float fq = (float)qmax;
  for (long long row = (long long)blockIdx.x * QR_WARPS + warp; row < rows;
       row += (long long)gridDim.x * QR_WARPS) {
    const Tin* xr = x + row * D;
    const float* mr = mean ? mean + (row / S) * D : nullptr;
    if (hadamard) {
      __syncwarp();  // the previous row's reads of `raw` are done
      for (int c = lane; c < D; c += 32) raw[c] = Elem<Tin>::load(xr, c);
      __syncwarp();
    }
    float y[QR_MAXD / 32];
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < QR_MAXD / 32; ++i) {
      const int c = lane + 32 * i;
      float t = 0.f;
      if (c < D) {
        if (hadamard) {
          // x·H summed in double and rounded once, as the plain version's
          // float64 product.
          double acc = 0.0;
          for (int j = 0; j < D; ++j)
            acc = fma((double)raw[j], (__popc(j & c) & 1) ? -(double)hval : (double)hval, acc);
          t = (float)acc;
        } else {
          t = Elem<Tin>::load(xr, c);
        }
        if (mr) t = __fsub_rn(t, mr[c]);
        amax = fmaxf(amax, fabsf(t));
      }
      y[i] = t;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float scale = __fdiv_rn(fmaxf(amax, 1e-12f), fq);
#pragma unroll
    for (int i = 0; i < QR_MAXD / 32; ++i) {
      const int c = lane + 32 * i;
      if (c >= D) continue;
      const float qf = fminf(fmaxf(rintf(__fdiv_rn(y[i], scale)), -fq - 1.f), fq);
      if (int4)
        code[c] = (int)qf;
      else
        vals[row * D + c] = (int8_t)(int)qf;
    }
    if (int4) {
      __syncwarp();
      const int h = D / 2;
      for (int c = lane; c < h; c += 32)
        vals[row * h + c] = (int8_t)(unsigned char)((code[c] & 0xF) | ((code[c + h] & 0xF) << 4));
      __syncwarp();  // `code` is rewritten by the next row
    }
    if (lane == 0) scales[row] = scale;
  }
}

}  // namespace

// x (rows = B*H, S, D) contiguous, in_dtype 0 = float32, 1 = bfloat16; mean
// (B*H, D) float32 or null; vals (rows*S, D) int8, or (rows*S, D/2) packed
// INT4; scales (rows*S) float32. Returns the cudaError_t of the launch.
extern "C" int umfa_quant_rows(const void* x, const void* mean, void* vals, void* scales,
                               int rows, int S, int D, int qmax, int int4, int hadamard,
                               int in_dtype, void* stream) {
  if (D < 1 || D > QR_MAXD || (int4 && D % 2) || (hadamard && (D & (D - 1))) || in_dtype < 0 ||
      in_dtype > 1)
    return cudaErrorInvalidValue;
  const long long n = (long long)rows * S;
  // The rotation's entries: fp32(D^-1/2), as the host's hadamard_matrix.
  const float hval = (float)pow((double)D, -0.5);
  const int blocks = (int)((n + QR_WARPS - 1) / QR_WARPS < 65536 ? (n + QR_WARPS - 1) / QR_WARPS
                                                                  : 65536);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0)
    quant_rows_kernel<float><<<blocks, QR_WARPS * 32, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(mean), static_cast<int8_t*>(vals),
        static_cast<float*>(scales), n, S, D, qmax, int4, hadamard, hval);
  else
    quant_rows_kernel<__nv_bfloat16><<<blocks, QR_WARPS * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(mean),
        static_cast<int8_t*>(vals), static_cast<float*>(scales), n, S, D, qmax, int4, hadamard,
        hval);
  return cudaGetLastError();
}
