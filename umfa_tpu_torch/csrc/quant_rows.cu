// One-pass ROW-wise symmetric quantizer for Hopper, sm_90a.
//
// Replaces umfa_tpu/ops/quant_fused.py:40 `_quant_rows_kernel` (host
// `quantize_rows_fused`, quant_fused.py:92): the two-pass route's quantizer.
//
// What bounds it on this card: bytes. Per row it reads D inputs (fp32 or
// bf16) and writes D (or D/2 packed INT4) bytes and one scale, against ~4
// operations per element (log2 D more per element with the Hadamard
// rotation): at B8 H16 S4096 D64 bf16 that is ~0.03 ms of HBM time, and
// 3.35 TB/s at ~0.8 µs of memory latency wants ~20 KB in flight an SM.
//
// What this design does about it: a row is split over a group of LPR lanes
// (the fewest, a power of two, that hold it at E elements a lane, E =
// `lane_elems`: at D 64 bf16, 4 lanes of 16, so a warp works on 8 rows at
// once), and each lane loads its elements as VEC-wide vectors (VEC the
// widest of 16 bytes, 8, 4, 2 or one element that the row length and the
// pointers' alignment allow: the host's `load_width`), chunk k of lane l
// holding columns [(k·LPR + l)·VEC, +VEC), so every load instruction of a
// warp is contiguous. Each warp walks a contiguous run of row groups and
// issues the next group's loads (32 bytes a lane where rows are 16-byte
// aligned) before it quantizes the current one, so a group is always in
// flight behind the arithmetic: ~32 KB an SM at the Q shape, four blocks
// of 256 threads an SM. The grid is the blocks the card holds at once. The channel mean is read once a run of rows of one
// head. The absmax is a shuffle reduction inside the row's lane group; the
// codes come from the row's correctly rounded reciprocal and two FMA
// corrections (the IEEE quotient) and are rounded and clipped on the FP32
// pipes (the conversion units run at an eighth of their rate); INT8 codes
// leave as one VEC-byte store a chunk, the scales of a warp's rows as one
// coalesced store; INT4 codes go through a per-warp shared-memory row
// buffer that pairs code j with code j + D/2 and leave as 4-byte words
// (bytes where D % 8 != 0). With the rotation, x·H is a fast
// Walsh–Hadamard transform in double on the row's registers (in-lane
// butterflies over the VEC and chunk bits of the column, shuffles over the
// lane bits), scaled by fp32(D^-1/2) and rounded to fp32 once.
//
// Arithmetic held to the reference (quant_fused.py:57-73) and to the plain
// version (`quantize_rows_fused_plain`): x·H, minus the mean (fp32), absmax
// over D, scale = max(absmax, 1e-12) / qmax and code = clip(rint(x / scale),
// -qmax-1, qmax), both exact IEEE divisions, rounded half to even (rintf);
// INT4 codes packed split-halves: byte j = code j | code j + D/2 << 4.
// The codes and scales equal the plain version's bit for bit (with the
// rotation, unless a double sum lands within ~1e-16 of an fp32 rounding
// boundary, which the two sum in other orders).
#include <math.h>

#include "common.cuh"

using namespace umfa;

namespace {

constexpr int QR_WARPS = 8;
constexpr int QR_MAXD = 256;  // 32 lanes x 8 elements

// Elements of a row a lane holds: two 16-byte loads in 16-byte aligned
// bf16 or fp32 rows (16 or 8 elements), eight narrower loads otherwise.
template <typename Tin, int VEC>
__host__ __device__ constexpr int lane_elems() {
  return sizeof(Tin) == 2 && VEC == 8 ? 16 : 8;
}

template <int BYTES> struct Raw;
template <> struct Raw<16> { using T = uint4; };
template <> struct Raw<8> { using T = uint2; };
template <> struct Raw<4> { using T = unsigned int; };
template <> struct Raw<2> { using T = unsigned short; };
template <> struct Raw<1> { using T = unsigned char; };

// N values of type T from src (aligned to N·sizeof(T), or to 16 bytes
// above that) into dst, in loads of up to 16 bytes.
template <typename T, int N>
__device__ __forceinline__ void load_n(T (&dst)[N], const T* __restrict__ src) {
  constexpr int B = N * (int)sizeof(T) < 16 ? N * (int)sizeof(T) : 16;
  constexpr int P = B / (int)sizeof(T);
  using R = typename Raw<B>::T;
#pragma unroll
  for (int i = 0; i < N; i += P) {
    union {
      R r;
      T t[P];
    } u;
    u.r = __ldg(reinterpret_cast<const R*>(src + i));
#pragma unroll
    for (int j = 0; j < P; ++j) dst[i + j] = u.t[j];
  }
}

// VEC elements of x as floats (bf16 widened exactly by its bits).
template <int VEC>
__device__ __forceinline__ void load_x(float (&v)[VEC], const float* p) {
  load_n(v, p);
}
template <int VEC>
__device__ __forceinline__ void load_x(float (&v)[VEC], const __nv_bfloat16* p) {
  unsigned short h[VEC];
  load_n(h, reinterpret_cast<const unsigned short*>(p));
#pragma unroll
  for (int j = 0; j < VEC; ++j) v[j] = __uint_as_float((unsigned int)h[j] << 16);
}

// Fast Walsh–Hadamard transform of one row held by LPR lanes, chunk k of
// lane l at columns [(k·LPR + l)·VEC, +VEC): stages over the VEC bits of
// the column inside a chunk, over the chunk bits inside the lane, and over
// the lane bits by shuffles (the stages commute). Unnormalized: y_c =
// Σ_j (-1)^popc(j & c) x_j.
template <int VEC, int E>
__device__ __forceinline__ void fwht(double (&x)[E], int D, int LPR, int l) {
  constexpr int NCH = E / VEC;
#pragma unroll
  for (int h = 1; h < VEC; h <<= 1)
#pragma unroll
    for (int i = 0; i < E; ++i)
      if (!(i & h)) {
        const double a = x[i], b = x[i + h];
        x[i] = a + b;
        x[i + h] = a - b;
      }
#pragma unroll
  for (int kb = 1; kb < NCH; kb <<= 1)
    if (kb * LPR * VEC < D) {
#pragma unroll
      for (int i = 0; i < E; ++i)
        if (!(i & (kb * VEC))) {
          const double a = x[i], b = x[i + kb * VEC];
          x[i] = a + b;
          x[i + kb * VEC] = a - b;
        }
    }
  for (int s = 1; s < LPR; s <<= 1) {
    const bool hi = l & s;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const double y = __shfl_xor_sync(0xffffffffu, x[i], s);
      x[i] = hi ? y - x[i] : x[i] + y;
    }
  }
}

// The INT4 byte of code c[0] (low nibble) and code c[h] (high nibble).
__device__ __forceinline__ unsigned int packed_int4(const int8_t* c, int h) {
  return (unsigned int)((c[0] & 0xF) | ((c[h] & 0xF) << 4));
}

// VEC elements of row `row` (or zeros past the rows or the row's end) at
// column c into v.
template <int VEC, typename Tin>
__device__ __forceinline__ void load_chunk(float* v, const Tin* x, long long row, long long n,
                                           int c, int D) {
  float t[VEC];
  if (row < n && c < D) {
    load_x(t, x + row * D + c);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) t[j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) v[j] = t[j];
}

// round(a / b) to nearest, as the IEEE division a / b (`__fdiv_rn`), from
// y = the correctly rounded 1/b: a·y is within two ulps of a / b, one FMA
// correction brings it within one, and a second gives the correctly
// rounded quotient (Markstein: y within half an ulp of 1/b, q within one
// ulp of a/b, r = a - b·q exact by FMA; here a/b never overflows, and where
// it is small enough for r to underflow it rounds to the code 0 either way).
__device__ __forceinline__ float div_rn(float a, float b, float y) {
  float q = __fmul_rn(a, y);
  q = __fmaf_rn(__fmaf_rn(-b, q, a), y, q);
  return __fmaf_rn(__fmaf_rn(-b, q, a), y, q);
}

// clip(rint(q), -qmax - 1, qmax) as a byte, for |q| < 2^22, on the FP32
// pipes: adding 1.5·2^23 rounds q to an integer, half to even (rintf's
// rounding), in the low mantissa bits, whose low byte is the code's two's
// complement (the conversion units, an eighth of the FP32 rate, stay idle).
__device__ __forceinline__ unsigned int code_byte(float q, float lo, float hi) {
  constexpr float MAGIC = 12582912.f;  // 1.5·2^23
  return __float_as_uint(fminf(fmaxf(__fadd_rn(q, MAGIC), lo), hi)) & 0xFFu;
}

template <typename Tin, int VEC, bool HAD>
__global__ void __launch_bounds__(QR_WARPS * 32)
    quant_rows_vec_kernel(const Tin* __restrict__ x, const float* __restrict__ mean,
                          int8_t* __restrict__ vals, float* __restrict__ scales, long long n,
                          int S, int D, int lpr_log2, int qmax, int int4, float hval) {
  constexpr int E = lane_elems<Tin, VEC>();
  constexpr int NCH = E / VEC;
  __shared__ __align__(16) int8_t s_code[QR_WARPS][E * 32];  // INT4: one row group's codes
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int LPR = 1 << lpr_log2, RPW = 32 >> lpr_log2;
  const int rw = lane >> lpr_log2, l = lane & (LPR - 1);  // row of the group, lane in the row
  const float fq = (float)qmax;
  const float lo = 12582912.f - fq - 1.f, hi = 12582912.f + fq;  // the clip, after the shift
  // Each warp walks a contiguous range of row groups, so the rows of a
  // channel mean stay together and the mean is read once a run of them.
  const long long groups = (n + RPW - 1) / RPW;
  const long long nw = (long long)gridDim.x * QR_WARPS;
  const long long per = (groups + nw - 1) / nw;
  const long long g_begin = ((long long)blockIdx.x * QR_WARPS + warp) * per;
  const long long g_end = g_begin + per < groups ? g_begin + per : groups;
  if (g_begin >= g_end) return;
  // (head, position) of this lane's row, advanced RPW rows a group; the
  // mean of head `mh` held in `m`.
  long long row = g_begin * RPW + rw;
  long long hd = row / S;
  int hs = (int)(row - hd * S);
  long long mh = -1;
  float m[E];

  float nxt[E];
#pragma unroll
  for (int k = 0; k < NCH; ++k) load_chunk<VEC>(&nxt[k * VEC], x, row, n, (k * LPR + l) * VEC, D);
  for (long long g = g_begin; g < g_end; ++g, row += RPW) {
    float v[E];
#pragma unroll
    for (int i = 0; i < E; ++i) v[i] = nxt[i];
    // The next group's loads go out before this one's arithmetic.
#pragma unroll
    for (int k = 0; k < NCH; ++k)
      load_chunk<VEC>(&nxt[k * VEC], x, g + 1 < g_end ? row + RPW : n, n, (k * LPR + l) * VEC, D);
    const bool ok = row < n;
    if (HAD) {
      double y[E];
#pragma unroll
      for (int i = 0; i < E; ++i) y[i] = v[i];
      fwht<VEC, E>(y, D, LPR, l);
#pragma unroll
      for (int i = 0; i < E; ++i) v[i] = (float)(y[i] * (double)hval);
    }
    if (mean && ok) {
      if (hd != mh) {
        mh = hd;
#pragma unroll
        for (int k = 0; k < NCH; ++k) {
          const int c = (k * LPR + l) * VEC;
          if (c < D) {
            float t[VEC];
            load_n(t, mean + hd * D + c);
#pragma unroll
            for (int j = 0; j < VEC; ++j) m[k * VEC + j] = t[j];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < NCH; ++k)
        if ((k * LPR + l) * VEC < D)
#pragma unroll
          for (int j = 0; j < VEC; ++j) v[k * VEC + j] = __fsub_rn(v[k * VEC + j], m[k * VEC + j]);
    }
    float amax = 0.f;
#pragma unroll
    for (int k = 0; k < NCH; ++k)
      if (ok && (k * LPR + l) * VEC < D)
#pragma unroll
        for (int j = 0; j < VEC; ++j) amax = fmaxf(amax, fabsf(v[k * VEC + j]));
    for (int o = LPR >> 1; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float scale = __fdiv_rn(fmaxf(amax, 1e-12f), fq);
    const float inv = __frcp_rn(scale);
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int c = (k * LPR + l) * VEC;
      if (!ok || c >= D) continue;
      union {
        typename Raw<VEC>::T r;
        uint8_t q[VEC];
      } codes;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        codes.q[j] = (uint8_t)code_byte(div_rn(v[k * VEC + j], scale, inv), lo, hi);
      if (int4)
        *reinterpret_cast<typename Raw<VEC>::T*>(&s_code[warp][rw * D + c]) = codes.r;
      else
        *reinterpret_cast<typename Raw<VEC>::T*>(vals + row * D + c) = codes.r;
    }
    if (ok && l == 0) scales[row] = scale;
    if (int4) {
      // The group's rows are consecutive, so their packed bytes are one
      // span of RPW·D/2 bytes (fewer in the last group).
      __syncwarp();
      const int h = D / 2;
      const long long r0 = g * RPW;
      const int span = (int)((n - r0 < RPW ? n - r0 : RPW) * h);
      const int8_t* sc = s_code[warp];
      int8_t* dst = vals + r0 * h;
      if (h % 4 == 0) {
        for (int w = lane; w < span / 4; w += 32) {
          const int r = 4 * w / h, j = 4 * w - r * h;
          unsigned int word = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b) word |= packed_int4(sc + r * D + j + b, h) << (8 * b);
          reinterpret_cast<unsigned int*>(dst)[w] = word;
        }
      } else {
        for (int i = lane; i < span; i += 32) {
          const int r = i / h;
          dst[i] = (int8_t)packed_int4(sc + r * D + i - r * h, h);
        }
      }
      __syncwarp();  // the buffer is rewritten by the next group
    }
    hs += RPW;
    while (hs >= S) {
      hs -= S;
      ++hd;
    }
  }
}

template <typename Tin, int VEC, bool HAD>
cudaError_t launch_rows(const void* x, const void* mean, void* vals, void* scales, long long n,
                        int S, int D, int qmax, int int4, float hval, cudaStream_t st) {
  auto kernel = quant_rows_vec_kernel<Tin, VEC, HAD>;
  static int per_sm = 0, sms = 0;  // the card's resident blocks, asked once
  if (!per_sm) {
    int dev;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, QR_WARPS * 32, 0);
    if (err != cudaSuccess) return err;
  }
  int lpr_log2 = 0;
  while ((lane_elems<Tin, VEC>() << lpr_log2) < D) ++lpr_log2;
  const long long groups = (n + (32 >> lpr_log2) - 1) / (32 >> lpr_log2);
  const long long need = (groups + QR_WARPS - 1) / QR_WARPS;
  const int blocks = (int)(need < (long long)per_sm * sms ? need : (long long)per_sm * sms);
  kernel<<<blocks, QR_WARPS * 32, 0, st>>>(static_cast<const Tin*>(x),
                                          static_cast<const float*>(mean),
                                          static_cast<int8_t*>(vals), static_cast<float*>(scales),
                                          n, S, D, lpr_log2, qmax, int4, hval);
  return cudaGetLastError();
}

template <typename Tin, bool HAD>
cudaError_t launch_vec(int vec, const void* x, const void* mean, void* vals, void* scales,
                       long long n, int S, int D, int qmax, int int4, float hval, cudaStream_t st) {
  switch (vec) {
    case 1: return launch_rows<Tin, 1, HAD>(x, mean, vals, scales, n, S, D, qmax, int4, hval, st);
    case 2: return launch_rows<Tin, 2, HAD>(x, mean, vals, scales, n, S, D, qmax, int4, hval, st);
    case 4: return launch_rows<Tin, 4, HAD>(x, mean, vals, scales, n, S, D, qmax, int4, hval, st);
    case 8:
      if (sizeof(Tin) == 2)
        return launch_rows<__nv_bfloat16, 8, HAD>(x, mean, vals, scales, n, S, D, qmax, int4,
                                                   hval, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x (rows = B*H, S, D) contiguous, in_dtype 0 = float32, 1 = bfloat16; mean
// (B*H, D) float32 or null; vals (rows*S, D) int8, or (rows*S, D/2) packed
// INT4; scales (rows*S) float32. `vec`: elements a lane loads at once (1,
// 2, 4, or 8 for bf16), dividing D, with x aligned to vec elements and
// mean to min(vec, 4) floats. Returns the cudaError_t of the launch.
extern "C" int umfa_quant_rows(const void* x, const void* mean, void* vals, void* scales,
                               int rows, int S, int D, int qmax, int int4, int hadamard,
                               int in_dtype, int vec, void* stream) {
  const int elem = in_dtype == 1 ? 2 : 4;
  if (D < 1 || D > QR_MAXD || (int4 && D % 2) || (hadamard && (D & (D - 1))) || in_dtype < 0 ||
      in_dtype > 1 || vec < 1 || vec * elem > 16 || (vec & (vec - 1)) || D % vec ||
      reinterpret_cast<uintptr_t>(x) % (vec * elem) ||
      reinterpret_cast<uintptr_t>(mean) % (4 * (vec < 4 ? vec : 4)))
    return cudaErrorInvalidValue;
  const long long n = (long long)rows * S;
  // The rotation's scale: fp32(D^-1/2), as the host's hadamard_matrix.
  const float hval = (float)pow((double)D, -0.5);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0)
    return hadamard ? launch_vec<float, true>(vec, x, mean, vals, scales, n, S, D, qmax, int4,
                                              hval, st)
                    : launch_vec<float, false>(vec, x, mean, vals, scales, n, S, D, qmax, int4,
                                               hval, st);
  return hadamard ? launch_vec<__nv_bfloat16, true>(vec, x, mean, vals, scales, n, S, D, qmax,
                                                    int4, hval, st)
                  : launch_vec<__nv_bfloat16, false>(vec, x, mean, vals, scales, n, S, D, qmax,
                                                     int4, hval, st);
}
