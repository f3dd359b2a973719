// Tensor-core building blocks for Hopper, sm_90a: `mma.sync` m16n8k16 bf16
// -> fp32, m16n8k32 int8 -> int32, m16n8k8 f64 -> f64 and m16n8k8 tf32 ->
// fp32 (with the 3xTF32 split of fp32 operands), `ldmatrix` (plain and
// transposed), `cp.async`, and the fragment layouts the attention kernels
// rely on.
//
// Fragment layout of m16n8k16 (lane l, g = l / 4, t = l % 4):
//   A (16 x 16, row-major): a[0] = A[g][2t..2t+1], a[1] = A[g+8][2t..],
//                           a[2] = A[g][2t+8..],   a[3] = A[g+8][2t+8..];
//   B (16 x 8):             b[0] = B[2t..2t+1][g], b[1] = B[2t+8..2t+9][g];
//   C (16 x 8, fp32):       c[0..1] = C[g][2t..2t+1], c[2..3] = C[g+8][2t..].
// Each 32-bit register holds two bf16, the lower column (or k) index in
// the low half. The C fragments of two neighbouring 8-column tiles,
// rounded to bf16 pairs, are the A fragment of the 16-deep step over those
// 16 columns (`pack_a`): a product's output feeds the next product without
// a trip through shared memory.
//
// Fragment layout of m16n8k32 s8 -> s32 (`mma_s8`), each register four
// int8, the lowest k in the low byte:
//   A (16 x 32, row-major): a[0] = A[g][4t..4t+3], a[1] = A[g+8][4t..],
//                           a[2] = A[g][4t+16..],  a[3] = A[g+8][4t+16..];
//   B (32 x 8):             b[0] = B[4t..4t+3][g], b[1] = B[4t+16..4t+19][g];
//   C (16 x 8, s32):        as the fp32 C of m16n8k16.
// Bytes 4t..4t+3 of an int8 row are its 16-bit words 2t..2t+1, so with an
// int8 tile viewed as 16-bit words (k0 and the row stride halved), the
// bf16 loaders `load_a` and `load_b_nk` return the int8 fragments of the
// 32-deep step over bytes [2 k0, 2 k0 + 32).
//
// Fragment layout of m16n8k8 f64 -> f64 (`mma_f64`, the FP64 tensor cores,
// DMMA in the SASS), one double a register pair:
//   A (16 x 8, row-major): a[0] = A[g][t],   a[1] = A[g+8][t],
//                           a[2] = A[g][t+4], a[3] = A[g+8][t+4];
//   B (8 x 8):             b[0] = B[t][g],   b[1] = B[t+4][g];
//   C (16 x 8, f64):       as the fp32 C of m16n8k16, so the C fragments of
//                           two neighbouring 8-column tiles, rounded, feed
//                           `pack_a` as the bf16 ones do.
// (Checked on the card against a host product, with m16n8k4 and m16n8k16,
// which extend A and B the same way in k.)
//
// Fragment layout of m16n8k8 tf32 -> fp32 (`mma_tf32`, HMMA in the SASS),
// one tf32 value (an fp32 whose low 13 bits the tensor core ignores) a
// register: A, B and C as for m16n8k8 f64. An fp32 tile with row stride ld
// is, to `ldmatrix`, a b16 tile with row stride 2·ld whose 8 x 8 matrices
// are 8 rows of 4 floats, lane l receiving float l % 4 of row l / 4: so
// `load_a` and `load_b_nk`, given the tile as b16 with ld and k0 doubled,
// return the tf32 A fragment of rows [r0, r0 + 16) over columns
// [k0, k0 + 8) and the B fragments of two 8-row tiles stored [n][k]. The
// C fragment holds columns 2t, 2t+1 where A wants t, t+4: a C tile becomes
// an A fragment with its k index permuted inside the 8-wide step (logical
// t is column 2t, logical t+4 column 2t+1, `tf32_a_from_c`), and the B
// rows are read in the same order (b[0] = B[2t][g], b[1] = B[2t+1][g]),
// which leaves the sum unchanged.
//
// 3xTF32: an fp32 operand x is split into big = tf32(x) and small =
// tf32(x - big), both rounded to nearest (cvt.rna; a raw fp32 given to the
// tensor core would lose its low bits by truncation), and a·b is summed as
// small·big + big·small + big·big (small·small dropped), CUTLASS's order:
// each product keeps ~22 bits of its operands. The tensor cores truncate
// each mma's fp32 sum, so callers keep their chains of mma short (bwd_tc.cuh).
//
// Shared-memory tiles are bf16, row-major, with rows padded to a stride of
// (width + 8) elements: 16 bytes past a multiple of 128, so the eight
// 16-byte rows that one `ldmatrix` phase reads fall in distinct banks.
// Int8 tiles are padded the same way, to (width + 16) bytes, and fp32
// tiles to (width + 4) floats.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace umfa {

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Exact integer product: the s32 sums of int8 products do not wrap for
// the depths used here (|sum| <= 256 * 128 * 128 = 2^22).
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The same shape with A unsigned (u8, 0..255) and B signed: the integer
// P·V of pv_int8, exact for |sum| <= 32 * 255 * 128 < 2^20.
__device__ __forceinline__ void mma_u8s8(int (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An int8 V code tile (BK keys, rows of DP + 16 bytes) into the D-major
// tile (DP rows of BK + 16 bytes) whose 32-bit words are the B fragments
// of m16n8k32 (`mma_u8s8`): in each 32-key step, byte k = 16 h + 4 t + j
// holds key 16 h + 2 t + (j & 1) + 8 (j >> 1), the order in which a thread
// holds the C fragments of two 16-key score chunks, so the P codes enter
// the A fragment as they stand. A thread moves 4 keys x 4 columns by a
// 4 x 4 byte transpose; the caller synchronises.
template <int DP, int NTH, int BK>
__device__ __forceinline__ void transpose_codes(uint8_t* dst, const int8_t* src) {
  constexpr int LDC = DP + 16, LDT = BK + 16, KQ = BK / 4;
  for (int e = threadIdx.x; e < KQ * (DP / 4); e += NTH) {
    const int kq = e % KQ, cq = e / KQ;
    const int k0 = 32 * (kq >> 3) + 16 * ((kq >> 2) & 1), t = kq & 3;
    const int8_t* x = src + (k0 + 2 * t) * LDC + 4 * cq;  // keys +0, +1, +8, +9
    const uint32_t x0 = *reinterpret_cast<const uint32_t*>(x);
    const uint32_t x1 = *reinterpret_cast<const uint32_t*>(x + LDC);
    const uint32_t x2 = *reinterpret_cast<const uint32_t*>(x + 8 * LDC);
    const uint32_t x3 = *reinterpret_cast<const uint32_t*>(x + 9 * LDC);
    const uint32_t lo01 = __byte_perm(x0, x1, 0x5140), lo23 = __byte_perm(x2, x3, 0x5140);
    const uint32_t hi01 = __byte_perm(x0, x1, 0x7362), hi23 = __byte_perm(x2, x3, 0x7362);
    uint8_t* d = dst + 4 * cq * LDT + k0 + 4 * t;
    *reinterpret_cast<uint32_t*>(d) = __byte_perm(lo01, lo23, 0x5410);
    *reinterpret_cast<uint32_t*>(d + LDT) = __byte_perm(lo01, lo23, 0x7632);
    *reinterpret_cast<uint32_t*>(d + 2 * LDT) = __byte_perm(hi01, hi23, 0x5410);
    *reinterpret_cast<uint32_t*>(d + 3 * LDT) = __byte_perm(hi01, hi23, 0x7632);
  }
}

// Double product on the FP64 tensor cores, accumulated in double: a sum
// that is exact in double (as the attention scores of bf16 values are, see
// fused_qattn.cu) comes out the same in any order.
__device__ __forceinline__ void mma_f64(double (&c)[4], const double (&a)[4],
                                       const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An operand fragment of N registers split for 3xTF32.
template <int N>
struct Tf32Split {
  uint32_t big[N], small[N];
};

// tf32(x) rounded to nearest, ties away from zero: cvt.rna.tf32.f32's
// result for every finite x and for ±inf (a carry out of the mantissa
// rounds the exponent up), in two integer operations, where the cvt
// compiles to a NaN test and a select besides. A NaN may come out as
// another NaN or as -0: the operands this splits are finite.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

template <int N>
__device__ __forceinline__ void split_tf32(Tf32Split<N>& f, const float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    f.big[i] = tf32_rna(x[i]);
    f.small[i] = tf32_rna(__fsub_rn(x[i], __uint_as_float(f.big[i])));
  }
}

// The same for N fp32 values held as raw bits (as ldmatrix returns them).
template <int N>
__device__ __forceinline__ void split_tf32(Tf32Split<N>& f, const uint32_t (&w)[N]) {
  float x[N];
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = __uint_as_float(w[i]);
  split_tf32(f, x);
}

// c += a·b in 3xTF32: small·big, big·small, big·big.
__device__ __forceinline__ void mma_tf32x3(float (&c)[4], const Tf32Split<4>& a,
                                           const Tf32Split<2>& b) {
  mma_tf32(c, a.small, b.big);
  mma_tf32(c, a.big, b.small);
  mma_tf32(c, a.big, b.big);
}

// The split A fragment of the 8-deep step over the columns of C tile c
// (k permuted: logical t = column 2t, logical t + 4 = column 2t + 1).
__device__ __forceinline__ void tf32_a_from_c(Tf32Split<4>& a, const float (&c)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
  split_tf32(a, x);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 and receives its share of each in r[0..3].
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed on the way: lane l receives elements
// (2(l%4), l/4) and (2(l%4)+1, l/4) of each.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// A fragment of rows [r0, r0 + 16) and columns [k0, k0 + 16) of a
// row-major tile with row stride ld.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* s, int ld, int r0,
                                       int k0, int lane) {
  ldsm_x4(a, s + (r0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// B fragments of two 8-column tiles (columns n0..n0+15) over k0..k0+15,
// from a tile stored [n][k] (k contiguous): B = sᵀ.
__device__ __forceinline__ void load_b_nk(uint32_t (&b0)[2], uint32_t (&b1)[2],
                                          const __nv_bfloat16* s, int ld, int n0, int k0,
                                          int lane) {
  uint32_t r[4];
  ldsm_x4(r, s + (n0 + (lane >> 4) * 8 + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 8);
  b0[0] = r[0];
  b0[1] = r[1];
  b1[0] = r[2];
  b1[1] = r[3];
}

// B fragments of two 8-column tiles (columns n0..n0+15) over k0..k0+15,
// from a tile stored [k][n] (n contiguous), through ldmatrix.trans.
__device__ __forceinline__ void load_b_kn(uint32_t (&b0)[2], uint32_t (&b1)[2],
                                          const __nv_bfloat16* s, int ld, int k0, int n0,
                                          int lane) {
  uint32_t r[4];
  ldsm_x4_t(r, s + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + n0 + (lane >> 4) * 8);
  b0[0] = r[0];
  b0[1] = r[1];
  b1[0] = r[2];
  b1[1] = r[3];
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of the 16-deep step over the columns of C tiles c0 (the
// lower 8) and c1, each value rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16x2(c0[0], c0[1]);
  a[1] = pack_bf16x2(c0[2], c0[3]);
  a[2] = pack_bf16x2(c1[0], c1[1]);
  a[3] = pack_bf16x2(c1[2], c1[3]);
}

// 16-byte asynchronous copy global -> shared; the first `src_bytes` (0..16)
// are read, the rest of the 16 are zero-filled. Both addresses 16-aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// The same for 4 bytes (through L1): `src_bytes` is 4 or 0 (zero-filled).
// Both addresses 4-aligned.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

// The fp32 value of row r0 + i (one per row, or the one of the (b, h) when
// per_row is 0) into dst[i] by a 4-byte cp.async; 0 past n.
__device__ __forceinline__ void copy_scale(float* dst, const float* src, int per_row, int r0,
                                           int i, int n) {
  const bool ok = r0 + i < n;
  cp_async4(dst + i, src + (per_row && ok ? r0 + i : 0), ok ? 4 : 0);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Reductions over the four lanes (t = l % 4) that share a fragment row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace umfa
