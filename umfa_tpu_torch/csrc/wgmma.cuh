// Warpgroup tensor-core building blocks for Hopper, sm_90a: `wgmma.mma_async`
// m64nNk16 bf16 -> fp32, its shared-memory matrix descriptor, the 128-byte
// swizzled tile layout the descriptor reads, fence / commit / wait, and the
// register layouts of the A operand and of the accumulator. Four warps (a
// warpgroup, threads 128w' .. 128w' + 127 of the block) issue each product
// together; it runs asynchronously until a wait retires its group.
//
// Tile layout (K-major, 128-byte swizzle, `SW128`). An R x KT bf16 operand
// (R rows of the M or N side, R a multiple of 8; KT columns of the K side,
// a multiple of 8) is stored as ceil(KT / 64) column blocks of R x 64
// elements: block j (columns 64j .. 64j + 63) at element j·R·64, its row r
// a 128-byte line at r·64, and the 16-byte chunk c (columns 8c .. 8c + 7)
// of row r at chunk position c ^ (r % 8) (`sw128_index`). The XOR spreads
// the eight rows of an 8 x 8 core matrix over all 32 banks. Each column
// block starts on a 1024-byte boundary (the swizzle repeats every 8 rows),
// so the tile's base must be 1024-byte aligned and R a multiple of 8. A
// column block is read by both sides of a product in the same form: the A
// operand (rows = M) and the B operand stored transposed (rows = N, the
// K x N matrix as its N x K transpose; `store_sw128_t` writes a row-major
// [k][n] source that way), which is wgmma's default, no-transpose layout.
//
// Descriptor (`sw128_desc`, 64 bits): bits 0-13 the start address in
// shared memory / 16; bits 16-29 the leading byte offset / 16 (unused by a
// swizzled K-major layout whose 16-deep step lies inside one 128-byte line;
// set to 1); bits 32-45 the stride byte offset / 16, the distance between
// 8-row core groups (1024 bytes: 64); bits 49-51 the base offset (0: each
// column block is 1024-byte aligned, and a step's start moves only inside a
// line); bits 62-63 the swizzle mode (1 = 128-byte). The 16-deep step over
// columns k0 .. k0 + 15 (k0 % 16 == 0) starts at column block k0 / 64,
// (k0 % 64)·2 bytes into its first line.
//
// Order of memory: generic stores into a tile (plain st.shared) become
// visible to the asynchronous proxy that wgmma reads through only after
// `fence_proxy_async` by the storing threads and a barrier. `wgmma_fence`
// comes before the first product of a group whenever the accumulator or
// the A registers were touched by other instructions since the last one.
// `wgmma_commit` closes the products issued since the last commit into a
// group; `wgmma_wait<N>` returns when at most N groups are in flight, and
// only then may their accumulators be read or their A registers changed.
// `fence_operand` keeps the compiler from moving accesses of an
// accumulator across these points.
//
// Register layout of the A operand from registers (RS, m64nNk16): warp w of
// the warpgroup holds rows 16w .. 16w + 15 as the A fragment of mma.sync
// m16n8k16 (mma.cuh): lane l, g = l / 4, t = l % 4,
//   a[0] = A[16w+g][2t..2t+1],  a[1] = A[16w+g+8][2t..],
//   a[2] = A[16w+g][2t+8..],    a[3] = A[16w+g+8][2t+8..],
// two bf16 a register, the lower k in the low half (`load_a_sw128` reads it
// from a SW128 tile with ldmatrix).
//
// Accumulator layout (m64nNk16 f32, N/2 registers a thread): register i of
// thread l + 32w holds D[16w + g + 8·((i / 2) % 2)][8·(i / 4) + 2t + i % 2]
// (`acc_row`, `acc_col`): the C fragments of mma.sync m16n8k16 for the N/8
// column tiles of the warp's 16 rows, tile j in registers 4j .. 4j + 3. So
// the accumulators of columns 16j .. 16j + 15, rounded to bf16 pairs, are
// the A fragment of the next product's 16-deep step j (mma.cuh `pack_a`).
//
// Checked on the card against a plain product by csrc/mma_probe.cu, which
// runs SS (rep 0) and RS (every later rep) products at N 64 and 128 over
// tiles of one to four column blocks.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma.cuh"

namespace umfa {

// Element offset of (r, k) in a SW128 tile of `rows` rows.
__device__ __forceinline__ int sw128_index(int r, int k, int rows) {
  return (k >> 6) * rows * 64 + r * 64 + ((((k >> 3) & 7) ^ (r & 7)) << 3) + (k & 7);
}

// Descriptor of the 16-deep step at column k0 of a SW128 tile of `rows`
// rows based at `tile` (1024-byte aligned).
__device__ __forceinline__ uint64_t sw128_desc(const __nv_bfloat16* tile, int rows, int k0) {
  const uint32_t addr = smem_addr(tile + (k0 >> 6) * rows * 64 + (k0 & 63));
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// rows x cols of a row-major bf16 matrix (row stride ld elements; src, ld
// and cols multiples of 8 elements, src 16-byte aligned) into a SW128 tile,
// 16-byte loads and stores by all threads of the block.
__device__ __forceinline__ void store_sw128(__nv_bfloat16* tile, const __nv_bfloat16* src,
                                            long long ld, int rows, int cols) {
  const int chunks = cols >> 3;
  for (int e = threadIdx.x; e < rows * chunks; e += blockDim.x) {
    const int r = e / chunks, c = (e - r * chunks) << 3;
    *reinterpret_cast<uint4*>(tile + sw128_index(r, c, rows)) =
        *reinterpret_cast<const uint4*>(src + r * ld + c);
  }
}

// The transpose: tile row n, column k = src[k·ld + n], for a source stored
// [k][n] (n contiguous; cols a multiple of 8). Neighbouring threads read
// neighbouring n (coalesced), and each stores one 16-byte chunk.
__device__ __forceinline__ void store_sw128_t(__nv_bfloat16* tile, const __nv_bfloat16* src,
                                              long long ld, int rows, int cols) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  for (int e = threadIdx.x; e < rows * (cols >> 3); e += blockDim.x) {
    const int n = e % rows, c = (e / rows) << 3;
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (uint32_t)s[(c + 2 * i) * ld + n] | ((uint32_t)s[(c + 2 * i + 1) * ld + n] << 16);
    *reinterpret_cast<uint4*>(tile + sw128_index(n, c, rows)) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The RS A fragment of rows [r0, r0 + 16) (this warp's) over columns
// [k0, k0 + 16) of a SW128 tile of `rows` rows.
__device__ __forceinline__ void load_a_sw128(uint32_t (&a)[4], const __nv_bfloat16* tile,
                                             int rows, int r0, int k0, int lane) {
  ldsm_x4(a, tile + sw128_index(r0 + (lane & 15), k0 + (lane >> 4) * 8, rows));
}

// Row and column, in the 64 x N output tile, of accumulator register i of
// thread `tid` (0..127) of the warpgroup.
__device__ __forceinline__ int acc_row(int i, int tid) {
  return ((tid >> 5) << 4) + ((tid & 31) >> 2) + ((i >> 1) & 1) * 8;
}
__device__ __forceinline__ int acc_col(int i, int tid) {
  return (i >> 2) * 8 + (tid & 3) * 2 + (i & 1);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A·B over one 16-deep step, A (64 x 16) and B (16 x N) from SW128
// tiles by descriptor (SS) or A from registers (RS); scale_d 0 overwrites d.
// N = 64 (32 registers of d) and N = 128 (64).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

}  // namespace umfa
