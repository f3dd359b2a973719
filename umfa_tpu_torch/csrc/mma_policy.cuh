// The product policies of the tensor-core attention bodies for Hopper,
// sm_90a: `Bf16Mma` (bf16 tiles, mma.sync m16n8k16 bf16 -> fp32) and
// `Tf32x3Mma` (fp32 tiles, every product as three mma.sync m16n8k8 tf32 ->
// fp32 on split operands, mma.cuh). The backward bodies (bwd_tc.cuh) use
// `scores`, `grad` and `grads`; the forward body (fwd_tc.cuh) uses `FwdQ`,
// `qk`, `grad` (its P·V), `round_p` and `exp`.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace umfa {

// ---- Product policies ------------------------------------------------------
//
// The three product phases of the bodies, each over one warp's 16 rows:
//   scores<DP, NB>(s, dp, a1, a2, b1, b2, ld, r0, lane):
//       s += A1·B1ᵀ and dp += A2·B2ᵀ over DP columns, for rows [r0, r0 + 16)
//       of A tiles stored [row][d] and the NB rows of B tiles stored [n][d];
//   grad<NK, NA>(acc, c, b, ld, n0, lane):
//       acc += C·B, C (16 x NK) in the C fragments c, B rows [0, NK) of a
//       tile stored [k][n], columns [n0, n0 + 8·NA);
//   grads<NK, NA>(acc1, acc2, c1, c2, b1, b2, ld, n0, lane):
//       acc1 += C1·B1 and acc2 += C2·B2, interleaved.
// And those of the forward body, over one warp's 16 rows:
//   FwdQ<DP>                   Q's A fragments (DP columns), held in
//       registers for the whole walk where they fit (`load`), else read from
//       the Q tile at each use;
//   qk<DP, NB>(s, q, a, b, ld, r0, lane):
//       s += Q·Bᵀ, Q rows [r0, r0 + 16) of the tile a (or q's registers), B
//       the NB rows of a tile stored [n][d];
//   round_p(x)                 P as P·V takes it (bf16: rounded; fp32: as is);
//   exp(x)                     the softmax exponential;
// P·V itself is grad<NK, NA>(acc, p, v, ld, 0, lane).
// T is the element of the tiles in shared memory, padded to a row stride of
// (width + PAD) elements (16 bytes past a multiple of 128).

struct Bf16Mma {
  using T = __nv_bfloat16;
  static constexpr int PAD = 8;

  template <int DP, int NB>
  static __device__ __forceinline__ void scores(float (&s)[NB / 8][4], float (&dp)[NB / 8][4],
                                                const T* a1, const T* a2, const T* b1,
                                                const T* b2, int ld, int r0, int lane) {
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      uint32_t x1[4], x2[4];
      load_a(x1, a1, ld, r0, ks * 16, lane);
      load_a(x2, a2, ld, r0, ks * 16, lane);
#pragma unroll
      for (int jj = 0; jj < NB / 16; ++jj) {
        uint32_t y0[2], y1[2];
        load_b_nk(y0, y1, b1, ld, jj * 16, ks * 16, lane);
        mma_bf16(s[2 * jj], x1, y0);
        mma_bf16(s[2 * jj + 1], x1, y1);
        load_b_nk(y0, y1, b2, ld, jj * 16, ks * 16, lane);
        mma_bf16(dp[2 * jj], x2, y0);
        mma_bf16(dp[2 * jj + 1], x2, y1);
      }
    }
  }

  // A from the C fragments rounded to bf16 (`pack_a`), B via ldmatrix.trans.
  template <int NK, int NA>
  static __device__ __forceinline__ void grad(float (&acc)[NA][4], const float (&c)[NK / 8][4],
                                              const T* b, int ld, int n0, int lane) {
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk) {
      uint32_t a[4];
      pack_a(a, c[2 * kk], c[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < NA / 2; ++dn) {
        uint32_t y0[2], y1[2];
        load_b_kn(y0, y1, b, ld, kk * 16, n0 + dn * 16, lane);
        mma_bf16(acc[2 * dn], a, y0);
        mma_bf16(acc[2 * dn + 1], a, y1);
      }
    }
  }

  template <int NK, int NA>
  static __device__ __forceinline__ void grads(float (&acc1)[NA][4], float (&acc2)[NA][4],
                                               const float (&c1)[NK / 8][4],
                                               const float (&c2)[NK / 8][4], const T* b1,
                                               const T* b2, int ld, int n0, int lane) {
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk) {
      uint32_t a1[4], a2[4];
      pack_a(a1, c1[2 * kk], c1[2 * kk + 1]);
      pack_a(a2, c2[2 * kk], c2[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < NA / 2; ++dn) {
        uint32_t y0[2], y1[2];
        load_b_kn(y0, y1, b1, ld, kk * 16, n0 + dn * 16, lane);
        mma_bf16(acc1[2 * dn], a1, y0);
        mma_bf16(acc1[2 * dn + 1], a1, y1);
        load_b_kn(y0, y1, b2, ld, kk * 16, n0 + dn * 16, lane);
        mma_bf16(acc2[2 * dn], a2, y0);
        mma_bf16(acc2[2 * dn + 1], a2, y1);
      }
    }
  }

  // ---- forward ----
  template <int DP>
  struct FwdQ {
    static constexpr bool REG = DP <= 128;
    uint32_t f[REG ? DP / 16 : 1][4];
    __device__ __forceinline__ void load(const T* a, int ld, int r0, int lane) {
      if (REG) {
#pragma unroll
        for (int ks = 0; ks < (REG ? DP / 16 : 1); ++ks) load_a(f[ks], a, ld, r0, ks * 16, lane);
      }
    }
  };

  template <int DP, int NB>
  static __device__ __forceinline__ void qk(float (&s)[NB / 8][4], const FwdQ<DP>& q, const T* a,
                                            const T* b, int ld, int r0, int lane) {
    constexpr bool REG = FwdQ<DP>::REG;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      uint32_t x[4];
      if (REG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = q.f[REG ? ks : 0][e];
      } else {
        load_a(x, a, ld, r0, ks * 16, lane);
      }
#pragma unroll
      for (int jj = 0; jj < NB / 16; ++jj) {
        uint32_t y0[2], y1[2];
        load_b_nk(y0, y1, b, ld, jj * 16, ks * 16, lane);
        mma_bf16(s[2 * jj], x, y0);
        mma_bf16(s[2 * jj + 1], x, y1);
      }
    }
  }

  static __device__ __forceinline__ float round_p(float x) { return round_bf16(x); }
  static __device__ __forceinline__ float exp(float x) { return __expf(x); }
};


// fp32 tiles, 3xTF32 products (mma.cuh): A and n-major B fragments by
// ldmatrix on the tiles viewed as b16, split after the load; A from C
// fragments with the k permutation of `tf32_a_from_c`, and B stored [k][n]
// by two 4-byte shared loads a fragment (rows 2t and 2t + 1, column g: with
// a row stride of width + 4 floats the 32 lanes hit 32 banks).
//
// The tensor cores truncate each mma's fp32 sum (round toward zero), so a
// long chain of mma into one accumulator drifts toward zero by about one
// half-ulp of the running sum a step, in one direction: one accumulator
// over a dK/dV row (~1500 mma at S 4096) missed the fp32 accuracy test
// (tests/test_torch_kernels_cuda.py, 5e-6). So no chain is long: the
// scores keep big·big and the two small products in separate accumulators
// (DP/8 steps each; big·big in chains of QK_CHAIN steps above D 128),
// summed by an fp32 add at the end, and the gradient
// products of one tile (NK/8 steps) go into a zeroed fragment that an fp32
// add (round to nearest) puts on the running sum.
struct Tf32x3Mma {
  using T = float;
  static constexpr int PAD = 4;
  // The longest chain of 8-deep big·big steps into one accumulator where a
  // product's depth is split into chains: the truncated sums of a 16-step
  // chain (the D 128 forward) put the LSE of long causal rows with
  // q ~ N(0, 3) 1.1e-5 from the plain version's, over the 1e-5 gate.
  static constexpr int QK_CHAIN = 4;

  static __device__ __forceinline__ const __nv_bfloat16* b16(const float* s) {
    return reinterpret_cast<const __nv_bfloat16*>(s);
  }

  // B rows k0 + 2t and k0 + 2t + 1, column n0 + g of a tile stored [k][n].
  static __device__ __forceinline__ void load_b_rows(Tf32Split<2>& y, const float* b, int ld,
                                                     int k0, int n0, int lane) {
    const float* p = b + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
    const float x[2] = {p[0], p[ld]};
    split_tf32(y, x);
  }

  // hi += big·big, lo += small·big + big·small.
  static __device__ __forceinline__ void mma_hi_lo(float (&hi)[4], float (&lo)[4],
                                                   const Tf32Split<4>& a, const Tf32Split<2>& b) {
    mma_tf32(lo, a.small, b.big);
    mma_tf32(lo, a.big, b.small);
    mma_tf32(hi, a.big, b.big);
  }

  static __device__ __forceinline__ void add_into(float (&acc)[4], const float (&t)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = __fadd_rn(acc[e], t[e]);
  }

  // The 8-deep steps [k0, k1) of `scores`: big·big into s and dp, the small
  // products into slo and dplo.
  template <int NB>
  static __device__ __forceinline__ void score_steps(float (&s)[NB / 8][4],
                                                     float (&dp)[NB / 8][4],
                                                     float (&slo)[NB / 8][4],
                                                     float (&dplo)[NB / 8][4], const T* a1,
                                                     const T* a2, const T* b1, const T* b2,
                                                     int ld, int r0, int lane, int k0, int k1) {
#pragma unroll
    for (int ks = k0; ks < k1; ++ks) {
      Tf32Split<4> x1, x2;
      uint32_t w[4];
      load_a(w, b16(a1), 2 * ld, r0, ks * 16, lane);
      split_tf32(x1, w);
      load_a(w, b16(a2), 2 * ld, r0, ks * 16, lane);
      split_tf32(x2, w);
#pragma unroll
      for (int jj = 0; jj < NB / 16; ++jj) {
        uint32_t w0[2], w1[2];
        Tf32Split<2> y0, y1;
        load_b_nk(w0, w1, b16(b1), 2 * ld, jj * 16, ks * 16, lane);
        split_tf32(y0, w0);
        split_tf32(y1, w1);
        mma_hi_lo(s[2 * jj], slo[2 * jj], x1, y0);
        mma_hi_lo(s[2 * jj + 1], slo[2 * jj + 1], x1, y1);
        load_b_nk(w0, w1, b16(b2), 2 * ld, jj * 16, ks * 16, lane);
        split_tf32(y0, w0);
        split_tf32(y1, w1);
        mma_hi_lo(dp[2 * jj], dplo[2 * jj], x2, y0);
        mma_hi_lo(dp[2 * jj + 1], dplo[2 * jj + 1], x2, y1);
      }
    }
  }

  // big·big in chains of CHAIN steps a product: one chain (DP/8 steps) by
  // default up to D 128; above, and where the caller asks, chains of
  // QK_CHAIN steps into zeroed fragments, each put on s and dp by an fp32
  // add, as `qk` does: one 32-step chain (D 256) put the fp32 dQ at causal
  // S 1024, q ~ N(0, 3), 6.4e-6 from the plain version, over the 5e-6 of
  // test_flash_bwd_fp32_keeps_highest_accuracy.
  template <int DP, int NB, int CHAIN = (DP > 128 ? QK_CHAIN : DP / 8)>
  static __device__ __forceinline__ void scores(float (&s)[NB / 8][4], float (&dp)[NB / 8][4],
                                                const T* a1, const T* a2, const T* b1,
                                                const T* b2, int ld, int r0, int lane) {
    float slo[NB / 8][4], dplo[NB / 8][4];
#pragma unroll
    for (int j = 0; j < NB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) slo[j][e] = dplo[j][e] = 0.f;
    if constexpr (CHAIN >= DP / 8) {
      score_steps<NB>(s, dp, slo, dplo, a1, a2, b1, b2, ld, r0, lane, 0, DP / 8);
    } else {
#pragma unroll
      for (int k0 = 0; k0 < DP / 8; k0 += CHAIN) {
        float shi[NB / 8][4], dphi[NB / 8][4];
#pragma unroll
        for (int j = 0; j < NB / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) shi[j][e] = dphi[j][e] = 0.f;
        score_steps<NB>(shi, dphi, slo, dplo, a1, a2, b1, b2, ld, r0, lane, k0, k0 + CHAIN);
#pragma unroll
        for (int j = 0; j < NB / 8; ++j) {
          add_into(s[j], shi[j]);
          add_into(dp[j], dphi[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
      add_into(s[j], slo[j]);
      add_into(dp[j], dplo[j]);
    }
  }

  template <int NK, int NA>
  static __device__ __forceinline__ void grad(float (&acc)[NA][4], const float (&c)[NK / 8][4],
                                              const T* b, int ld, int n0, int lane) {
    Tf32Split<4> a[NK / 8];
#pragma unroll
    for (int kk = 0; kk < NK / 8; ++kk) tf32_a_from_c(a[kk], c[kk]);
#pragma unroll
    for (int dn = 0; dn < NA; ++dn) {
      float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < NK / 8; ++kk) {
        Tf32Split<2> y;
        load_b_rows(y, b, ld, kk * 8, n0 + dn * 8, lane);
        mma_tf32x3(t, a[kk], y);
      }
      add_into(acc[dn], t);
    }
  }

  template <int NK, int NA>
  static __device__ __forceinline__ void grads(float (&acc1)[NA][4], float (&acc2)[NA][4],
                                               const float (&c1)[NK / 8][4],
                                               const float (&c2)[NK / 8][4], const T* b1,
                                               const T* b2, int ld, int n0, int lane) {
    Tf32Split<4> a1[NK / 8], a2[NK / 8];
#pragma unroll
    for (int kk = 0; kk < NK / 8; ++kk) {
      tf32_a_from_c(a1[kk], c1[kk]);
      tf32_a_from_c(a2[kk], c2[kk]);
    }
#pragma unroll
    for (int dn = 0; dn < NA; ++dn) {
      float t1[4] = {0.f, 0.f, 0.f, 0.f}, t2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < NK / 8; ++kk) {
        Tf32Split<2> y;
        load_b_rows(y, b1, ld, kk * 8, n0 + dn * 8, lane);
        mma_tf32x3(t1, a1[kk], y);
        load_b_rows(y, b2, ld, kk * 8, n0 + dn * 8, lane);
        mma_tf32x3(t2, a2[kk], y);
      }
      add_into(acc1[dn], t1);
      add_into(acc2[dn], t2);
    }
  }

  // ---- forward ----
  // Q's A fragments loaded and split at each use, as `scores` does: held
  // split in registers (64 at D 64) they left two blocks an SM, 6 % slower
  // at the prefill than three without them.
  template <int DP>
  struct FwdQ {
    __device__ __forceinline__ void load(const T*, int, int, int) {}
  };

  // big·big and the small products in separate accumulators, as `scores`,
  // and big·big over at most QK_CHAIN 8-deep steps into one zeroed fragment,
  // each put on the sum by an fp32 add (QK_CHAIN, above).
  template <int DP, int NB>
  static __device__ __forceinline__ void qk(float (&s)[NB / 8][4], const FwdQ<DP>&, const T* a,
                                            const T* b, int ld, int r0, int lane) {
    float lo[NB / 8][4];
#pragma unroll
    for (int j = 0; j < NB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) lo[j][e] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < DP / 8; k0 += QK_CHAIN) {
      float hi[NB / 8][4];
#pragma unroll
      for (int j = 0; j < NB / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) hi[j][e] = 0.f;
#pragma unroll
      for (int ks = k0; ks < k0 + QK_CHAIN && ks < DP / 8; ++ks) {
        Tf32Split<4> x;
        uint32_t w[4];
        load_a(w, b16(a), 2 * ld, r0, ks * 16, lane);
        split_tf32(x, w);
#pragma unroll
        for (int jj = 0; jj < NB / 16; ++jj) {
          uint32_t w0[2], w1[2];
          Tf32Split<2> y0, y1;
          load_b_nk(w0, w1, b16(b), 2 * ld, jj * 16, ks * 16, lane);
          split_tf32(y0, w0);
          split_tf32(y1, w1);
          mma_hi_lo(hi[2 * jj], lo[2 * jj], x, y0);
          mma_hi_lo(hi[2 * jj + 1], lo[2 * jj + 1], x, y1);
        }
      }
#pragma unroll
      for (int j = 0; j < NB / 8; ++j) add_into(s[j], hi[j]);
    }
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) add_into(s[j], lo[j]);
  }

  static __device__ __forceinline__ float round_p(float x) { return x; }
  static __device__ __forceinline__ float exp(float x) { return expf(x); }
};

}  // namespace umfa
