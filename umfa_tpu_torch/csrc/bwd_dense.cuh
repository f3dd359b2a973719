// The dense load stages of the tensor-core backward bodies (bwd_tc.cuh):
// bf16 or fp32 rows of q, k, v and dO copied straight into padded tiles,
// which the products read where they landed. `csrc/flash_bwd.cu` (the dense
// backward) and `csrc/ring_attn.cu` (the ring backward step) both launch
// the bodies with these stages through `launch_dense`; the arithmetic they
// hold to is in flash_bwd.cu's header.
#pragma once

#include <type_traits>

#include "bwd_tc.cuh"

namespace umfa {

// The product policy of an input type.
template <typename T>
using MmaFor = std::conditional_t<sizeof(T) == 2, Bf16Mma, Tf32x3Mma>;

// Rows [0, ROWS) of a bf16 or fp32 matrix with rows of D elements (src: its
// first row; n live rows) into a tile of row stride DP + PAD, each value
// times `scale` and rounded to T once when SCALED (the reference's Q·scale,
// flash_bwd.py:52); rows at or past n and columns past D are 0. wide: four
// values at a time (D % 4 == 0, src aligned to four elements).
template <int DP, bool SCALED, int ROWS = 64, typename T>
__device__ __forceinline__ void stage_rows_tile(T* dst, const T* src, int n, int D, bool wide,
                                                float scale) {
  constexpr int C4 = DP / 4;
  constexpr int LD = DP + MmaFor<T>::PAD;
  for (int e = threadIdx.x; e < ROWS * C4; e += blockDim.x) {
    const int r = e / C4, c = (e - r * C4) * 4;
    const T* row = src + (long long)r * D;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < n) {
      if (wide) {
        if (c < D) load4(row + c, x);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = c + i < D ? Elem<T>::load(row, c + i) : 0.f;
      }
    }
    if (SCALED) {
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = __fmul_rn(x[i], scale);
    }
    store4(dst + r * LD + c, x);  // unscaled values: exact
  }
}

// dQ: Q and dO staged once; each key tile's K and V copied by cp.async
// straight into padded tiles, which the products read where they landed
// (three staging buffers, copies two steps ahead; fp32 at D 256, where
// three do not fit beside Q and dO, two, copies one step ahead; nothing
// converted, no per-key score term).
template <int DP, typename T>
struct DenseDqLoad {
  using G = DqTile<DP, MmaFor<T>>;
  static constexpr int KT = G::KT, LD = G::LD;
  static constexpr int NRAW = G::WIDE32 ? 2 : 3, AHEAD = NRAW - 1, IN_FLIGHT = NRAW - 2;
  static constexpr int RAW_BYTES = 2 * KT * LD * (int)sizeof(T);  // K, V (row stride LD)
  struct Kv {
    static constexpr int BYTES = 0;
    T* k;
    T* v;
    __device__ __forceinline__ Kv(unsigned char*, unsigned char* raw) {
      k = reinterpret_cast<T*>(raw);
      v = k + KT * LD;
    }
    __device__ __forceinline__ float score(float x, int) const { return x; }
  };

  // Q·scale (rounded to T), dO, LSE and δ of query rows [q0, q0 + 64); no
  // dP term.
  static __device__ __forceinline__ void stage_q(T* sQ, T* sO, float* sRow, const BwdParams& p,
                                                 long long qbh, long long, int q0) {
    const int n = min(64, p.Sq - q0);
    const long long r0 = qbh * p.Sq + q0;
    stage_rows_tile<DP, true>(sQ, static_cast<const T*>(p.q) + r0 * p.D, n, p.D, p.wide,
                              p.scale);
    stage_rows_tile<DP, false>(sO, static_cast<const T*>(p.dout) + r0 * p.D, n, p.D, p.wide,
                               1.f);
    for (int r = threadIdx.x; r < 64; r += blockDim.x) {
      sRow[r] = 0.f;
      sRow[64 + r] = r < n ? p.lse[r0 + r] : 0.f;
      sRow[128 + r] = r < n ? p.delta[r0 + r] : 0.f;
    }
  }

  // The copies of key rows [k0, k0 + KT) into `raw`, as the products read them.
  static __device__ __forceinline__ void issue(unsigned char* raw, const BwdParams& p, long long,
                                               long long kbh, int k0, bool vec) {
    const int n = min(KT, p.Sk - k0);
    const long long off = (kbh * p.Sk + k0) * p.D;
    T* k = reinterpret_cast<T*>(raw);
    load_tile<KT, DP, LD>(k, static_cast<const T*>(p.k) + off, n, p.D, 0, vec);
    load_tile<KT, DP, LD>(k + KT * LD, static_cast<const T*>(p.v) + off, n, p.D, 0, vec);
  }

  static __device__ __forceinline__ void stage(const unsigned char*, const Kv&, const BwdParams&,
                                               long long, int) {}
};

// dK/dV: a query tile as the products read it. Its staging buffer (three
// of them, copied two steps ahead) holds the raw Q (dK's operand,
// flash_bwd.py:451-456), dO, LSE and δ as they landed; its converted buffer
// Q·scale rounded to T (Sᵀ's operand, flash_bwd.py:52) and the dP term
// vt = 0. bf16 at D 64: the scale 1/8 is exact and the two Q operands
// agree; at D 80 or 128 dK from the scaled Q would be off by relerr ~1e-3.
template <int DP, typename T>
struct DenseQTile {
  using G = DkvTile<DP, MmaFor<T>>;
  static constexpr int QT = G::QT, LD = G::LD;
  static constexpr int BYTES = QT * LD * (int)sizeof(T) + QT * 4;  // Q·scale, vt
  static constexpr int RAW_O = QT * LD * (int)sizeof(T);
  static constexpr int RAW_L = 2 * QT * LD * (int)sizeof(T);
  static constexpr int RAW_D = RAW_L + QT * 4;
  static constexpr int RAW_BYTES = RAW_D + QT * 4;  // Q, dO (LD), LSE, δ
  T* q;
  T* qk;
  T* o;
  float* vt;
  float* lse;
  float* delta;
  __device__ __forceinline__ DenseQTile(unsigned char* conv, unsigned char* raw) {
    q = reinterpret_cast<T*>(conv);
    vt = reinterpret_cast<float*>(q + QT * LD);
    qk = reinterpret_cast<T*>(raw);
    o = reinterpret_cast<T*>(raw + RAW_O);
    lse = reinterpret_cast<float*>(raw + RAW_L);
    delta = reinterpret_cast<float*>(raw + RAW_D);
  }
};

template <int DP, typename T>
struct DenseLoad {
  using G = DkvTile<DP, MmaFor<T>>;
  using Tile = DenseQTile<DP, T>;
  static constexpr int NRAW = 3, RAW_BYTES = Tile::RAW_BYTES;
  static constexpr bool HEAD_TERMS = false;  // no corr row, no Q-mean term

  static __device__ __forceinline__ float dk_scale(const BwdParams& p) { return p.scale; }

  // K and V of key rows [k0, k0 + KB); the dense backward has no V mean.
  static __device__ __forceinline__ void stage_kv(T* sK, T* sV, float* sVm, const BwdParams& p,
                                                  long long kbh, int k0) {
    const int n = min(G::KB, p.Sk - k0);
    const long long off = (kbh * p.Sk + k0) * p.D;
    stage_rows_tile<DP, false, G::KB>(sK, static_cast<const T*>(p.k) + off, n, p.D, p.wide, 1.f);
    stage_rows_tile<DP, false, G::KB>(sV, static_cast<const T*>(p.v) + off, n, p.D, p.wide, 1.f);
    for (int c = threadIdx.x; c < DP; c += blockDim.x) sVm[c] = 0.f;
  }

  // The copies of query rows [q0, q0 + QT) of head qbh into `raw`, as the
  // products read them.
  static __device__ __forceinline__ void issue(unsigned char* raw, const BwdParams& p,
                                               long long qbh, int q0, bool vec) {
    const int n = min(G::QT, p.Sq - q0);
    const long long r0 = qbh * p.Sq + q0;
    load_tile<G::QT, DP, G::LD>(reinterpret_cast<T*>(raw), static_cast<const T*>(p.q) + r0 * p.D,
                                n, p.D, 0, vec);
    load_tile<G::QT, DP, G::LD>(reinterpret_cast<T*>(raw + Tile::RAW_O),
                                static_cast<const T*>(p.dout) + r0 * p.D, n, p.D, 0, vec);
    load_rows_f32<G::QT>(reinterpret_cast<float*>(raw + Tile::RAW_L), p.lse + r0, n);
    load_rows_f32<G::QT>(reinterpret_cast<float*>(raw + Tile::RAW_D), p.delta + r0, n);
  }

  // Q·scale from the raw Q of tile t (zero where it is), 16 bytes a thread
  // (each value rounded to T once); vt = 0.
  static __device__ __forceinline__ void stage(const unsigned char*, const Tile& t, const float*,
                                               const BwdParams& p, long long, int) {
    constexpr int E = 16 / (int)sizeof(T);
    constexpr int CE = DP / E;
    for (int e = threadIdx.x; e < G::QT * CE; e += blockDim.x) {
      const int r = e / CE, c = (e - r * CE) * E;
      if constexpr (sizeof(T) == 2) {
        uint4 w = *reinterpret_cast<const uint4*>(t.qk + r * G::LD + c);
        w.x = scale_bf16x2(w.x, p.scale);
        w.y = scale_bf16x2(w.y, p.scale);
        w.z = scale_bf16x2(w.z, p.scale);
        w.w = scale_bf16x2(w.w, p.scale);
        *reinterpret_cast<uint4*>(t.q + r * G::LD + c) = w;
      } else {
        float4 w = *reinterpret_cast<const float4*>(t.qk + r * G::LD + c);
        w.x = __fmul_rn(w.x, p.scale);
        w.y = __fmul_rn(w.y, p.scale);
        w.z = __fmul_rn(w.z, p.scale);
        w.w = __fmul_rn(w.w, p.scale);
        *reinterpret_cast<float4*>(t.q + r * G::LD + c) = w;
      }
    }
    for (int r = threadIdx.x; r < G::QT; r += blockDim.x) t.vt[r] = 0.f;
  }
};

// One dense backward pass: dK/dV (dkv) or dQ on Tin inputs into Tout
// gradients, head dims up to DP; RING (fp32 outputs) and SPARSE as in
// bwd_tc.cuh.
template <typename Tin, typename Tout, int DP, bool RING = false, bool SPARSE = false>
cudaError_t launch_dense(BwdParams p, bool dkv, cudaStream_t stream) {
  // Rows by 16-byte cp.async when every row of q, k, v and dO starts
  // 16-byte aligned; four values at a time when rows start at a multiple of
  // four elements.
  const int vec = p.D % (16 / (int)sizeof(Tin)) == 0 && aligned({p.q, p.k, p.v, p.dout}, 16);
  using Mma = MmaFor<Tin>;
  if (dkv) {
    p.wide = p.D % 4 == 0 && aligned({p.k, p.v}, 4 * sizeof(Tin));
    return launch_dkv_tc<DenseLoad<DP, Tin>, Mma, Tout, DP, RING, SPARSE>(p, vec, stream);
  }
  p.wide = p.D % 4 == 0 && aligned({p.q, p.dout}, 4 * sizeof(Tin));
  return launch_dq_tc<DenseDqLoad<DP, Tin>, Mma, Tout, DP, RING, SPARSE>(p, vec, stream);
}

// Dynamic shared memory of the dense dQ (dkv = 0) or dK/dV (dkv = 1) body
// for head dim D on bf16 (bf16 = 1) or fp32 inputs, in bytes; 0 if it does
// not take them (D <= 256).
inline int dense_smem_bytes(int D, int dkv, int bf16) {
  if (D < 1 || D > 256) return 0;
  if (!bf16) {
    if (dkv)
      return D <= 64    ? dkv_smem_bytes<DenseLoad<64, float>, Tf32x3Mma, 64>()
             : D <= 128 ? dkv_smem_bytes<DenseLoad<128, float>, Tf32x3Mma, 128>()
                        : dkv_smem_bytes<DenseLoad<256, float>, Tf32x3Mma, 256>();
    return D <= 64    ? dq_smem_bytes<DenseDqLoad<64, float>, Tf32x3Mma, 64>()
           : D <= 128 ? dq_smem_bytes<DenseDqLoad<128, float>, Tf32x3Mma, 128>()
                      : dq_smem_bytes<DenseDqLoad<256, float>, Tf32x3Mma, 256>();
  }
  using B16 = __nv_bfloat16;
  if (dkv)
    return D <= 64    ? dkv_smem_bytes<DenseLoad<64, B16>, Bf16Mma, 64>()
           : D <= 128 ? dkv_smem_bytes<DenseLoad<128, B16>, Bf16Mma, 128>()
                      : dkv_smem_bytes<DenseLoad<256, B16>, Bf16Mma, 256>();
  return D <= 64    ? dq_smem_bytes<DenseDqLoad<64, B16>, Bf16Mma, 64>()
         : D <= 128 ? dq_smem_bytes<DenseDqLoad<128, B16>, Bf16Mma, 128>()
                    : dq_smem_bytes<DenseDqLoad<256, B16>, Bf16Mma, 256>();
}

}  // namespace umfa
