// Gradient of an additive attention bias for Hopper, sm_90a.
//
// Replaces umfa_tpu/ops/flash_bwd.py:628 `_dbias_kernel` (host
// `flash_attention_bias_grad`, flash_bwd.py:708): dbias = dS = P∘(dP − δ),
// with no softmax scale (the bias enters the scores after it,
// flash_bwd.py:699-701), summed over the bias's broadcast batch and head
// dimensions inside the kernel, so the (B, H, Sq, Sk) gradient is never
// written for a (1, 1, Sq, Sk) bias. The wrapper (ops/flash_bwd.py) gives
// delta = rowsum(dO∘O) in fp32, dO in the input type, and a q-broadcast
// bias expanded (stride 0) and its gradient summed afterwards.
//
// What bounds it on this card: per summed (batch, head) it recomputes
// S = Q·Kᵀ and dP = dO·Vᵀ (2 products, 4·D flops a visible pair) and it
// writes a dense fp32 (Bb, Hb, Sq, Sk) result after reading the bias once.
// At the training shape with a (1, 16, S, S) bias summed over batch 8
// (S 4096, D 64, causal) that is 2.75e11 flop, 0.28 ms of bf16 tensor-core
// time, against 1.82e9 bytes, 0.54 ms of HBM time: bound by bytes, near the
// line. fp32 inputs run every product as three TF32 ones, 8.3e11 flop at
// 495 TFLOP/s, 1.67 ms: bound by operations. Beyond HBM, the operands every
// output tile reads again for each summed (b, h) (Q, dO, K, V, from L2) are
// what a kernel has to keep down.
//
// What this design does about it: one body, `dbias_tc_kernel`, with the
// product policy a template parameter (mma_policy.cuh), so both input types
// run on the tensor cores at every head dim.
//   * One block of 8 warps owns a 64-query output tile of one (bias batch,
//     bias head), 128 keys wide for bf16 and 64 for fp32, each warp 16
//     queries x 64 keys (bf16) or 32 keys (fp32: the split operands and a
//     zeroed fragment per product take registers), and keeps the fp32 dS
//     sum in registers across the summed (b, h), walked in a fixed order
//     (one owner, no atomics: deterministic). The bias tile does not change
//     along the summed dimensions, so it is copied into shared memory once
//     per block instead of read from L2 at every step. Each (b, h) arrives as
//     32-column chunks of Q, dO, K and V copied by cp.async straight into
//     padded tiles (LSE and δ with the last chunk), one chunk ahead into
//     the other of two buffers, one barrier a chunk: a chunk's width bounds
//     shared memory, so no head dim needs a wider tile (97,280 bytes for
//     bf16, 93,184 for fp32, at every head dim; above 256 the depth loop
//     only grows, and the fp32 chunks keep their 4-step chains).
//   * bf16 (`Bf16Mma`: mma.sync m16n8k16 bf16 -> fp32 with the fragment
//     code of bwd_tc.cuh): bf16(q·scale) (flash_bwd.py:52) is formed on the
//     A fragments in registers, so nothing is converted in shared memory;
//     two blocks an SM. Against it at the training shape, on one card:
//     64-column chunks (one block an SM, or spills at two), three or four
//     buffers (one block an SM) and 16-column chunks were slower; a
//     128 x 128 tile of 16 warps was no faster at D 64.
//   * fp32 and fp16 (computed as fp32; `Tf32x3Mma`: each product as three
//     mma.sync m16n8k8 tf32 on operands split into big and small TF32
//     parts): fl(q·scale) is formed on the A fragments before the split.
//     The tensor cores truncate each mma's sum, so no chain is long: each
//     chunk's products (4 steps of 3 mma) go into a zeroed fragment that an
//     fp32 add puts on S or dP, as the policy's `grad` does; S and then dP,
//     so one product's fragments are live at a time and a thread fits the
//     128 registers of two blocks an SM. Against it at the training shape,
//     on one card: the small products in accumulators of their own (the
//     policy's `scores`, six accumulators) ran at 192 registers and one
//     block an SM, or spilled at two; 16-column chunks were slower.
// A tile the causal or window rule hides entirely is written as zeros
// without being computed. P uses the LSE as given: index-hidden pairs have
// P = 0, as in the reference (a row masked by a -1e30 bias alone is not
// index-hidden: its LSE is -1e30 and its dbias is not 0).
#include "bwd_tc.cuh"

using namespace umfa;

namespace {

struct DbiasParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  const float* bias;
  float* dbias;
  int B, Hq, Hkv, Sq, Sk, D, Bb, Hb;
  long long bsb, bsh, bsq, bsk;
  float scale;
  int left, right;
};

// The tile of the product policy M (its element T, row padding PAD).
template <class M>
struct DbiasTile {
  using T = typename M::T;
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr int QT = 64;              // the output tile: QT x KT
  static constexpr int NB = BF16 ? 64 : 32;  // keys a warp
  static constexpr int KT = 2 * NB;
  static constexpr int MINB = 2;             // blocks an SM
  static constexpr int W = 32;               // columns of a chunk
  static constexpr int LD = W + M::PAD;      // row stride in shared memory, elements
  // Warp w owns rows 16(w % RW)..+15 and keys NB(w / RW)..+NB-1 of the tile.
  static constexpr int RW = QT / 16;
  static constexpr int NTHR = 32 * RW * (KT / NB);
  // The bias tile (fp32, row stride BLD: float2 reads free of bank conflicts).
  static constexpr int BLD = KT + 8;
  static constexpr int BIAS = QT * BLD * 4;
  // A chunk's buffer: Q, dO (QT x LD), K, V (KT x LD), LSE, δ (QT).
  static constexpr int E = (int)sizeof(T);
  static constexpr int O_OFF = QT * LD * E;
  static constexpr int K_OFF = 2 * QT * LD * E;
  static constexpr int V_OFF = K_OFF + KT * LD * E;
  static constexpr int L_OFF = V_OFF + KT * LD * E;
  static constexpr int D_OFF = L_OFF + QT * 4;
  static constexpr int BUF = D_OFF + QT * 4;
  static constexpr int SMEM = BIAS + 2 * BUF;  // two chunk buffers
};

// S and dP of one warp's 16 rows against its NB keys, built up chunk by
// chunk: zero() at a (b, h)'s first chunk, then chunk() for each.
template <class M, int NB>
struct DbiasScores;

template <int NB>
struct DbiasScores<Bf16Mma, NB> {
  float s[NB / 8][4], dp[NB / 8][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < NB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
  }

  // s += bf16(q·scale)·Kᵀ and dp += dO·Vᵀ over the W columns of a chunk.
  template <int W, int LD>
  __device__ __forceinline__ void chunk(const __nv_bfloat16* sQ, const __nv_bfloat16* sO,
                                        const __nv_bfloat16* sK, const __nv_bfloat16* sV,
                                        int rw, int kw, float scale, int lane) {
#pragma unroll
    for (int ks = 0; ks < W / 16; ++ks) {
      uint32_t aq[4], ao[4];
      load_a(aq, sQ, LD, rw, ks * 16, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) aq[i] = scale_bf16x2(aq[i], scale);
      load_a(ao, sO, LD, rw, ks * 16, lane);
#pragma unroll
      for (int jj = 0; jj < NB / 16; ++jj) {
        uint32_t b0[2], b1[2];
        load_b_nk(b0, b1, sK, LD, kw + jj * 16, ks * 16, lane);
        mma_bf16(s[2 * jj], aq, b0);
        mma_bf16(s[2 * jj + 1], aq, b1);
        load_b_nk(b0, b1, sV, LD, kw + jj * 16, ks * 16, lane);
        mma_bf16(dp[2 * jj], ao, b0);
        mma_bf16(dp[2 * jj + 1], ao, b1);
      }
    }
  }
};

template <int NB>
struct DbiasScores<Tf32x3Mma, NB> {
  float s[NB / 8][4], dp[NB / 8][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < NB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
  }

  // acc += (A·scale)·Bᵀ over the W columns of a chunk: each 8-column tile's
  // W/8 3xTF32 steps into a zeroed fragment (12 mma at W 32), put on acc
  // by an fp32 add, as Tf32x3Mma::grad does.
  template <int W, int LD>
  static __device__ __forceinline__ void product(float (&acc)[NB / 8][4], const float* sA,
                                                 const float* sB, int rw, int kw, float scale,
                                                 int lane) {
    using M = Tf32x3Mma;
    float t[NB / 8][4];
#pragma unroll
    for (int j = 0; j < NB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < W / 8; ++ks) {
      uint32_t w[4];
      load_a(w, M::b16(sA), 2 * LD, rw, ks * 16, lane);
      float x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = __fmul_rn(__uint_as_float(w[i]), scale);
      Tf32Split<4> xa;
      split_tf32(xa, x);
#pragma unroll
      for (int jj = 0; jj < NB / 16; ++jj) {
        uint32_t w0[2], w1[2];
        Tf32Split<2> y0, y1;
        load_b_nk(w0, w1, M::b16(sB), 2 * LD, kw + jj * 16, ks * 16, lane);
        split_tf32(y0, w0);  // each split just before its products: no spill
        mma_tf32x3(t[2 * jj], xa, y0);
        split_tf32(y1, w1);
        mma_tf32x3(t[2 * jj + 1], xa, y1);
      }
    }
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) M::add_into(acc[j], t[j]);
  }

  // fl(q·scale)·Kᵀ, then dO·Vᵀ (one product's fragments live at a time).
  template <int W, int LD>
  __device__ __forceinline__ void chunk(const float* sQ, const float* sO, const float* sK,
                                        const float* sV, int rw, int kw, float scale, int lane) {
    product<W, LD>(s, sQ, sK, rw, kw, scale, lane);
    product<W, LD>(dp, sO, sV, rw, kw, 1.f, lane);
  }
};

template <class M>
__global__ void __launch_bounds__(DbiasTile<M>::NTHR, DbiasTile<M>::MINB)
    dbias_tc_kernel(const DbiasParams p, const int vec) {
  using L = DbiasTile<M>;
  using T = typename L::T;
  constexpr int NB = L::NB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sB = reinterpret_cast<float*>(smem_raw);
  unsigned char* bufs = smem_raw + L::BIAS;  // [2][BUF]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int k0 = blockIdx.x * L::KT, q0 = blockIdx.y * L::QT;
  const int bb = blockIdx.z / p.Hb, bh = blockIdx.z - bb * p.Hb;
  float* out = p.dbias + ((long long)bb * p.Hb + bh) * p.Sq * p.Sk;

  int k_lo, k_hi;
  visible_keys(q0, min(q0 + L::QT, p.Sq) - 1, p.Sk, p.left, p.right, &k_lo, &k_hi);
  if (k_lo > k_hi || k0 > k_hi || k0 + L::KT - 1 < k_lo) {  // hidden entirely
    for (int e = tid; e < L::QT * L::KT; e += L::NTHR) {
      const int row = q0 + e / L::KT, key = k0 + e % L::KT;
      if (row < p.Sq && key < p.Sk) out[(long long)row * p.Sk + key] = 0.f;
    }
    return;
  }

  const int group = p.Hq / p.Hkv;
  const int nh = p.Hb == 1 ? p.Hq : 1;
  const int nch = (p.D + L::W - 1) / L::W;  // column chunks of one (b, h)
  const int total = (p.Bb == 1 ? p.B : 1) * nh * nch;
  const int nq = min(L::QT, p.Sq - q0), nk = min(L::KT, p.Sk - k0);

  // Chunk u (column chunk u % nch of the (u / nch)-th summed (b, h)) into
  // buffer u & 1.
  auto issue = [&](int u) {
    const int n = u / nch, c = u - n * nch;
    const int b = p.Bb == 1 ? n / nh : bb, h = p.Hb == 1 ? n % nh : bh;
    const long long qbh = (long long)b * p.Hq + h, kbh = (long long)b * p.Hkv + h / group;
    const long long qr = (qbh * p.Sq + q0) * p.D, kr = (kbh * p.Sk + k0) * p.D;
    unsigned char* buf = bufs + (u & 1) * L::BUF;
    load_tile<L::QT, L::W, L::LD>(reinterpret_cast<T*>(buf), static_cast<const T*>(p.q) + qr, nq,
                                  p.D, c * L::W, vec);
    load_tile<L::QT, L::W, L::LD>(reinterpret_cast<T*>(buf + L::O_OFF),
                                  static_cast<const T*>(p.dout) + qr, nq, p.D, c * L::W, vec);
    load_tile<L::KT, L::W, L::LD>(reinterpret_cast<T*>(buf + L::K_OFF),
                                  static_cast<const T*>(p.k) + kr, nk, p.D, c * L::W, vec);
    load_tile<L::KT, L::W, L::LD>(reinterpret_cast<T*>(buf + L::V_OFF),
                                  static_cast<const T*>(p.v) + kr, nk, p.D, c * L::W, vec);
    if (c == nch - 1) {
      load_rows_f32<L::QT>(reinterpret_cast<float*>(buf + L::L_OFF), p.lse + qbh * p.Sq + q0, nq);
      load_rows_f32<L::QT>(reinterpret_cast<float*>(buf + L::D_OFF), p.delta + qbh * p.Sq + q0,
                           nq);
    }
  };

  // The bias tile, once: it does not change along the summed dimensions
  // (their strides are 0), so every step reads it from shared memory.
  const float* bias = p.bias + bb * p.bsb + bh * p.bsh;
  for (int e = tid; e < L::QT * L::KT; e += L::NTHR) {
    const int r = e / L::KT, c = e - r * L::KT;
    const bool live = r < nq && c < nk;
    cp_async4(sB + r * L::BLD + c, live ? bias + (q0 + r) * p.bsq + (k0 + c) * p.bsk : bias,
              live ? 4 : 0);
  }
  issue(0);
  cp_async_commit();

  // This warp's rows [r_lo, r_lo + 15] against keys [c_lo, c_lo + NB - 1].
  const int rw = (warp % L::RW) * 16, r_lo = q0 + rw, r_hi = r_lo + 15;
  const int kw = (warp / L::RW) * NB, c_lo = k0 + kw, c_hi = c_lo + NB - 1;
  const int row0 = r_lo + g, row1 = row0 + 8;  // this thread's two rows
  const bool none = r_lo >= p.Sq || c_lo >= p.Sk || (p.right >= 0 && c_lo > r_hi + p.right) ||
                    (p.left >= 0 && c_hi < r_lo - p.left);
  const bool all = r_hi < p.Sq && c_hi < p.Sk && (p.right < 0 || c_hi <= r_lo + p.right) &&
                   (p.left < 0 || c_lo >= r_hi - p.left);

  DbiasScores<M, NB> sc;
  float acc[NB / 8][4];
#pragma unroll
  for (int j = 0; j < NB / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  sc.zero();

  for (int u = 0; u < total; ++u) {
    cp_async_wait<0>();
    __syncthreads();  // chunk u (and the bias tile) landed, chunk u - 1 consumed
    if (u + 1 < total) issue(u + 1);
    cp_async_commit();
    if (none) continue;

    const int c = u % nch;
    const unsigned char* buf = bufs + (u & 1) * L::BUF;
    if (c == 0) sc.zero();
    sc.template chunk<L::W, L::LD>(
        reinterpret_cast<const T*>(buf), reinterpret_cast<const T*>(buf + L::O_OFF),
        reinterpret_cast<const T*>(buf + L::K_OFF), reinterpret_cast<const T*>(buf + L::V_OFF),
        rw, kw, p.scale, lane);
    if (c < nch - 1) continue;

    // The (b, h)'s last chunk: acc += P∘(dP − δ), P = exp(S + bias − LSE).
    // Element (j, e): row e < 2 ? row0 : row1, key c_lo + 8j + 2tq + (e & 1).
    const float* sL = reinterpret_cast<const float*>(buf + L::L_OFF);
    const float* sD = reinterpret_cast<const float*>(buf + L::D_OFF);
    const float lse[2] = {sL[rw + g], sL[rw + g + 8]};
    const float dlt[2] = {sD[rw + g], sD[rw + g + 8]};
#pragma unroll
    for (int j = 0; j < NB / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 bv =
            *reinterpret_cast<const float2*>(sB + (rw + g + 8 * r) * L::BLD + kw + 8 * j + 2 * tq);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 2 * r + i, key = c_lo + 8 * j + 2 * tq + i;
          if (all || key_visible(r ? row1 : row0, key, p.Sq, p.Sk, p.left, p.right)) {
            const float x = __fadd_rn(sc.s[j][e], i ? bv.y : bv.x);
            acc[j][e] = fmaf(expf(x - lse[r]), sc.dp[j][e] - dlt[r], acc[j][e]);
          }
        }
      }
  }

  const bool pairs = p.Sk % 2 == 0;  // two neighbouring keys 8-byte aligned
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
      const int key = c_lo + 8 * j + 2 * tq;
      float* o = out + (long long)row * p.Sk + key;
      if (pairs && key + 1 < p.Sk) {
        *reinterpret_cast<float2*>(o) = make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
      } else {
        if (key < p.Sk) o[0] = acc[j][2 * r];
        if (key + 1 < p.Sk) o[1] = acc[j][2 * r + 1];
      }
    }
  }
}

template <class M>
cudaError_t launch_tc(const DbiasParams& p, cudaStream_t stream) {
  using L = DbiasTile<M>;
  cudaError_t err = cudaFuncSetAttribute(dbias_tc_kernel<M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  // Rows by 16-byte cp.async when every row of q, k, v and dO starts
  // 16-byte aligned.
  const int vec = p.D % (16 / L::E) == 0 && aligned({p.q, p.k, p.v, p.dout}, 16);
  const dim3 grid((p.Sk + L::KT - 1) / L::KT, (p.Sq + L::QT - 1) / L::QT, p.Bb * p.Hb);
  dbias_tc_kernel<M><<<grid, L::NTHR, L::SMEM, stream>>>(p, vec);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. q/dout (B, Hq, Sq, D) and k/v
// (B, Hkv, Sk, D) contiguous in in_dtype, any D >= 1; lse, delta (B, Hq, Sq)
// float32; bias float32 with element strides, 0 along the dimensions
// dbias sums over; dbias float32 (Bb, Hb, Sq, Sk) contiguous, Bb in {1, B},
// Hb in {1, Hq}. Returns the cudaError_t of the launch.
extern "C" int umfa_flash_dbias(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, const void* bias,
                                void* dbias, int B, int Hq, int Hkv, int Sq, int Sk, int D,
                                int Bb, int Hb, long long bsb, long long bsh, long long bsq,
                                long long bsk, float scale, int left, int right, int in_dtype,
                                void* stream) {
  if (in_dtype < 0 || in_dtype > 1 || D < 1 || Hkv < 1 || Hq % Hkv != 0 ||
      !(Bb == 1 || Bb == B) || !(Hb == 1 || Hb == Hq) || bias == nullptr ||
      (Bb < B && bsb != 0) || (Hb < Hq && bsh != 0))
    return cudaErrorInvalidValue;
  const DbiasParams p{q,  k,  v,  dout, static_cast<const float*>(lse),
                      static_cast<const float*>(delta), static_cast<const float*>(bias),
                      static_cast<float*>(dbias), B, Hq, Hkv, Sq, Sk, D, Bb, Hb,
                      bsb, bsh, bsq, bsk, scale, left, right};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return in_dtype == 1 ? launch_tc<Bf16Mma>(p, st) : launch_tc<Tf32x3Mma>(p, st);
}

// Dynamic shared memory of the kernel for head dim D on bf16 (bf16 = 1) or
// fp32 inputs, in bytes (0 if it does not take D).
extern "C" int umfa_flash_dbias_smem_bytes(int D, int bf16) {
  if (D < 1) return 0;
  return bf16 ? DbiasTile<Bf16Mma>::SMEM : DbiasTile<Tf32x3Mma>::SMEM;
}
