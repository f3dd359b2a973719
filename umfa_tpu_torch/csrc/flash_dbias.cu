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
// line. Beyond HBM, the operands every output tile reads again for each
// summed (b, h) (Q, dO, K, V, from L2) are what a kernel has to keep down.
//
// What this design does about it:
//   * bf16 inputs: `dbias_tc_kernel`, mma.sync m16n8k16 bf16 -> fp32 with
//     the fragment code of bwd_tc.cuh. One block of 8 warps owns a 64-query
//     x 128-key output tile of one (bias batch, bias head), each warp 16
//     queries x 64 keys, and keeps the fp32 dS sum in registers across the
//     summed (b, h), walked in a fixed order (one owner, no atomics:
//     deterministic). The bias tile does not change along the summed
//     dimensions, so it is copied into shared memory once per block
//     instead of read from L2 at every step. Each (b, h) arrives as
//     32-column chunks of Q, dO, K and V copied by cp.async straight into
//     padded tiles (LSE and δ with the last chunk), one chunk ahead into
//     the other of two buffers, one barrier a chunk: 97,280 bytes of
//     shared memory at every head dim up to 256, two blocks an SM.
//     bf16(q·scale) (flash_bwd.py:52) is formed on the A fragments in
//     registers, so nothing is converted in shared memory. The sums are
//     stored from the fragments, two fp32 a thread (32-byte runs). Against
//     it at the training shape, on one card: 64-column chunks (one block an
//     SM, or spills at two), three or four buffers (one block an SM) and
//     16-column chunks were slower; a 128 x 128 tile of 16 warps was no
//     faster at D 64.
//   * fp32 inputs (fp16 arrives as fp32): `flash_dbias_kernel`, FP32 FMAs on
//     the CUDA cores, one block of 256 threads per 64 x 64 tile staging four
//     fp32 tiles per summed (b, h) (66-132 KB), each thread a 4 x 4 patch;
//     TF32 would miss the fp32 gate of 1e-4. Head dims up to 128: at 256
//     its tiles would need 263,168 bytes.
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

// ---- fp32 inputs: CUDA cores ------------------------------------------------

template <int DP>
constexpr int simt_smem_bytes() {
  return 4 * 64 * (DP + 1) * (int)sizeof(float);
}

template <int DP>
__global__ void __launch_bounds__(NTB) flash_dbias_kernel(const DbiasParams p) {
  constexpr int S = DP + 1;
  extern __shared__ float smem[];
  float* sQ = smem;         // q · scale
  float* sO = sQ + BQ * S;  // dO
  float* sK = sO + BQ * S;
  float* sV = sK + BK * S;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * BK, q0 = blockIdx.y * BQ;
  const int bb = blockIdx.z / p.Hb, bh = blockIdx.z - bb * p.Hb;
  const int group = p.Hq / p.Hkv;

  int k_lo, k_hi;
  visible_keys(q0, min(q0 + BQ, p.Sq) - 1, p.Sk, p.left, p.right, &k_lo, &k_hi);
  const bool visible = k_lo <= k_hi && k0 <= k_hi && k0 + BK - 1 >= k_lo;

  float acc[4][4] = {};
  const int nb = p.Bb == 1 ? p.B : 1;
  const int nh = p.Hb == 1 ? p.Hq : 1;
  for (int n = 0; visible && n < nb * nh; ++n) {
    const int b = p.Bb == 1 ? n / nh : bb;
    const int h = p.Hb == 1 ? n % nh : bh;
    const long long qrow = ((long long)b * p.Hq + h) * p.Sq;
    const long long krow = ((long long)b * p.Hkv + h / group) * p.Sk;
    __syncthreads();  // the previous step's tiles consumed
    stage_rows<float, DP, true>(sQ, static_cast<const float*>(p.q) + qrow * p.D, q0, p.Sq, p.D,
                                p.scale);
    stage_rows<float, DP>(sO, static_cast<const float*>(p.dout) + qrow * p.D, q0, p.Sq, p.D);
    stage_rows<float, DP>(sK, static_cast<const float*>(p.k) + krow * p.D, k0, p.Sk, p.D);
    stage_rows<float, DP>(sV, static_cast<const float*>(p.v) + krow * p.D, k0, p.Sk, p.D);
    float lse[4], dlt[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      lse[i] = row < p.Sq ? p.lse[qrow + row] : 0.f;
      dlt[i] = row < p.Sq ? p.delta[qrow + row] : 0.f;
    }
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    patch_abt<DP>(s, sQ, sK, ty, tx);
    patch_abt<DP>(dp, sO, sV, ty, tx);
    const float* bias = p.bias + b * p.bsb + h * p.bsh;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        if (key_visible(row, col, p.Sq, p.Sk, p.left, p.right)) {
          const float pr = expf(s[i][j] + bias[row * p.bsq + col * p.bsk] - lse[i]);
          acc[i][j] += pr * (dp[i][j] - dlt[i]);
        }
      }
    }
  }

  float* out = p.dbias + ((long long)bb * p.Hb + bh) * p.Sq * p.Sk;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      if (col < p.Sk) out[(long long)row * p.Sk + col] = acc[i][j];
    }
  }
}

// ---- bf16 inputs: tensor cores ----------------------------------------------

struct DbiasTile {
  static constexpr int QT = 64, KT = 128;  // the output tile
  static constexpr int W = 32;             // columns of a chunk
  static constexpr int LD = W + 8;         // bf16 row stride in shared memory
  // Warp w owns rows 16(w % RW)..+15 and keys 64(w / RW)..+63 of the tile.
  static constexpr int RW = QT / 16;
  static constexpr int NTHR = 32 * RW * (KT / 64);
  // The bias tile (fp32, row stride BLD: float2 reads free of bank conflicts).
  static constexpr int BLD = KT + 8;
  static constexpr int BIAS = QT * BLD * 4;
  // A chunk's buffer: Q, dO (QT x LD), K, V (KT x LD), LSE, δ (QT).
  static constexpr int O_OFF = QT * LD * 2;
  static constexpr int K_OFF = 2 * QT * LD * 2;
  static constexpr int V_OFF = K_OFF + KT * LD * 2;
  static constexpr int L_OFF = V_OFF + KT * LD * 2;
  static constexpr int D_OFF = L_OFF + QT * 4;
  static constexpr int BUF = D_OFF + QT * 4;
  static constexpr int SMEM = BIAS + 2 * BUF;  // two chunk buffers
};

__global__ void __launch_bounds__(DbiasTile::NTHR, 2)
    dbias_tc_kernel(const DbiasParams p, const int vec) {
  using T = DbiasTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sB = reinterpret_cast<float*>(smem_raw);
  unsigned char* bufs = smem_raw + T::BIAS;  // [2][BUF]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int k0 = blockIdx.x * T::KT, q0 = blockIdx.y * T::QT;
  const int bb = blockIdx.z / p.Hb, bh = blockIdx.z - bb * p.Hb;
  float* out = p.dbias + ((long long)bb * p.Hb + bh) * p.Sq * p.Sk;

  int k_lo, k_hi;
  visible_keys(q0, min(q0 + T::QT, p.Sq) - 1, p.Sk, p.left, p.right, &k_lo, &k_hi);
  if (k_lo > k_hi || k0 > k_hi || k0 + T::KT - 1 < k_lo) {  // hidden entirely
    for (int e = tid; e < T::QT * T::KT; e += T::NTHR) {
      const int row = q0 + e / T::KT, key = k0 + e % T::KT;
      if (row < p.Sq && key < p.Sk) out[(long long)row * p.Sk + key] = 0.f;
    }
    return;
  }

  const int group = p.Hq / p.Hkv;
  const int nh = p.Hb == 1 ? p.Hq : 1;
  const int nch = (p.D + T::W - 1) / T::W;  // column chunks of one (b, h)
  const int total = (p.Bb == 1 ? p.B : 1) * nh * nch;
  const int nq = min(T::QT, p.Sq - q0), nk = min(T::KT, p.Sk - k0);

  // Chunk u (column chunk u % nch of the (u / nch)-th summed (b, h)) into
  // buffer u & 1.
  auto issue = [&](int u) {
    const int n = u / nch, c = u - n * nch;
    const int b = p.Bb == 1 ? n / nh : bb, h = p.Hb == 1 ? n % nh : bh;
    const long long qbh = (long long)b * p.Hq + h, kbh = (long long)b * p.Hkv + h / group;
    const long long qr = (qbh * p.Sq + q0) * p.D, kr = (kbh * p.Sk + k0) * p.D;
    unsigned char* buf = bufs + (u & 1) * T::BUF;
    load_tile<T::QT, T::W, T::LD>(reinterpret_cast<__nv_bfloat16*>(buf),
                                  static_cast<const __nv_bfloat16*>(p.q) + qr, nq, p.D, c * T::W,
                                  vec);
    load_tile<T::QT, T::W, T::LD>(reinterpret_cast<__nv_bfloat16*>(buf + T::O_OFF),
                                  static_cast<const __nv_bfloat16*>(p.dout) + qr, nq, p.D,
                                  c * T::W, vec);
    load_tile<T::KT, T::W, T::LD>(reinterpret_cast<__nv_bfloat16*>(buf + T::K_OFF),
                                  static_cast<const __nv_bfloat16*>(p.k) + kr, nk, p.D, c * T::W,
                                  vec);
    load_tile<T::KT, T::W, T::LD>(reinterpret_cast<__nv_bfloat16*>(buf + T::V_OFF),
                                  static_cast<const __nv_bfloat16*>(p.v) + kr, nk, p.D, c * T::W,
                                  vec);
    if (c == nch - 1) {
      load_rows_f32<T::QT>(reinterpret_cast<float*>(buf + T::L_OFF), p.lse + qbh * p.Sq + q0, nq);
      load_rows_f32<T::QT>(reinterpret_cast<float*>(buf + T::D_OFF), p.delta + qbh * p.Sq + q0,
                           nq);
    }
  };

  // The bias tile, once: it does not change along the summed dimensions
  // (their strides are 0), so every step reads it from shared memory.
  const float* bias = p.bias + bb * p.bsb + bh * p.bsh;
  for (int e = tid; e < T::QT * T::KT; e += T::NTHR) {
    const int r = e / T::KT, c = e - r * T::KT;
    const bool live = r < nq && c < nk;
    cp_async4(sB + r * T::BLD + c, live ? bias + (q0 + r) * p.bsq + (k0 + c) * p.bsk : bias,
              live ? 4 : 0);
  }
  issue(0);
  cp_async_commit();

  // This warp's rows [r_lo, r_lo + 15] against keys [c_lo, c_lo + 63].
  const int rw = (warp % T::RW) * 16, r_lo = q0 + rw, r_hi = r_lo + 15;
  const int kw = (warp / T::RW) * 64, c_lo = k0 + kw, c_hi = c_lo + 63;
  const int row0 = r_lo + g, row1 = row0 + 8;  // this thread's two rows
  const bool none = r_lo >= p.Sq || c_lo >= p.Sk || (p.right >= 0 && c_lo > r_hi + p.right) ||
                    (p.left >= 0 && c_hi < r_lo - p.left);
  const bool all = r_hi < p.Sq && c_hi < p.Sk && (p.right < 0 || c_hi <= r_lo + p.right) &&
                   (p.left < 0 || c_lo >= r_hi - p.left);

  float acc[8][4], s[8][4], dp[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = s[j][e] = dp[j][e] = 0.f;

  for (int u = 0; u < total; ++u) {
    cp_async_wait<0>();
    __syncthreads();  // chunk u (and the bias tile) landed, chunk u - 1 consumed
    if (u + 1 < total) issue(u + 1);
    cp_async_commit();
    if (none) continue;

    const int c = u % nch;
    const unsigned char* buf = bufs + (u & 1) * T::BUF;
    const __nv_bfloat16* sQ = reinterpret_cast<const __nv_bfloat16*>(buf);
    const __nv_bfloat16* sO = reinterpret_cast<const __nv_bfloat16*>(buf + T::O_OFF);
    const __nv_bfloat16* sK = reinterpret_cast<const __nv_bfloat16*>(buf + T::K_OFF);
    const __nv_bfloat16* sV = reinterpret_cast<const __nv_bfloat16*>(buf + T::V_OFF);
    if (c == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < T::W / 16; ++ks) {
      uint32_t aq[4], ao[4];
      load_a(aq, sQ, T::LD, rw, ks * 16, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) aq[i] = scale_bf16x2(aq[i], p.scale);
      load_a(ao, sO, T::LD, rw, ks * 16, lane);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t b0[2], b1[2];
        load_b_nk(b0, b1, sK, T::LD, kw + jj * 16, ks * 16, lane);
        mma_bf16(s[2 * jj], aq, b0);
        mma_bf16(s[2 * jj + 1], aq, b1);
        load_b_nk(b0, b1, sV, T::LD, kw + jj * 16, ks * 16, lane);
        mma_bf16(dp[2 * jj], ao, b0);
        mma_bf16(dp[2 * jj + 1], ao, b1);
      }
    }
    if (c < nch - 1) continue;

    // The (b, h)'s last chunk: acc += P∘(dP − δ), P = exp(S + bias − LSE).
    // Element (j, e): row e < 2 ? row0 : row1, key c_lo + 8j + 2tq + (e & 1).
    const float* sL = reinterpret_cast<const float*>(buf + T::L_OFF);
    const float* sD = reinterpret_cast<const float*>(buf + T::D_OFF);
    const float lse[2] = {sL[rw + g], sL[rw + g + 8]};
    const float dlt[2] = {sD[rw + g], sD[rw + g + 8]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 bv =
            *reinterpret_cast<const float2*>(sB + (rw + g + 8 * r) * T::BLD + kw + 8 * j + 2 * tq);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 2 * r + i, key = c_lo + 8 * j + 2 * tq + i;
          if (all || key_visible(r ? row1 : row0, key, p.Sq, p.Sk, p.left, p.right)) {
            const float x = __fadd_rn(s[j][e], i ? bv.y : bv.x);
            acc[j][e] = fmaf(expf(x - lse[r]), dp[j][e] - dlt[r], acc[j][e]);
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
    for (int j = 0; j < 8; ++j) {
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

cudaError_t launch_tc(const DbiasParams& p, cudaStream_t stream) {
  using T = DbiasTile;
  cudaError_t err = cudaFuncSetAttribute(dbias_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  // Rows by 16-byte cp.async when every row of q, k, v and dO starts
  // 16-byte aligned.
  const int vec = p.D % 8 == 0 && aligned({p.q, p.k, p.v, p.dout}, 16);
  const dim3 grid((p.Sk + T::KT - 1) / T::KT, (p.Sq + T::QT - 1) / T::QT, p.Bb * p.Hb);
  dbias_tc_kernel<<<grid, T::NTHR, T::SMEM, stream>>>(p, vec);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_simt(const DbiasParams& p, cudaStream_t stream) {
  constexpr int smem = simt_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_dbias_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sk + BK - 1) / BK, (p.Sq + BQ - 1) / BQ, p.Bb * p.Hb);
  flash_dbias_kernel<DP><<<grid, NTB, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. q/dout (B, Hq, Sq, D) and k/v
// (B, Hkv, Sk, D) contiguous in in_dtype, D <= 256 for bfloat16 (tensor
// cores) and <= 128 for float32 (CUDA cores); lse, delta (B, Hq, Sq)
// float32; bias float32 with element strides, 0 along the dimensions
// dbias sums over; dbias float32 (Bb, Hb, Sq, Sk) contiguous, Bb in {1, B},
// Hb in {1, Hq}. Returns the cudaError_t of the launch.
extern "C" int umfa_flash_dbias(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, const void* bias,
                                void* dbias, int B, int Hq, int Hkv, int Sq, int Sk, int D,
                                int Bb, int Hb, long long bsb, long long bsh, long long bsq,
                                long long bsk, float scale, int left, int right, int in_dtype,
                                void* stream) {
  if (in_dtype < 0 || in_dtype > 1 || D < 1 || D > (in_dtype == 1 ? 256 : 128) || Hkv < 1 ||
      Hq % Hkv != 0 || !(Bb == 1 || Bb == B) || !(Hb == 1 || Hb == Hq) || bias == nullptr ||
      (Bb < B && bsb != 0) || (Hb < Hq && bsh != 0))
    return cudaErrorInvalidValue;
  const DbiasParams p{q,  k,  v,  dout, static_cast<const float*>(lse),
                      static_cast<const float*>(delta), static_cast<const float*>(bias),
                      static_cast<float*>(dbias), B, Hq, Hkv, Sq, Sk, D, Bb, Hb,
                      bsb, bsh, bsq, bsk, scale, left, right};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == 1) return launch_tc(p, st);
  return D <= 64 ? launch_simt<64>(p, st) : launch_simt<128>(p, st);
}

// Dynamic shared memory of the tensor-core kernel (bfloat16 inputs) for
// head dim D, in bytes (0 if it does not take D).
extern "C" int umfa_flash_dbias_smem_bytes(int D) {
  return D < 1 || D > 256 ? 0 : DbiasTile::SMEM;
}
