// Flash-decode over the INT8 KV cache, for Hopper, sm_90a.
//
// Replaces umfa_tpu/serving/decode_kernel.py:38 `_decode_kernel` (host
// `quantized_flash_decode`, decode_kernel.py:118): attention of a few new
// queries per sequence (Tq <= 16, GQA group folded into g·Tq query rows)
// against the whole (B, Hkv, S_max, D) int8 cache with per-row fp32 scales
// and an additive length (+ causal) bias.
//
// What bounds it on this card: bytes. Each cache row is D int8 of K and of
// V plus two fp32 scales, against 2·g·Tq·D multiply-adds per row for QKᵀ
// and as many for P·V; at the serving geometry (B8 Hkv8 S4096 D64, Tq 1,
// g 2) one call reads ~35.8 MB, ~10.7 us of HBM time, and does ~0.13
// Gflop.
//
// What this design does about it (flash-decoding): one (batch, kv-head)
// pair would give only B·Hkv = 64 blocks for 132 SMs, so the KV axis is
// split into chunks of 16 KiB of K (256 rows at D <= 64, 128 at D <= 128,
// 64 at D <= 256), one block of 128 threads each: 1024 blocks at the
// serving geometry. A block puts every byte it needs in flight at once by
// cp.async (its K and V rows, 16 bytes a copy, coalesced, where rows are
// 16-byte aligned; else 4 bytes a copy, or byte loads for a D that is not a
// multiple of 4; their scales; its bias rows), then computes out of shared
// memory, each row padded to the template's width DP: scores with DP/16
// lanes per cache row, each lane widening its 16 codes once for four rows
// and reducing by shuffles; the chunk's softmax one warp per query row;
// P·V one thread per output column (two at D > 128, in turn). int8 widens
// to fp32 exactly by a byte permutation into the mantissa of 2^23 (not the
// quarter-rate I2F). Each block writes its
// (m, l, acc) over its chunk; a second launch (`flash_decode_merge`)
// combines the chunks: M = max m_i, out = Σ e^(m_i-M) acc_i /
// Σ e^(m_i-M) l_i. SIMT FP32 FMAs throughout; query rows beyond 32 run in
// further blocks (each reads its chunk again). Not done yet: a block loads
// its whole chunk before it computes (no multi-stage pipeline), which
// leaves HBM idle between a block's load and its successor's; tensor-core
// products for large g·Tq.
//
// Arithmetic held to the reference (decode_kernel.py:56-115) and to the
// plain version's tile walk: s = (q · widen(k8)) with fp32 sums, then
// s·(ks·scale) + bias with ks·scale formed first, products and sums rounded
// separately (never contracted); m starts at -1e30; p = exp(s - m),
// l sums the fp32 p; P·V uses cdt(p·vs) (the V scale folded into P before
// the rounding to bf16 for bf16 q, none for fp32 q) and the widened V;
// out = acc / l, l = 0 replaced by 1. A chunk whose every column carries
// the -1e30 bias (a slot of length 0) averages V uniformly, as the
// reference does. The one difference: for bf16 q, cdt(p·vs) is rounded
// against the chunk's own maximum instead of the tile walk's running one,
// so the kernel meets its plain version by tolerance (bf16 relerr 1e-2),
// not bit for bit; fp32 agrees to rounding order.
#include "common.cuh"

using namespace umfa;

namespace {

constexpr int FD_NT = 128;       // threads per block
constexpr int FD_RB = 32;        // query rows per block
constexpr int FD_TQ = 16;        // most query positions (Tq) per call
constexpr int FD_BYTES = 16384;  // int8 K bytes per block (and as many of V)

struct DParams {
  const void* q;     // (B, Hkv, R, D) fp32 or bf16, R = g·Tq rows (g, t)
  const int8_t* k;   // (B, Hkv, S, D)
  const float* ks;   // (B, Hkv, S)
  const int8_t* v;
  const float* vs;
  const float* bias;  // element (b, t, j) at b*bsb + t*bst + j*bss
  float* part_o;      // (B, Hkv, R, nsplit, D) unnormalized acc per chunk
  float* part_m;      // (B, Hkv, R, nsplit)
  float* part_l;
  int B, Hkv, R, Tq, S, D;
  long long bsb, bst, bss;
  float scale;
  int q_bf16;
  int nsplit;
  int copy;  // how cache rows are copied: 2 by 16 bytes, 1 by 4, 0 by bytes
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// int8 codes widened to fp32 exactly without the (quarter-rate) I2F
// conversion: code + 128 placed in the low mantissa byte of 2^23 is the
// float 2^23 + 128 + code, and one subtraction leaves the code.
constexpr float CODE_BIAS = 8388736.f;  // 2^23 + 128

__device__ __forceinline__ float widen_byte(unsigned byte) {
  return __int_as_float((byte ^ 0x80u) | 0x4B000000u) - CODE_BIAS;
}

// The 16 codes of one 16-byte chunk of a row.
__device__ __forceinline__ void widen16(const int4 kv, float (&kf)[16]) {
  const unsigned w[4] = {(unsigned)kv.x ^ 0x80808080u, (unsigned)kv.y ^ 0x80808080u,
                         (unsigned)kv.z ^ 0x80808080u, (unsigned)kv.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      kf[4 * i + e] = __int_as_float(__byte_perm(w[i], 0x4B000000u, 0x7440u + e)) - CODE_BIAS;
}

template <int DP>
__host__ __device__ constexpr int keys_per_block() { return FD_BYTES / DP; }

// The template width (a cache row's bytes in shared memory) of head dim D.
constexpr int padded_dim(int D) { return D <= 64 ? 64 : D <= 128 ? 128 : 256; }

template <int DP>
int smem_bytes(int tq, int rstride) {
  constexpr int KEYS = keys_per_block<DP>();
  return 2 * KEYS * DP + (2 + tq) * KEYS * (int)sizeof(float) +
         rstride * (DP + KEYS) * (int)sizeof(float);
}

// RPT: query rows per thread in P·V, the least power of two that covers the
// block's rows (a template parameter, so the accumulators stay in registers
// without guarding 16 or 32 of them for Tq = 1). At most 128 registers a
// thread; 255 for 32 rows at DP 256, whose 78 KB of shared memory leave two
// blocks an SM anyway (at 128 its P·V spilled).
template <int DP, int RPT>
__global__ void __launch_bounds__(FD_NT, DP > 128 && RPT > 16 ? 2 : 4)
    flash_decode_kernel(const DParams p) {
  constexpr int KEYS = keys_per_block<DP>();  // cache rows per block: 256, 128 or 64
  constexpr int LPK = DP / 16;                // lanes per row (16 bytes each): 4, 8 or 16
  constexpr int KPP = FD_NT / LPK;            // rows per pass of the block: 32, 16 or 8
  constexpr int NPASS = KEYS / KPP;           // 8
  constexpr int NG = DP < FD_NT ? FD_NT / DP : 1;  // P·V thread groups: 2 or 1
  constexpr int NC = DP > FD_NT ? DP / FD_NT : 1;  // P·V columns a thread: 1 or 2

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x;
  const int nrc = (p.R + FD_RB - 1) / FD_RB;
  const int hk = blockIdx.y / nrc, rc = blockIdx.y - hk * nrc;
  const int b = blockIdx.z;
  const int r0 = rc * FD_RB;
  const int rows = min(FD_RB, p.R - r0);
  const int rstride = min(FD_RB, p.R);
  const int k0 = split * KEYS;
  const int n = min(KEYS, p.S - k0);

  extern __shared__ float4 smem4[];
  int8_t* sK = reinterpret_cast<int8_t*>(smem4);          // KEYS x DP int8
  int8_t* sV = sK + KEYS * DP;                            // KEYS x DP int8
  float* sKs = reinterpret_cast<float*>(sV + KEYS * DP);  // KEYS
  float* sVs = sKs + KEYS;                                // KEYS
  float* sB = sVs + KEYS;                                 // Tq x KEYS bias rows
  float* sQ = sB + p.Tq * KEYS;                           // rstride x DP
  float* sS = sQ + rstride * DP;                          // rstride x KEYS: s, then cdt(p·vs)

  const long long bh = (long long)b * p.Hkv + hk;
  const int8_t* kg = p.k + (bh * p.S + k0) * p.D;
  const int8_t* vg = p.v + (bh * p.S + k0) * p.D;
  const float* ksg = p.ks + bh * p.S + k0;
  const float* vsg = p.vs + bh * p.S + k0;
  const float* bg = p.bias + b * p.bsb + (long long)k0 * p.bss;

  // Every byte the block needs is in flight at once: K and V rows (16 bytes
  // a copy, consecutive threads on consecutive chunks; 4 bytes, or byte
  // loads, where rows are not 16-byte aligned), their scales and the bias
  // rows, all by cp.async. Rows past n and columns past D stay unwritten:
  // int8 is finite whatever it holds, their scores are never stored, their
  // P is 0 and their columns of q are 0.
  if (p.copy == 2) {
    const int cpr = p.D / 16;  // 16-byte chunks per cache row
    for (int e = tid; e < KEYS * LPK; e += FD_NT) {
      const int j = e / LPK, c = e - j * LPK;
      if (j < n && c < cpr) {
        cp_async16(sK + j * DP + c * 16, kg + (long long)j * p.D + c * 16);
        cp_async16(sV + j * DP + c * 16, vg + (long long)j * p.D + c * 16);
      }
    }
  } else if (p.copy == 1) {
    constexpr int WPK = DP / 4;  // 4-byte words of a padded row
    const int wpr = p.D / 4;
    for (int e = tid; e < KEYS * WPK; e += FD_NT) {
      const int j = e / WPK, c = e - j * WPK;
      if (j < n && c < wpr) {
        cp_async4(sK + j * DP + c * 4, kg + (long long)j * p.D + c * 4);
        cp_async4(sV + j * DP + c * 4, vg + (long long)j * p.D + c * 4);
      }
    }
  } else {
    for (int e = tid; e < KEYS * DP; e += FD_NT) {
      const int j = e / DP, c = e - j * DP;
      if (j < n && c < p.D) {
        sK[j * DP + c] = kg[(long long)j * p.D + c];
        sV[j * DP + c] = vg[(long long)j * p.D + c];
      }
    }
  }
  for (int j = tid; j < n; j += FD_NT) {
    cp_async4(sKs + j, ksg + j);
    cp_async4(sVs + j, vsg + j);
  }
  for (int t = 0; t < p.Tq; ++t)
    for (int j = tid; j < n; j += FD_NT) cp_async4(sB + t * KEYS + j, bg + t * p.bst + j * p.bss);

  // Query rows as fp32 (bf16 values widen exactly); columns past D are 0.
  const long long qrow0 = bh * p.R + r0;
  for (int e = tid; e < rows * DP; e += FD_NT) {
    const int r = e / DP, c = e - r * DP;
    float x = 0.f;
    if (c < p.D) {
      const long long i = (qrow0 + r) * p.D + c;
      x = p.q_bf16 ? Elem<__nv_bfloat16>::load(static_cast<const __nv_bfloat16*>(p.q), i)
                   : Elem<float>::load(static_cast<const float*>(p.q), i);
    }
    sQ[r * DP + c] = x;
  }
  cp_async_wait_all();
  __syncthreads();

  // Scores: s = (q · k) * (ks·scale) + bias, one row of sS per query row.
  // Lane (kr, kc) widens bytes 16·kc.. of KG cache rows (i·KPP + kr) once
  // and dots them with each query row's chunk, read once for the KG rows;
  // each cache row's lanes then reduce by shuffles.
  constexpr int KG = 4;
  const int kc = tid % LPK, kr = tid / LPK;
  for (int i0 = 0; i0 < NPASS; i0 += KG) {
    float kf[KG][16], kscale[KG];
#pragma unroll
    for (int u = 0; u < KG; ++u) {
      const int j = (i0 + u) * KPP + kr;
      widen16(*reinterpret_cast<const int4*>(sK + j * DP + kc * 16), kf[u]);
      kscale[u] = __fmul_rn(sKs[j], p.scale);
    }
    int t = r0 % p.Tq;
    for (int r = 0; r < rows; ++r) {
      const float4* qr = reinterpret_cast<const float4*>(sQ + r * DP + kc * 16);
      float s[KG];
#pragma unroll
      for (int u = 0; u < KG; ++u) s[u] = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 x = qr[e];
#pragma unroll
        for (int u = 0; u < KG; ++u) {
          s[u] = fmaf(x.x, kf[u][4 * e], s[u]);
          s[u] = fmaf(x.y, kf[u][4 * e + 1], s[u]);
          s[u] = fmaf(x.z, kf[u][4 * e + 2], s[u]);
          s[u] = fmaf(x.w, kf[u][4 * e + 3], s[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < KG; ++u) {
#pragma unroll
        for (int o = 1; o < LPK; o <<= 1) s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
        const int j = (i0 + u) * KPP + kr;
        if (kc == 0 && j < n)
          sS[r * KEYS + j] = __fadd_rn(__fmul_rn(s[u], kscale[u]), sB[t * KEYS + j]);
      }
      t = t + 1 == p.Tq ? 0 : t + 1;
    }
  }
  __syncthreads();

  // Softmax statistics of the chunk, one warp per query row; sS becomes
  // cdt(p·vs), zero past n.
  const long long prow0 = qrow0 * p.nsplit + split;
  for (int r = warp; r < rows; r += FD_NT / 32) {
    float* srow = sS + r * KEYS;
    float mx = MASK_VALUE;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, srow[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float l = 0.f;
    for (int j = lane; j < KEYS; j += 32) {
      float pv = 0.f;
      if (j < n) {
        const float pj = expf(srow[j] - mx);
        l += pj;
        pv = __fmul_rn(pj, sVs[j]);
        if (p.q_bf16) pv = round_bf16(pv);
      }
      srow[j] = pv;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) {
      p.part_m[prow0 + (long long)r * p.nsplit] = mx;
      p.part_l[prow0 + (long long)r * p.nsplit] = l;
    }
  }
  __syncthreads();

  // acc[r][col] = Σ_j cdt(p·vs)[r][j] · v[j][col], four rows of V a step;
  // at D > 128 each thread takes columns tid and tid + 128 in turn.
  const int grp = tid / (DP / NC);
  for (int cp = 0; cp < NC; ++cp) {
    const int col = tid % (DP / NC) + cp * (DP / NC);
    if (col >= p.D) return;
    const unsigned char* vcol = reinterpret_cast<const unsigned char*>(sV) + col;
    float acc[RPT], acc2[RPT];  // two chains a row: even and odd cache rows
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = acc2[i] = 0.f;
    for (int j = 0; j < n; j += 4) {
      const float v0 = widen_byte(vcol[j * DP]), v1 = widen_byte(vcol[(j + 1) * DP]);
      const float v2 = widen_byte(vcol[(j + 2) * DP]), v3 = widen_byte(vcol[(j + 3) * DP]);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = grp + NG * i;
        if (r < rows) {
          const float4 pp = *reinterpret_cast<const float4*>(sS + r * KEYS + j);
          acc[i] = fmaf(pp.x, v0, acc[i]);
          acc2[i] = fmaf(pp.y, v1, acc2[i]);
          acc[i] = fmaf(pp.z, v2, acc[i]);
          acc2[i] = fmaf(pp.w, v3, acc2[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = grp + NG * i;
      if (r < rows) p.part_o[(prow0 + (long long)r * p.nsplit) * p.D + col] = acc[i] + acc2[i];
    }
  }
}

// out[row][col] = Σ_i e^(m_i - M) acc_i[col] / Σ_i e^(m_i - M) l_i over the
// chunks i of one query row, M = max_i m_i; l = 0 is replaced by 1. The
// loops are unrolled so that a thread's loads are in flight together.
__global__ void __launch_bounds__(FD_NT)
    flash_decode_merge_kernel(const float* __restrict__ part_o, const float* __restrict__ part_m,
                              const float* __restrict__ part_l, float* __restrict__ out,
                              long long rows, int nsplit, int D) {
  const long long e = (long long)blockIdx.x * FD_NT + threadIdx.x;
  if (e >= rows * D) return;
  const long long row = e / D;
  const int col = (int)(e - row * D);
  const float* m = part_m + row * nsplit;
  const float* l = part_l + row * nsplit;
  const float* o = part_o + row * nsplit * D + col;
  float mx = MASK_VALUE;
#pragma unroll 16
  for (int i = 0; i < nsplit; ++i) mx = fmaxf(mx, m[i]);
  float lsum = 0.f, acc = 0.f;
#pragma unroll 16
  for (int i = 0; i < nsplit; ++i) {
    const float w = expf(m[i] - mx);
    lsum = fmaf(w, l[i], lsum);
    acc = fmaf(w, o[(long long)i * D], acc);
  }
  out[e] = acc / (lsum == 0.f ? 1.f : lsum);
}

template <int DP, int RPT>
cudaError_t launch_rpt(const DParams& p, cudaStream_t stream) {
  const int smem = smem_bytes<DP>(p.Tq, min(p.R, FD_RB));
  cudaError_t err = cudaFuncSetAttribute(flash_decode_kernel<DP, RPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nrc = (p.R + FD_RB - 1) / FD_RB;
  const dim3 grid(p.nsplit, p.Hkv * nrc, p.B);
  flash_decode_kernel<DP, RPT><<<grid, FD_NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch(const DParams& p, cudaStream_t stream) {
  constexpr int NG = DP < FD_NT ? FD_NT / DP : 1;
  const int per_thread = (min(p.R, FD_RB) + NG - 1) / NG;
  if (per_thread <= 1) return launch_rpt<DP, 1>(p, stream);
  if (per_thread <= 2) return launch_rpt<DP, 2>(p, stream);
  if (per_thread <= 4) return launch_rpt<DP, 4>(p, stream);
  if (per_thread <= 8) return launch_rpt<DP, 8>(p, stream);
  if (per_thread <= 16) return launch_rpt<DP, 16>(p, stream);
  return launch_rpt<DP, FD_RB / NG>(p, stream);  // 32 rows, D > 64 only
}

}  // namespace

// q (B, Hkv, R, D) contiguous, q_bf16 0 = float32, 1 = bfloat16; k/v
// (B, Hkv, S, D) contiguous int8, D <= 256;
// ks/vs (B, Hkv, S) float32; bias float32 read at b*bsb + t*bst + j*bss
// (t = row % Tq); part_o (B, Hkv, R, nsplit, D), part_m and part_l
// (B, Hkv, R, nsplit) float32, nsplit = ceil(S / rows per block). Returns
// the cudaError_t of the launch.
extern "C" int umfa_flash_decode(const void* q, const void* k, const void* ks, const void* v,
                                 const void* vs, const void* bias, void* part_o, void* part_m,
                                 void* part_l, int B, int Hkv, int R, int Tq, int S, int D,
                                 long long bsb, long long bst, long long bss, float scale,
                                 int q_bf16, int nsplit, void* stream) {
  const int keys = FD_BYTES / padded_dim(D);
  if (D < 1 || D > 256 || B < 1 || Hkv < 1 || R < 1 || Tq < 1 || Tq > FD_TQ || R % Tq != 0 ||
      S < 1 || q_bf16 < 0 || q_bf16 > 1 || nsplit != (S + keys - 1) / keys)
    return cudaErrorInvalidValue;
  const uintptr_t kv = reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  const int copy = D % 16 == 0 && kv % 16 == 0 ? 2 : D % 4 == 0 && kv % 4 == 0 ? 1 : 0;
  const DParams p{q,
                  static_cast<const int8_t*>(k),
                  static_cast<const float*>(ks),
                  static_cast<const int8_t*>(v),
                  static_cast<const float*>(vs),
                  static_cast<const float*>(bias),
                  static_cast<float*>(part_o),
                  static_cast<float*>(part_m),
                  static_cast<float*>(part_l),
                  B, Hkv, R, Tq, S, D,
                  bsb, bst, bss,
                  scale, q_bf16, nsplit, copy};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D <= 64 ? launch<64>(p, st) : D <= 128 ? launch<128>(p, st) : launch<256>(p, st);
}

// out (rows, D) float32 from the chunk partials of umfa_flash_decode
// (rows = B * Hkv * R). Returns the cudaError_t of the launch.
extern "C" int umfa_flash_decode_merge(const void* part_o, const void* part_m,
                                       const void* part_l, void* out, int rows, int nsplit,
                                       int D, void* stream) {
  if (rows < 1 || nsplit < 1 || D < 1) return cudaErrorInvalidValue;
  const long long n = (long long)rows * D;
  const unsigned blocks = (unsigned)((n + FD_NT - 1) / FD_NT);
  flash_decode_merge_kernel<<<blocks, FD_NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_m),
      static_cast<const float*>(part_l), static_cast<float*>(out), rows, nsplit, D);
  return cudaGetLastError();
}
