// Single-launch runtime-quantized attention forward for Hopper, sm_90a.
//
// Replaces umfa_tpu/ops/quant_fused_attn.py:206 `_fused_qattn_kernel` (host
// `fused_quantize_attend`, quant_fused_attn.py:831): read fp32/bf16 Q, K,
// V, quantize them per row (INT8 or INT4, mean smoothing, optional Hadamard
// rotation of Q and K, or a dense Q), attend on the dequantized bf16
// values, restore the V mean, and write the quantized residuals the STE
// backward consumes. ROW or BLOCK scales, SYMMETRIC or ASYMMETRIC,
// head_dim <= 256, with or without a block-sparse map, and pv_int8 (the
// integer P·V, below).
//
// The score contract, and what bounds the kernel under it. The kernel and
// its plain version form each score as one double sum of products of bf16
// values, rounded once to fp32, so both exponentiate the same fp32 scores
// and round P to bf16 at the same points (an fp32 QKᵀ in another order
// flips bf16(P) in short causal rows, LSE ~1e-3 off against a 1e-4 gate).
// The sum is exact in any order: a bf16 product has at most 16 significant
// bits, the products of one dot span about 14 binades (codes 1..127 on each
// side, one scale per row), so a sum of <= 256 of them needs about 38 bits,
// under double's 53. BLOCK keeps one scale a row as far as a dot is
// concerned (a group's scale is one row's), so the argument stands. Under
// ASYMMETRIC an operand is bf16((code − zp)·s): the code spans 256 values
// and the zero point is not clipped, so code − zp runs over 256
// consecutive integers, which either hold 0 (nonzero magnitudes 1..255)
// or do not (magnitudes m..m + 255, m >= 1); either way the largest
// nonzero magnitude of a row is at most 256 times its smallest, 8 binades
// plus one for the bf16 rounding, so the products of a dot span at most
// ~18 binades of 16-bit significands and a sum of <= 256 of them needs
// about 16 + 18 + 8 = 42 bits, still under 53. (A dense Q has free
// exponents: there exactness rests on the data, as it did in the
// CUDA-core kernel this one replaces.) So
// QKᵀ runs on the FP64 tensor cores (mma.sync m16n8k8 f64, DMMA in the
// SASS), and their rate is the bound that matters: at the training shape
// (B8 Hq16 Hkv8, causal S 4096, D 64) two passes of QKᵀ in double,
// 2 x 1.37e11 flop, take ~4.1 ms at the datasheet's 67 TFLOP/s, against
// ~0.28 ms of bf16 tensor-core time for QKᵀ and P·V and ~0.08 ms of HBM
// time.
//
// One call runs up to five kernels on the stream:
//   1. means: the smoothing means, one block per (b, h), so every block of
//      a (b, h) reads the same bits;
//   2. K/V quantize (symmetric ROW): one warp per K or V row writes its int8 codes (INT4
//      packed) and scale, once. On the TPU the kernel quantizes each K/V
//      tile on first touch into a VMEM cache that later q-blocks reuse;
//      blocks on this card share nothing, so the rows are quantized once
//      into HBM instead. These are the K/V residuals, each row written by
//      exactly one warp; without residuals they go to scratch. The warp
//      also writes its row dequantized, K̃ = bf16(code·sk) and
//      Ṽ = bf16(code·sv), to bf16 scratch, so that the attention copies
//      tiles ready for the tensor cores instead of dequantizing every tile
//      again in every block;
//   2'. BLOCK or ASYMMETRIC: the same for Q, K and V in two passes of one
//      warp a row, since a group's statistic spans rows that other warps
//      and blocks hold (a 128-row Q group straddles the attention's
//      192-row tiles at D 64): `fused_rows_kernel` writes each row x − mean
//      as fp32 and its statistic (absmax, or hi and lo), then
//      `fused_group_quant_kernel` reduces the row's group (the
//      reference's zero-padded rows past S included: 0 − mean), quantizes
//      and writes codes, scales, zero points and the dequantized bf16 row;
//      Q's with the softmax scale folded in, so the attention reads it as
//      a dense bf16 Q (scale 1, no rotation);
//   3. with smooth_q, the cc row: cc_j = (Σ_d bf16(qm_d)·k̃_jd in double)
//      · scale depends only on (b, q head, key), so it is formed once a
//      call into a (B, Hq, Sk) fp32 scratch, with the same sequential
//      double sum, from the K̃ scratch, instead of once a key tile in every
//      block (64 serial threads and a barrier a tile); the attention reads
//      it with each key tile, like a bias row. Its bits are those of the
//      in-block sum;
//   4. attention, `fused_qattn_tc_kernel`, in the shape of row 5's
//      quant_attn_fwd_tc_kernel: one block per (query tile, q head, batch),
//      issued heaviest first, 12 warps at D 64 and 8 at D 128 and 256
//      (FCfg); each warp owns 16 whole query rows, so row maxima and sums
//      need only quad shuffles.
//      * The block quantizes its Q tile (one warp a row, absmax by
//        shuffles; the codes are the Q residual) into a padded fp32 tile
//        of the dequantized bf16 values; rotated rows come from each raw
//        row converted to double once in shared memory, four columns a
//        thread. At D 64 each warp converts its A fragments to double once
//        and keeps them in registers; at D 128 and 256 it converts them
//        from the tile at each use. At D 256 the tile is bf16 (its values
//        are bf16 already), each warp quantizing its rows from registers.
//      * The K̃ and Ṽ tiles of 64 keys (32 at D 256) and the cc row arrive
//        by cp.async in rings of three buffers, two tiles ahead (16- or
//        4-byte copies where rows and operands are aligned, element loads
//        for odd D; rows past Sk zero). At D 64 each K̃ tile is converted to double
//        once a block, a step ahead (conversions to double run at a
//        fraction of the fp32 rate, and converting every B fragment in
//        every warp held the products back); at D 128 and 256 the B
//        fragments are converted from the ring at the load. Ṽ feeds P·V
//        from the ring. A step needs one barrier. Key tiles hidden from the
//        whole block are never loaded, and a warp skips a tile its rows
//        cannot see.
//      * QKᵀ by mma_f64 into double accumulators, 16 keys at a time; each
//        score is then formed as the plain version forms it: (float) of
//        the exact double, __fadd_rn of the cc term, __fadd_rn of the
//        bias, then the index mask (causal, window, KV tail) to -1e30,
//        never contracted, so both passes compute the same bits.
//      * Two passes over the visible keys, kept on purpose: the first runs
//        QKᵀ alone for the exact row max (it copies no Ṽ), the second
//        forms P = expf(s - m) against the final max and rounds it to bf16
//        where the plain version does; a one-pass online softmax rounds
//        against a running max and misses the 1e-4 LSE gate.
//      * P·V by mma.sync m16n8k16 bf16 -> fp32: a 16-key chunk's bf16(P)
//        goes from the score registers into the A fragment (`pack_a`), V's
//        B fragments come through ldmatrix.trans.
//
// Means, as the TPU kernel estimates them (from its zero-padded first
// tile): the sum of the first min(T, S) rows over T, T from the host
// (`default_mean_rows`), the rows summed in double by 256/D row slices in a
// fixed order; km and vm per KV head, qm per query head, km and qm of the
// rotated rows. With a block-sparse map the K/V window starts at a row the
// host gives per (b, kv head), kv_row0: the first tile that the slice's
// walk fills (the reference's fill flag 2), T = the map's block_k.
//
// Block-sparse (SPARSE, a template parameter: the dense instantiations
// compile as without it): with a map, both passes walk the block's
// compacted key row (common.cuh `SparseWalk`, clipped to the band),
// counted once and run twice, its 64-key tiles (32 at D 256) from each map
// tile's first key; keys past a map tile's end are hidden like the KV
// tail, the bias is read only on tiles that are not FULL for the block,
// and a block that straddles map tiles looks up each element's own tile.
// The pre-pass kernels quantize every row, walked or not: the values of a
// walked tile are the reference's, the rest are read by nothing.
//
// Rounding points held to the reference (quant_fused_attn.py:100-828):
//   * x·H summed in double and rounded once to fp32 (V is never rotated);
//   * a row: x − mean, absmax = max(|x|, 1e-12), scale = absmax / qmax,
//     code = rint(x · (qmax / absmax)) (a reciprocal multiply, no clip);
//     BLOCK: the absmax of the row's group; ASYMMETRIC: hi and lo (of the
//     group), scale = max(hi − lo, 1e-12) / (2 qmax + 1), zp = rint(−lo /
//     scale) − (qmax + 1), code = clip(rint(x / scale) + zp, −qmax − 1,
//     qmax), exact divisions, deq = (code − zp)·scale;
//   * bf16(deq_k), bf16(deq_v), bf16(deq_q·scale), deq = code·s
//     symmetric; a dense Q is bf16(q_rot·scale) and has no mean;
//   * with smooth_q: cc_j = (bf16(qm)·k̃_j)·scale, added to S before the
//     bias; index masking (causal, window, KV tail) sets −1e30;
//   * P = exp(S − m), P·V on bf16(P); l sums bf16(P) at D < 128 and the
//     fp32 P at D ≥ 128; out = acc / l + vm, rows with l == 0 exactly 0 and
//     LSE −1e30.
// Exactness against the plain version: Q·K, the cc row and the means are
// summed in double and rounded once to fp32, as the plain version's
// float64 sums are, so both quantize and exponentiate the same fp32 values
// and round P to bf16 at the same points; only the fp32 sums of l and P·V
// run in another order (the tensor cores', in 16-key pieces), as in row 5.
// Shared memory (191,488 bytes a block at D 64, 190,720 at D 128, 204,672
// at D 256, one block an SM) is set above 48 KB through
// cudaFuncSetAttribute.
//
// pv_int8 (F_PV, the PV template parameter; quant_fused_attn.py:391-411,
// :552-601, :823-828), the reference's chunked local-max integer P·V:
//   * V is quantized by the BLOCK pre-pass with v_group = pv_chunk (one
//     symmetric scale over a chunk's rows of v − vm, rows past Sk as
//     0 − vm); at INT4 the pre-pass also writes the unpacked codes (vcode);
//   * pass 1 also keeps each row's maximum over every absolute pv_chunk of
//     keys, ml (masked lanes at −1e30 included): each tile's row maxima
//     (quad shuffles) raise its chunk's entry of a (B, Hq, Sq, Sk /
//     pv_chunk) fp32 scratch that the host sets to −1e30 (a chunk is 2 or 4
//     of the 64-key tiles, 4 or 8 of the 32-key tiles at D 256: up to 80
//     values a row at Sk 10240, more than shared memory holds beside the
//     rings; per tile, not per chunk, so no state lives across steps);
//   * pass 2 codes p̂ = rint(expf(s − (ml − ln 255.49))) in [0, 255], expf
//     (not __expf) in the plain version's order, since p̂ rounds at .5 and
//     one bit flips a code; the codes of two 16-key score chunks are the u8
//     A fragment of mma.sync m16n8k32 u8 x s8 -> s32 (IMMA) as they stand:
//     the thread holds keys {2t, 2t+1, 8+2t, 9+2t} (+16) of a 32-key step,
//     the fragment wants k = 4t..4t+3 (+16), so the V codes are staged in
//     that order of k (k = 4t + j holds key 2t + (j & 1) + 8 (j >> 1));
//   * the V code tile (int8 rows, by cp.async into the Ṽ ring's bytes) is
//     transposed a step ahead into a D-major tile of that key order by 4 x 4
//     byte transposes (__byte_perm), the B fragment then one 32-bit load:
//     sm_90 has no ldmatrix .trans for 8-bit elements;
//   * the s32 sum of a 32-key product is exact (|Σ| <= 255·127·32), and
//     converts to fp32 once: acc += Σ · (β·sv); l += Σ p̂ · β once a key
//     tile; β = expf(ml − m)
//     against the final max m (the reference: its running max); a row with
//     no visible key (m = −1e30) takes β = 0 here and gets the reference's
//     value in the epilogue (`hidden_row`): the mean of the dequantized V
//     over the lanes of the key tiles its reference query tile walks, each
//     coding 1, rows past Sk as 0 − vm quantized in their chunk's scale;
//   * out = acc / l + vm, LSE = (m + log l) − ln 255.49.
#include <math.h>

#include "common.cuh"
#include "mma.cuh"

using namespace umfa;

namespace {

enum : int {
  F_HADAMARD = 1,
  F_SMOOTH = 2,
  F_SMOOTH_Q = 4,
  F_Q_DENSE = 8,
  F_ASYM = 16,
  F_Q_INT4 = 32,
  F_K_INT4 = 64,
  F_V_INT4 = 128,
  F_PV = 256,
};

// fp32(ln 255.49): the reference's integer P·V amplitude (quant_fused_attn.py:96-97).
constexpr float LN_P_AMP = 0x1.62c384p+2f;  // 5.54318332672119140625

struct FQParams {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  void* out;
  float* lse;
  int8_t* qv;  // Q residual (null unless asked for, and for a dense Q)
  float* qs;
  int8_t* kv;  // K/V codes and scales (always: the residuals, or scratch)
  float* ks;
  int8_t* vv;
  float* vs;
  float* qm;  // (B, Hq, D), with F_SMOOTH_Q
  float* km;  // (B, Hkv, D), with F_SMOOTH
  float* vm;
  float* cc;  // (B, Hq, Sk) scratch, with F_SMOOTH_Q
  __nv_bfloat16* kb;  // (B, Hkv, Sk, D) scratch: the dequantized K̃ = bf16(deq_k)
  __nv_bfloat16* vb;  // and Ṽ = bf16(deq_v)
  int* qzp;  // ASYMMETRIC zero points, like the scales (qzp with qv only)
  int* kzp;
  int* vzp;
  float* ys;  // BLOCK/ASYMMETRIC scratch: rows x − mean (Q's, then K's, V's), fp32
  float* st;  // their statistics: hi (or absmax) at [row], lo at [rows + row]
  __nv_bfloat16* qb;  // (B, Hq, Sq, D) scratch: bf16(deq_q·scale), an integer Q
  int B, Hq, Hkv, Sq, Sk, D;
  long long bsb, bsh, bsq, bsk;
  float scale;
  int left, right;
  int flags, qmax_q, qmax_k, qmax_v, Tq, Tkv;
  int q_group, k_group, v_group;  // BLOCK rows a scale, 0 = ROW
  float hval;
  int kvmode;  // how the K̃ and Ṽ rows are copied (`copy_rows`)
  SparseMap sm;  // read only by the SPARSE instantiations: the map and fetch_kv
  const int* kv_row0;  // (B, Hkv): the first row of each K/V mean window, or null (row 0)
  // F_PV: each row's chunk maxima (B, Hq, Sq, ceil(Sk / v_group)); V's
  // unpacked codes (B, Hkv, Sk, D) (vv at INT8); the P codes (B, Hq, Sq,
  // Sk) uint8 for checks, or null; V's row statistics (absmax of v − vm)
  // in st, found by launch(); how the code rows are copied (`copy_codes`).
  float* ml;
  int8_t* vcode;
  uint8_t* pcode;
  const float* vst;
  int vcmode;
};

constexpr int NTM = 256;  // means kernel threads
constexpr int KV_WARPS = 8;  // rows per block of the K/V quantize kernel
constexpr int MAXD = 256;

// Element c of the rotated row x·H (H entries ±hval): the products summed
// in double and rounded once, as the plain version's float64 product is,
// so both quantize the same fp32 values.
template <typename Load>
__device__ __forceinline__ float rotate_elem(Load x, int c, int D, float hval) {
  double y = 0.0;
  for (int j = 0; j < D; ++j)
    y = fma((double)x(j), (__popc(j & c) & 1) ? -(double)hval : (double)hval, y);
  return (float)y;
}

// The mean of the first min(T, S) rows over T (rotated when `rot`), written
// to out[0..D). Rows are summed in double by NTM / D slices in a fixed order.
template <typename Tin>
__device__ void tile_mean(const Tin* x, int S, int T, int D, bool rot, float hval, float* out,
                          double* part) {
  const int ns = NTM / D;
  const int c = threadIdx.x % D, sl = threadIdx.x / D;
  const int n = min(T, S);
  double acc = 0.0;
  if (sl < ns) {
    for (int r = sl; r < n; r += ns) {
      const Tin* xr = x + (long long)r * D;
      const float y = rot ? rotate_elem([&](int j) { return Elem<Tin>::load(xr, j); }, c, D, hval)
                          : Elem<Tin>::load(xr, c);
      acc += (double)y;
    }
    part[sl * D + c] = acc;
  }
  __syncthreads();
  if (threadIdx.x < D) {
    double s = part[c];
    for (int i = 1; i < ns; ++i) s += part[i * D + c];
    out[c] = __fdiv_rn((float)s, (float)T);
  }
  __syncthreads();
}

template <typename Tin, bool WALK>
__global__ void __launch_bounds__(NTM) fused_means_kernel(const FQParams p) {
  __shared__ double part[NTM];
  const bool rot = p.flags & F_HADAMARD;
  const int nq = p.B * p.Hq;
  const int bh = blockIdx.x;
  if (bh < nq) {
    if (p.flags & F_SMOOTH_Q)
      tile_mean(static_cast<const Tin*>(p.q) + (long long)bh * p.Sq * p.D, p.Sq, p.Tq, p.D, rot,
                p.hval, p.qm + (long long)bh * p.D, part);
    return;
  }
  if (!(p.flags & F_SMOOTH)) return;
  const long long kb = bh - nq;
  const int r0 = WALK ? p.kv_row0[kb] : 0;  // a walk's: the first filled tile
  const long long off = (kb * p.Sk + r0) * p.D;
  tile_mean(static_cast<const Tin*>(p.k) + off, p.Sk - r0, p.Tkv, p.D, rot, p.hval,
            p.km + kb * p.D, part);
  tile_mean(static_cast<const Tin*>(p.v) + off, p.Sk - r0, p.Tkv, p.D, false, p.hval,
            p.vm + kb * p.D, part);
}

// One warp per row of K (rows [0, n)) or V (rows [n, 2n)): rotate K, subtract
// the mean, quantize (reciprocal multiply, no clip), write the codes (INT4
// packed split-halves) and the scale, and the dequantized row bf16(code ·
// scale) that the attention reads. NE: elements of a row a lane
// (D <= 32 NE).
template <typename Tin, int NE>
__global__ void __launch_bounds__(KV_WARPS * 32) fused_kv_quant_kernel(const FQParams p) {
  __shared__ float s_raw[KV_WARPS][32 * NE];
  __shared__ int s_code[KV_WARPS][32 * NE];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long n = (long long)p.B * p.Hkv * p.Sk;
  const long long row = (long long)blockIdx.x * KV_WARPS + warp;
  if (row >= 2 * n) return;
  const bool is_v = row >= n;
  const long long r = is_v ? row - n : row;
  const int D = p.D;
  const Tin* x = static_cast<const Tin*>(is_v ? p.v : p.k) + r * D;
  const float* mean = (p.flags & F_SMOOTH) ? (is_v ? p.vm : p.km) + (r / p.Sk) * D : nullptr;
  const bool rot = !is_v && (p.flags & F_HADAMARD);
  const bool int4 = p.flags & (is_v ? F_V_INT4 : F_K_INT4);
  const float fq = (float)(is_v ? p.qmax_v : p.qmax_k);
  float* raw = s_raw[warp];
  int* code = s_code[warp];
  if (rot) {
    for (int c = lane; c < D; c += 32) raw[c] = Elem<Tin>::load(x, c);
    __syncwarp();
  }
  float y[NE];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < NE; ++i) {
    const int c = lane + 32 * i;
    float t = 0.f;
    if (c < D) {
      t = rot ? rotate_elem([&](int j) { return raw[j]; }, c, D, p.hval) : Elem<Tin>::load(x, c);
      if (mean) t = __fsub_rn(t, mean[c]);
      amax = fmaxf(amax, fabsf(t));
    }
    y[i] = t;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  amax = fmaxf(amax, 1e-12f);
  const float sc = __fdiv_rn(amax, fq), rcp = __fdiv_rn(fq, amax);
  int8_t* vals = is_v ? p.vv : p.kv;
  __nv_bfloat16* deq = (is_v ? p.vb : p.kb) + r * D;
#pragma unroll
  for (int i = 0; i < NE; ++i) {
    const int c = lane + 32 * i;
    if (c >= D) continue;
    const int qc = (int)rintf(__fmul_rn(y[i], rcp));
    deq[c] = __float2bfloat16_rn(__fmul_rn((float)qc, sc));
    if (int4)
      code[c] = qc;
    else
      vals[r * D + c] = (int8_t)qc;
  }
  if (int4) {
    __syncwarp();
    const int h = D / 2;
    for (int c = lane; c < h; c += 32)
      vals[r * h + c] = (int8_t)(unsigned char)((code[c] & 0xF) | ((code[c + h] & 0xF) << 4));
  }
  if (lane == 0) (is_v ? p.vs : p.ks)[r] = sc;
}

// The operand a row of the BLOCK/ASYMMETRIC pre-pass belongs to: rows
// [0, nq) are Q's (an integer Q only), then nkv of K and nkv of V, each
// (b, h, s) flattened.
struct RowOf {
  int op;  // 0 Q, 1 K, 2 V; -1 past the last row
  long long r;  // the row within its operand
  int S, group, qmax;
  bool rot, int4;
  const void* src;
  const float* mean;  // the (b, h)'s smoothing mean, or null
};

__device__ __forceinline__ long long q_rows(const FQParams& p) {
  return (p.flags & F_Q_DENSE) ? 0 : (long long)p.B * p.Hq * p.Sq;
}

__device__ __forceinline__ RowOf row_of(const FQParams& p, long long row) {
  const long long nq = q_rows(p), nkv = (long long)p.B * p.Hkv * p.Sk;
  const bool rot = p.flags & F_HADAMARD;
  RowOf o{-1, 0, 1, 0, 0, false, false, nullptr, nullptr};
  if (row < nq) {
    o = {0, row, p.Sq, p.q_group, p.qmax_q, rot, (p.flags & F_Q_INT4) != 0, p.q,
         (p.flags & F_SMOOTH_Q) ? p.qm + (row / p.Sq) * p.D : nullptr};
  } else if (row < nq + 2 * nkv) {
    const bool is_v = row >= nq + nkv;
    const long long r = row - nq - (is_v ? nkv : 0);
    o = {is_v ? 2 : 1, r, p.Sk, is_v ? p.v_group : p.k_group, is_v ? p.qmax_v : p.qmax_k,
         rot && !is_v, (p.flags & (is_v ? F_V_INT4 : F_K_INT4)) != 0, is_v ? p.v : p.k,
         (p.flags & F_SMOOTH) ? (is_v ? p.vm : p.km) + (r / p.Sk) * p.D : nullptr};
  }
  return o;
}

// BLOCK/ASYMMETRIC pass 1: one warp per row of Q, K or V (`row_of`): the
// row rotated (Q and K, with F_HADAMARD; rotate_elem's sum, as in the
// other passes), less its mean, as fp32 into ys, and its statistic into
// st: the absmax, or hi at [row] and lo at [rows + row] when asymmetric.
template <typename Tin, int NE>
__global__ void __launch_bounds__(KV_WARPS * 32) fused_rows_kernel(const FQParams p) {
  __shared__ float s_raw[KV_WARPS][32 * NE];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * KV_WARPS + warp;
  const RowOf o = row_of(p, row);
  if (o.op < 0) return;
  const int D = p.D;
  const bool asym = p.flags & F_ASYM;
  const Tin* x = static_cast<const Tin*>(o.src) + o.r * D;
  float* raw = s_raw[warp];
  if (o.rot) {
    for (int c = lane; c < D; c += 32) raw[c] = Elem<Tin>::load(x, c);
    __syncwarp();
  }
  float* y = p.ys + row * D;
  float hi = asym ? -INFINITY : 0.f, lo = INFINITY;
#pragma unroll
  for (int i = 0; i < NE; ++i) {
    const int c = lane + 32 * i;
    if (c >= D) continue;
    float t = o.rot ? rotate_elem([&](int j) { return raw[j]; }, c, D, p.hval)
                    : Elem<Tin>::load(x, c);
    if (o.mean) t = __fsub_rn(t, o.mean[c]);
    y[c] = t;
    hi = fmaxf(hi, asym ? t : fabsf(t));
    lo = fminf(lo, t);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, s));
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, s));
  }
  if (lane == 0) {
    p.st[row] = hi;
    if (asym) p.st[q_rows(p) + 2LL * p.B * p.Hkv * p.Sk + row] = lo;
  }
}

// BLOCK/ASYMMETRIC pass 2: one warp per row. The statistic of the row's
// group (its own row under ROW) is the max (and min) of its rows' in st,
// and, where the group runs past S, of the reference's zero-padded rows,
// 0 − mean; then the row quantizes (symmetric: reciprocal multiply, no
// clip; asymmetric: exact divisions, the zero point unclipped) and writes
// its codes (INT4 packed split-halves), scale, zero point and dequantized
// bf16 row: K̃, Ṽ, or Q's times the softmax scale into qb. PVC (pv_int8 with
// an INT4 V): V's codes also go unpacked, a byte each, into vcode.
template <int NE, bool PVC = false>
__global__ void __launch_bounds__(KV_WARPS * 32) fused_group_quant_kernel(const FQParams p) {
  __shared__ int s_code[KV_WARPS][32 * NE];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * KV_WARPS + warp;
  const RowOf o = row_of(p, row);
  if (o.op < 0) return;
  const int D = p.D, G = max(o.group, 1);
  const bool asym = p.flags & F_ASYM;
  const long long lo_at = q_rows(p) + 2LL * p.B * p.Hkv * p.Sk;
  const long long r_in = o.r % o.S, base = row - r_in;
  const long long g0 = r_in - r_in % G, g1 = min(g0 + G, (long long)o.S);
  float hi = asym ? -INFINITY : 0.f, lo = INFINITY;
  for (long long j = g0 + lane; j < g1; j += 32) {
    hi = fmaxf(hi, p.st[base + j]);
    if (asym) lo = fminf(lo, p.st[lo_at + base + j]);
  }
  if (g0 + G > o.S) {
    for (int c = lane; c < D; c += 32) {
      const float t = o.mean ? __fsub_rn(0.f, o.mean[c]) : 0.f;
      hi = fmaxf(hi, asym ? t : fabsf(t));
      lo = fminf(lo, t);
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, s));
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, s));
  }
  const float fq = (float)o.qmax;
  float sc, rcp = 0.f, zp = 0.f;
  if (asym) {
    sc = __fdiv_rn(fmaxf(__fsub_rn(hi, lo), 1e-12f), 2.f * fq + 1.f);
    zp = __fsub_rn(rintf(__fdiv_rn(-lo, sc)), fq + 1.f);
  } else {
    hi = fmaxf(hi, 1e-12f);
    sc = __fdiv_rn(hi, fq);
    rcp = __fdiv_rn(fq, hi);
  }
  const float* y = p.ys + row * D;
  int8_t* vals = o.op == 0 ? p.qv : o.op == 1 ? p.kv : p.vv;
  __nv_bfloat16* deq = (o.op == 0 ? p.qb : o.op == 1 ? p.kb : p.vb) + o.r * D;
  int* code = s_code[warp];
#pragma unroll
  for (int i = 0; i < NE; ++i) {
    const int c = lane + 32 * i;
    if (c >= D) continue;
    float qc, x;
    if (asym) {
      qc = __fadd_rn(rintf(__fdiv_rn(y[c], sc)), zp);
      qc = fminf(fmaxf(qc, -fq - 1.f), fq);
      x = __fmul_rn(__fsub_rn(qc, zp), sc);
    } else {
      qc = rintf(__fmul_rn(y[c], rcp));
      x = __fmul_rn(qc, sc);
    }
    deq[c] = __float2bfloat16_rn(o.op == 0 ? __fmul_rn(x, p.scale) : x);
    if (o.int4)
      code[c] = (int)qc;
    else if (vals)
      vals[o.r * D + c] = (int8_t)(int)qc;
    if constexpr (PVC) {
      if (o.op == 2) p.vcode[o.r * D + c] = (int8_t)(int)qc;
    }
  }
  if (!vals) return;  // Q without residuals: only its dequantized row
  if (o.int4) {
    __syncwarp();
    const int h = D / 2;
    for (int c = lane; c < h; c += 32)
      vals[o.r * h + c] = (int8_t)(unsigned char)((code[c] & 0xF) | ((code[c + h] & 0xF) << 4));
  }
  if (lane == 0) {
    (o.op == 0 ? p.qs : o.op == 1 ? p.ks : p.vs)[o.r] = sc;
    if (asym) (o.op == 0 ? p.qzp : o.op == 1 ? p.kzp : p.vzp)[o.r] = (int)zp;
  }
}

// The cc row, cc[b, h, j] = fl(fl(Σ_d bf16(qm[b, h, d]) · k̃[j, d]) · scale),
// k̃ from the K̃ scratch, the products summed in double in order of d (exact:
// products of bf16 values): one block per (CK-key tile, kv head, batch),
// one thread per key and q head of the group. CK keys a tile: 64, 32 at
// D 256 (its staged tile within the 48 KB of static shared memory).
template <int DP>
__host__ __device__ constexpr int cc_keys() { return DP > 128 ? 32 : 64; }

template <int DP>
__global__ void __launch_bounds__(NTM) fused_cc_kernel(const FQParams p) {
  constexpr int CK = cc_keys<DP>();
  __shared__ float sK[CK * (DP + 1)];
  const int k0 = blockIdx.x * CK, hk = blockIdx.y, b = blockIdx.z;
  const int D = p.D, G = p.Hq / p.Hkv;
  const __nv_bfloat16* kb = p.kb + ((long long)b * p.Hkv + hk) * p.Sk * D;
  for (int e = threadIdx.x; e < CK * DP; e += NTM) {
    const int r = e / DP, c = e - r * DP;
    sK[r * (DP + 1) + c] =
        k0 + r < p.Sk && c < D ? __bfloat162float(kb[(long long)(k0 + r) * D + c]) : 0.f;
  }
  __syncthreads();
  const int j = threadIdx.x % CK;
  if (k0 + j >= p.Sk) return;
  for (int gi = threadIdx.x / CK; gi < G; gi += NTM / CK) {
    const long long bh = (long long)b * p.Hq + hk * G + gi;
    const float* qm = p.qm + bh * D;
    double acc = 0.0;
    for (int d = 0; d < D; ++d)
      acc = fma((double)round_bf16(qm[d]), (double)sK[j * (DP + 1) + d], acc);
    p.cc[bh * p.Sk + k0 + j] = __fmul_rn((float)acc, p.scale);
  }
}

// Tile geometry of the attention kernel: warps of 16 query rows, 12 at
// D 64 (BQ = 192 query rows a block; 8 and 10 warps were slower, 14 and 16
// spilled under their register caps) and 8 at D 128 and 256 (BQ = 128, as
// many as shared memory holds), 64-key tiles (32 at D 256), one block an
// SM. Shared memory, in bytes, each part a multiple of 16: the Q tile (the
// dequantized bf16 values, as fp32, or as bf16 at D 256); at D 64 two K
// tiles as double (the tile of step i in i & 1); rings of three K̃ and Ṽ
// tiles (bf16) and cc rows (fp32), the tile of step i in i % 3, copied two
// steps ahead; qm, vm, the Q tile's row scales and its codes. With the
// rotation, the raw Q rows (as double) live in the K tiles and the rings
// before the first copy.
//
// At D 64 each K tile is converted to double once a block, a step ahead,
// not once a warp at each use: conversions to and from double run at a
// fraction of the fp32 rate. At D 128 two double tiles do not fit beside
// the Q tile; the B fragments are converted from the bf16 ring at the load.
// At D 256 an fp32 Q tile of 128 rows (133 KB) and rings of 64-key tiles
// (101 KB each) do not fit: the tile is bf16 (67.6 KB; its values are exact
// bf16) and the key tiles are 32 rows (rings of 50.7 KB), so the D 128
// walk, its 8 warps and its three-deep rings carry over unchanged; a
// warp's P·V accumulators take 128 registers of its 255.
template <int DP>
struct FCfg {
  static constexpr int NW = DP <= 64 ? 12 : 8;
  static constexpr int NTH = 32 * NW;
  static constexpr int BQ = 16 * NW;
  static constexpr int BK = DP > 128 ? 32 : 64;  // keys a tile
  // A step's 16-key chunks are unrolled, but rolled up at D 256, where the
  // compiler kept the Q fragments of every chunk live across the unrolled
  // copies and spilled 2.6 KB a thread (none rolled up).
  static constexpr bool ROLL_CHUNKS = DP > 128;
  static constexpr bool QBF = DP > 128;   // the Q tile as bf16
  static constexpr bool QREG = DP <= 64;  // Q's A fragments held in registers, as double
  static constexpr bool KD = DP <= 64;    // K tiles as double
  // fp32 rows of stride 4 mod 32 words, double rows of stride 4 mod 16
  // double words: the eight rows and four columns of a (g, t) fragment
  // read fall in distinct banks. bf16 rows padded as mma.cuh says.
  static constexpr int LDQ = QBF ? DP + 8 : DP + 4;
  static constexpr int LDK = DP + 4;
  static constexpr int LDR = DP + 8;
  static constexpr int Q = 0;                              // [BQ][LDQ] fp32 (bf16 at D 256)
  static constexpr int KD_ = Q + BQ * LDQ * (QBF ? 2 : 4);  // [2][BK][LDK] double, at D 64
  static constexpr int KR = KD_ + (KD ? 2 * BK * LDK * 8 : 0);  // [3][BK][LDR] bf16
  static constexpr int VR = KR + 3 * BK * LDR * 2;         // [3][BK][LDR] bf16
  static constexpr int CC = VR + 3 * BK * LDR * 2;         // [3][BK] fp32
  static constexpr int QM = CC + 3 * BK * 4;               // [DP] fp32
  static constexpr int VM = QM + DP * 4;                   // [DP] fp32
  static constexpr int RS = VM + DP * 4;                   // [BQ] fp32
  static constexpr int CODE = RS + BQ * 4;                 // [BQ][DP] int8
  static constexpr int BYTES = CODE + BQ * DP;
  // Raw Q rows staged for the rotation, RAW rows at a time, in [KD_, CC).
  static constexpr int RAW = (CC - KD_) / (DP * 8) >= BQ       ? BQ
                             : (CC - KD_) / (DP * 8) >= BQ / 2 ? BQ / 2
                                                               : BQ / 4;
  static_assert(RAW * DP * 8 <= CC - KD_, "raw Q rows fit in the K tiles and rings");
  static_assert(BYTES <= 232448, "one block fits in an SM's shared memory");
  // pv_int8: the Ṽ ring's bytes hold a ring of three V code tiles (int8
  // rows of DP + 16 bytes) and the two transposed tiles P·V reads (DP rows
  // of BK + 16 bytes, the keys of each 32-key step in the fragment's order).
  static constexpr int LDC = DP + 16;
  static constexpr int LDT = BK + 16;
  static constexpr int VC = VR;                     // [3][BK][LDC] int8
  static constexpr int VT = VC + 3 * BK * LDC;      // [2][DP][LDT] u8
  static_assert(VT + 2 * DP * LDT <= CC, "the code tiles fit in the Ṽ ring");
};

// Rows [r0, r0 + ROWS) of an (n, D) bf16 matrix into a ring buffer of row
// stride DP + 8; rows past n and columns past D are zero. mode 2: 16-byte
// cp.async (D % 8 == 0, src 16-byte aligned), 1: 4-byte cp.async (D even,
// 4-aligned), 0: element loads, stored at once (odd D).
template <int DP, int NTH, int ROWS>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int r0,
                                          int n, int D, int mode) {
  constexpr int LD = DP + 8;
  if (mode == 2) {
    constexpr int CH = DP / 8;
#pragma unroll
    for (int e = threadIdx.x; e < ROWS * CH; e += NTH) {
      const int r = e / CH, c = (e % CH) * 8;
      const bool ok = r0 + r < n && c < D;
      cp_async16(dst + r * LD + c, ok ? src + (long long)(r0 + r) * D + c : src, ok ? 16 : 0);
    }
  } else if (mode == 1) {
    constexpr int CW = DP / 2;
#pragma unroll 4
    for (int e = threadIdx.x; e < ROWS * CW; e += NTH) {
      const int r = e / CW, c = (e % CW) * 2;
      const bool ok = r0 + r < n && c < D;
      cp_async4(dst + r * LD + c, ok ? src + (long long)(r0 + r) * D + c : src, ok ? 4 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DP; e += NTH) {
      const int r = e / DP, c = e - r * DP;
      dst[r * LD + c] =
          r0 + r < n && c < D ? src[(long long)(r0 + r) * D + c] : __float2bfloat16_rn(0.f);
    }
  }
}

// Rows [r0, r0 + ROWS) of an (n, D) int8 matrix into a ring buffer of row
// stride DP + 16 bytes; rows past n and columns past D are zero. mode 2:
// 16-byte cp.async (D % 16 == 0, src 16-byte aligned), 1: 4-byte cp.async
// (D % 4 == 0, 4-aligned), 0: byte loads, stored at once.
template <int DP, int NTH, int ROWS>
__device__ __forceinline__ void copy_codes(int8_t* dst, const int8_t* src, int r0, int n, int D,
                                           int mode) {
  constexpr int LD = DP + 16;
  if (mode == 2) {
    constexpr int CH = DP / 16;
    for (int e = threadIdx.x; e < ROWS * CH; e += NTH) {
      const int r = e / CH, c = (e % CH) * 16;
      const bool ok = r0 + r < n && c < D;
      cp_async16(dst + r * LD + c, ok ? src + (long long)(r0 + r) * D + c : src, ok ? 16 : 0);
    }
  } else if (mode == 1) {
    constexpr int CW = DP / 4;
    for (int e = threadIdx.x; e < ROWS * CW; e += NTH) {
      const int r = e / CW, c = (e % CW) * 4;
      const bool ok = r0 + r < n && c < D;
      cp_async4(dst + r * LD + c, ok ? src + (long long)(r0 + r) * D + c : src, ok ? 4 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DP; e += NTH) {
      const int r = e / DP, c = e - r * DP;
      dst[r * LD + c] = r0 + r < n && c < D ? src[(long long)(r0 + r) * D + c] : (int8_t)0;
    }
  }
}

// Columns c + k·DP/4 (k < 4) of the rotated row x·H: each rotate_elem's
// sum, the four chains interleaved so that they overlap.
template <int DP, typename Load>
__device__ __forceinline__ void rotate4(Load x, int c, int D, float hval, float (&y)[4]) {
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  for (int j = 0; j < D; ++j) {
    const double xj = x(j);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      acc[k] = fma(xj, (__popc(j & (c + k * (DP / 4))) & 1) ? -(double)hval : (double)hval,
                   acc[k]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) y[k] = (float)acc[k];
}

// The bf16 Q tile of the D 256 layout (FCfg<DP>::QBF): one warp a row, its
// NE = DP / 32 values a lane (column lane + 32 i) read into registers from
// q, or rotated there from the raw rows staged as double in `raw` (L::RAW
// at a time; each column's sum in the order of rotate_elem, the NE chains
// interleaved); then the mean subtracted, quantized as the fp32 tile is
// (codes to sCode, scales to sRs) and stored as the dequantized bf16 value
// times the softmax scale, or, dense, as bf16(q_rot · scale). Rows past
// nvalid and columns past D are 0. Every thread calls it (barriers).
template <int DP, typename Tin>
__device__ __forceinline__ void stage_q_bf16(__nv_bfloat16* sQb, int8_t* sCode, float* sRs,
                                             const float* sQm, double* raw, const Tin* q,
                                             int nvalid, const FQParams& p) {
  using L = FCfg<DP>;
  constexpr int NE = DP / 32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, D = p.D;
  const bool rot = p.flags & F_HADAMARD, dense = p.flags & F_Q_DENSE;
  const bool smooth_q = p.flags & F_SMOOTH_Q;
  const float fq = (float)p.qmax_q;
  for (int r0 = 0; r0 < L::BQ; r0 += L::RAW) {
    if (rot) {
      for (int e = tid; e < L::RAW * D; e += L::NTH)
        raw[e] = r0 + e / D < nvalid ? (double)Elem<Tin>::load(q, (long long)r0 * D + e) : 0.0;
      __syncthreads();
    }
    for (int r = r0 + warp; r < r0 + L::RAW; r += L::NW) {  // warp-uniform
      __nv_bfloat16* tr = sQb + r * L::LDQ;
      const bool live = r < nvalid;
      float y[NE];
      if (live && rot) {
        const double* xr = raw + (r - r0) * D;
        double acc[NE];
#pragma unroll
        for (int i = 0; i < NE; ++i) acc[i] = 0.0;
        for (int j = 0; j < D; ++j) {
          const double xj = xr[j];
#pragma unroll
          for (int i = 0; i < NE; ++i)
            acc[i] = fma(xj, (__popc(j & (lane + 32 * i)) & 1) ? -(double)p.hval : (double)p.hval,
                         acc[i]);
        }
#pragma unroll
        for (int i = 0; i < NE; ++i) y[i] = lane + 32 * i < D ? (float)acc[i] : 0.f;
      } else {
#pragma unroll
        for (int i = 0; i < NE; ++i) {
          const int c = lane + 32 * i;
          y[i] = live && c < D ? Elem<Tin>::load(q, (long long)r * D + c) : 0.f;
        }
      }
      if (dense) {
#pragma unroll
        for (int i = 0; i < NE; ++i) {
          const int c = lane + 32 * i;
          tr[c] = __float2bfloat16_rn(live && c < D ? round_bf16(__fmul_rn(y[i], p.scale)) : 0.f);
        }
        continue;
      }
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < NE; ++i) {
        const int c = lane + 32 * i;
        if (c < D) {
          if (smooth_q) y[i] = __fsub_rn(y[i], sQm[c]);
          amax = fmaxf(amax, fabsf(y[i]));
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      amax = fmaxf(amax, 1e-12f);
      const float sc = __fdiv_rn(amax, fq), rcp = __fdiv_rn(fq, amax);
#pragma unroll
      for (int i = 0; i < NE; ++i) {
        const int c = lane + 32 * i;
        float x = 0.f;
        if (live && c < D) {
          const float qf = rintf(__fmul_rn(y[i], rcp));
          sCode[r * DP + c] = (int8_t)(int)qf;
          x = round_bf16(__fmul_rn(__fmul_rn(qf, sc), p.scale));
        }
        tr[c] = __float2bfloat16_rn(x);
      }
      if (live && lane == 0) sRs[r] = sc;
    }
    if (rot) __syncthreads();  // raw read before the next rows land
  }
}

template <typename Tin, typename Tout, int DP, bool SPARSE, bool PV = false>
__global__ void __launch_bounds__(FCfg<DP>::NTH, 1) fused_qattn_tc_kernel(const FQParams p) {
  using L = FCfg<DP>;
  constexpr int NTH = L::NTH, NW = L::NW, BQ_ = L::BQ;
  constexpr int KST = DP / 8;  // 8-deep steps of QKᵀ
  constexpr int NA = DP / 8;   // 8-column accumulator tiles of out
  constexpr int NE = DP / 32;  // elements of a Q row per lane
  constexpr int BK = L::BK;
  constexpr bool QREG = L::QREG, KD = L::KD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw + L::Q);
  __nv_bfloat16* sQb = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::Q);  // at D 256
  double* sKd = reinterpret_cast<double*>(smem_raw + L::KD_);
  __nv_bfloat16* sKR = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::KR);
  __nv_bfloat16* sVR = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::VR);
  float* sCC = reinterpret_cast<float*>(smem_raw + L::CC);
  float* sQm = reinterpret_cast<float*>(smem_raw + L::QM);
  float* sVm = reinterpret_cast<float*>(smem_raw + L::VM);
  float* sRs = reinterpret_cast<float*>(smem_raw + L::RS);
  int8_t* sCode = reinterpret_cast<int8_t*>(smem_raw + L::CODE);
  int8_t* sVC = reinterpret_cast<int8_t*>(smem_raw + L::VC);    // PV: the V code ring
  uint8_t* sVT = reinterpret_cast<uint8_t*>(smem_raw + L::VT);  // PV: the transposed tiles

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ_, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int D = p.D;
  const bool smooth = p.flags & F_SMOOTH, smooth_q = p.flags & F_SMOOTH_Q;
  const long long bh = (long long)b * p.Hq + h;
  const long long qrow = bh * p.Sq;
  const long long krow = ((long long)b * p.Hkv + hk) * p.Sk;
  const __nv_bfloat16* kbf = p.kb + krow * D;
  const __nv_bfloat16* vbf = p.vb + krow * D;
  const float* ccrow = smooth_q ? p.cc + bh * p.Sk : nullptr;
  const float* bias = p.bias ? p.bias + b * p.bsb + h * p.bsh : nullptr;

  int k_lo, k_hi;
  visible_keys(q0, min(q0 + BQ_, p.Sq) - 1, p.Sk, p.left, p.right, &k_lo, &k_hi);
  const int t_lo = k_lo / BK;
  int n_t = k_hi >= k_lo ? k_hi / BK - t_lo + 1 : 0;
  // SPARSE: the walk from its start, the position of the next tile to copy
  // (w_is) and of the step's tile (w_at); both passes start again at
  // w_start.
  SparseWalk sw;
  WalkPos w_start{0, -1, 0, 0}, w_is, w_at;
  if constexpr (SPARSE) {
    sw = sparse_walk(p.sm, true, b, h, 1, q0, min(q0 + BQ_, p.Sq) - 1, k_lo, k_hi, BK, p.Sk);
    if (n_t > 0) {
      w_start = walk_start(sw);
      n_t = walk_count(sw, w_start);
    }
    w_is = w_at = w_start;
  }
  // Steps [0, n_t) are pass 1 (QKᵀ and the row max, K̃ only), steps
  // [n_t, 2 n_t) pass 2 (P against the final max, P·V), over the same
  // tiles. Step i reads ring buffer i % 3; tile i + 2 is copied meanwhile.
  const int steps = 2 * n_t;
  auto k0_of = [&](int i) { return (t_lo + (i < n_t ? i : i - n_t)) * BK; };
  auto issue = [&](int i) {  // called once for each i, in order
    if (i < steps) {
      int k0;
      if constexpr (SPARSE) {
        if (i == n_t) w_is = w_start;
        k0 = walk_take(sw, w_is).first;
      } else {
        k0 = k0_of(i);
      }
      const int buf = i % 3;
      copy_rows<DP, NTH, BK>(sKR + buf * BK * L::LDR, kbf, k0, p.Sk, D, p.kvmode);
      if constexpr (PV) {
        if (i >= n_t)
          copy_codes<DP, NTH, BK>(sVC + buf * BK * L::LDC, p.vcode + krow * D, k0, p.Sk, D,
                                  p.vcmode);
      } else {
        if (i >= n_t) copy_rows<DP, NTH, BK>(sVR + buf * BK * L::LDR, vbf, k0, p.Sk, D, p.kvmode);
      }
      if (smooth_q && tid < BK) copy_scale(sCC + buf * BK, ccrow, 1, k0, tid, p.Sk);
    }
    cp_async_commit();  // empty groups keep the count of groups uniform
  };

  for (int c = tid; c < DP; c += NTH) {
    const bool in = c < D;
    sQm[c] = in && smooth_q ? p.qm[bh * D + c] : 0.f;
    sVm[c] = in && smooth ? p.vm[((long long)b * p.Hkv + hk) * D + c] : 0.f;
  }

  // The Q tile, quantized to its dequantized values with the softmax scale
  // folded in, or, dense, rounded as bf16(q_rot · scale). Rows past Sq and
  // columns past D stay 0. Up to D 128 the tile is fp32: staged, rotated
  // (each raw row converted to double once, then rotated from shared
  // memory, RAW rows at a time), then quantized in place. At D 256 it is
  // bf16, and each warp quantizes whole rows from registers
  // (`stage_q_bf16`).
  const int nvalid = min(BQ_, p.Sq - q0);
  if constexpr (L::QBF) {
    __syncthreads();  // sQm written
    stage_q_bf16<DP, Tin>(sQb, sCode, sRs, sQm, reinterpret_cast<double*>(smem_raw + L::KD_),
                         static_cast<const Tin*>(p.q) + (qrow + q0) * D, nvalid, p);
  } else {
    const Tin* q = static_cast<const Tin*>(p.q) + (qrow + q0) * D;
    if (p.flags & F_HADAMARD) {
      double* raw = reinterpret_cast<double*>(smem_raw + L::KD_);
      constexpr int C4 = DP / 4;
      for (int r0 = 0; r0 < BQ_; r0 += L::RAW) {
        for (int e = tid; e < L::RAW * D; e += NTH)
          raw[e] = r0 + e / D < nvalid ? (double)Elem<Tin>::load(q, (long long)r0 * D + e) : 0.0;
        __syncthreads();
        for (int e = tid; e < L::RAW * C4; e += NTH) {
          const int r = e / C4, c = e - r * C4;
          float y[4] = {0.f, 0.f, 0.f, 0.f};
          if (r0 + r < nvalid) {
            const double* xr = raw + r * D;
            rotate4<DP>([&](int j) { return xr[j]; }, c, D, p.hval, y);
          }
#pragma unroll
          for (int k = 0; k < 4; ++k)
            sQ[(r0 + r) * L::LDQ + c + k * C4] = c + k * C4 < D ? y[k] : 0.f;
        }
        __syncthreads();
      }
    } else {
      for (int e = tid; e < BQ_ * DP; e += NTH) {
        const int r = e / DP, c = e - r * DP;
        sQ[r * L::LDQ + c] = r < nvalid && c < D ? Elem<Tin>::load(q, (long long)r * D + c) : 0.f;
      }
      __syncthreads();
    }
    if (p.flags & F_Q_DENSE) {
      for (int e = tid; e < nvalid * DP; e += NTH) {
        const int r = e / DP, c = e - r * DP;
        float* x = sQ + r * L::LDQ + c;
        *x = round_bf16(__fmul_rn(*x, p.scale));
      }
    } else {
      const float fq = (float)p.qmax_q;
      for (int r = warp; r < nvalid; r += NW) {  // one warp per row
        float* tr = sQ + r * L::LDQ;
        float y[NE];
        float amax = 0.f;
#pragma unroll
        for (int i = 0; i < NE; ++i) {
          const int c = lane + 32 * i;
          float x = 0.f;
          if (c < D) {
            x = tr[c];
            if (smooth_q) x = __fsub_rn(x, sQm[c]);
            amax = fmaxf(amax, fabsf(x));
          }
          y[i] = x;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
        amax = fmaxf(amax, 1e-12f);
        const float sc = __fdiv_rn(amax, fq), rcp = __fdiv_rn(fq, amax);
#pragma unroll
        for (int i = 0; i < NE; ++i) {
          const int c = lane + 32 * i;
          if (c < D) {
            const float qf = rintf(__fmul_rn(y[i], rcp));
            sCode[r * DP + c] = (int8_t)(int)qf;
            tr[c] = round_bf16(__fmul_rn(__fmul_rn(qf, sc), p.scale));
          }
        }
        if (lane == 0) sRs[r] = sc;
      }
    }
  }
  if (!(p.flags & F_Q_DENSE) && p.qv) {  // the Q residual: codes (INT4 packed) and scales
    __syncthreads();
    const bool q4 = p.flags & F_Q_INT4;
    const int w = q4 ? D / 2 : D;
    for (int e = tid; e < nvalid * w; e += NTH) {
      const int r = e / w, c = e - r * w;
      int code = sCode[r * DP + c];
      if (q4) code = (code & 0xF) | ((sCode[r * DP + c + w] & 0xF) << 4);
      p.qv[(qrow + q0 + r) * w + c] = (int8_t)(unsigned char)code;
    }
    for (int r = tid; r < nvalid; r += NTH) p.qs[qrow + q0 + r] = sRs[r];
  }
  __syncthreads();

  const int rw = warp * 16;                       // the warp's first row in the tile
  const int row0 = q0 + rw + g, row1 = row0 + 8;  // this thread's two rows
  // Q's A fragments, as double: a[0] = Q[g][8 ks + t], a[1] = Q[g + 8][..],
  // a[2], a[3] four columns on (mma.cuh).
  double qf[QREG ? KST : 1][4];
  auto q_frag = [&](int ks, double (&a)[4]) {
    if constexpr (L::QBF) {
      const __nv_bfloat16* qa = sQb + (rw + g) * L::LDQ + 8 * ks + tq;
      a[0] = __bfloat162float(qa[0]);
      a[1] = __bfloat162float(qa[8 * L::LDQ]);
      a[2] = __bfloat162float(qa[4]);
      a[3] = __bfloat162float(qa[8 * L::LDQ + 4]);
    } else {
      const float* qa = sQ + (rw + g) * L::LDQ + 8 * ks + tq;
      a[0] = qa[0];
      a[1] = qa[8 * L::LDQ];
      a[2] = qa[4];
      a[3] = qa[8 * L::LDQ + 4];
    }
  };
  if constexpr (QREG) {
#pragma unroll
    for (int ks = 0; ks < KST; ++ks) q_frag(ks, qf[ks]);
  }

  // The K̃ tile of step i as double, two columns a thread at a time.
  auto convert_k = [&](int i) {
    const __nv_bfloat16* src = sKR + (i % 3) * BK * L::LDR;
    double* dst = sKd + (i & 1) * BK * L::LDK;
#pragma unroll 4
    for (int e = tid; e < BK * DP / 2; e += NTH) {
      const int r = e / (DP / 2), c = 2 * (e % (DP / 2));
      const float2 x =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src + r * L::LDR + c));
      *reinterpret_cast<double2*>(dst + r * L::LDK + c) = make_double2(x.x, x.y);
    }
  };
  issue(0);
  issue(1);
  if (KD && steps > 0) {
    cp_async_wait<1>();
    __syncthreads();
    convert_k(0);
  }

  // This thread's scores of keys k0 + 16 c + [0, 16) of step i's K tile:
  // the exact double dot rounded once, + cc, + bias tb, index-masked to
  // MASK_VALUE (keys at or past kend hidden, and SPARSE, where the block
  // straddles map tiles, each element's own tile); element (jj, e) is row
  // e < 2 ? row0 : row1, key k0 + 16 c + 8 jj + 2 tq + (e & 1). With `edge`
  // (the tile crosses a mask edge or carries a bias) returns the bits
  // 4 jj + e of the visible.
  int kend = 0;                // SPARSE: the step's key limit and bias (set in the loop)
  const float* tb = nullptr;
  auto chunk = [&](int i, int k0, int c, bool edge, float (&s)[2][4]) -> unsigned {
    const double* cKd = sKd + (i & 1) * BK * L::LDK;
    const __nv_bfloat16* cKR = sKR + (i % 3) * BK * L::LDR;
    double sd[2][4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) sd[jj][e] = 0.0;
#pragma unroll
    for (int ks = 0; ks < KST; ++ks) {
      double a[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[ks][e];
      } else {
        q_frag(ks, a);
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int kr = 16 * c + 8 * jj + g, kc = 8 * ks + tq;
        double bf[2];
        if constexpr (KD) {
          bf[0] = cKd[kr * L::LDK + kc];
          bf[1] = cKd[kr * L::LDK + kc + 4];
        } else {
          bf[0] = __bfloat162float(cKR[kr * L::LDR + kc]);
          bf[1] = __bfloat162float(cKR[kr * L::LDR + kc + 4]);
        }
        mma_f64(sd[jj], a, bf);
      }
    }
    const float* cCC = sCC + (i % 3) * BK + 16 * c;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      float2 cc = make_float2(0.f, 0.f);
      if (smooth_q) cc = *reinterpret_cast<const float2*>(cCC + 8 * jj + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = (float)sd[jj][e];
        s[jj][e] = smooth_q ? __fadd_rn(x, e & 1 ? cc.y : cc.x) : x;
      }
    }
    unsigned vis = 0xffu;
    if (edge) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? row0 : row1, col = k0 + 16 * c + 8 * jj + 2 * tq + (e & 1);
          if (key_visible(row, col, p.Sq, SPARSE ? kend : p.Sk, p.left, p.right) &&
              (!SPARSE || sw.fetch || walk_has(sw, 0, row, col))) {
            const float* bb = SPARSE ? tb : bias;
            if (bb) s[jj][e] = __fadd_rn(s[jj][e], bb[row * p.bsq + col * p.bsk]);
          } else {
            s[jj][e] = MASK_VALUE;
            vis &= ~(1u << (4 * jj + e));
          }
        }
    }
    return vis;
  };

  const bool sum_rounded = D < 128;
  // The 16-key chunks of a step, BK / 16. At D 256 (ROLL_CHUNKS) the count
  // passes through an empty asm, so the compiler cannot see it and
  // `#pragma unroll` (which unrolls only a known trip count) leaves the
  // loops over the chunks rolled up. `#pragma unroll(ROLL_CHUNKS ? 1 :
  // BK / 16)` would say the same, but nvcc then builds other D <= 128
  // code: 344 bytes of spill stores a thread at D 128 where this form has
  // 184, 244 at D 64 where it has 196.
  int n_chunks = BK / 16;
  if constexpr (L::ROLL_CHUNKS) asm volatile("" : "+r"(n_chunks));
  float m[2] = {MASK_VALUE, MASK_VALUE}, l[2] = {0.f, 0.f};
  float acc[NA][4];
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // PV: keys a chunk, and chunks a row in the ml scratch (set to −1e30 by
  // the host: a chunk no tile of which a row's warp computes keeps it).
  const int pvc = p.v_group, nch = PV ? (p.Sk + pvc - 1) / pvc : 0;

  for (int i = 0; i < steps; ++i) {
    // At D 64 the next tile is converted a step ahead, so it must have
    // landed too; else only tile i. PV: the next pass-2 tile's codes are
    // transposed a step ahead.
    bool ahead = KD;
    if constexpr (PV) ahead = ahead || (i + 1 >= n_t && i + 1 < steps);
    if (ahead)
      cp_async_wait<0>();
    else
      cp_async_wait<1>();
    __syncthreads();  // those tiles landed; every warp is done with step i - 1
    issue(i + 2);     // into the buffers step i - 1 read
    if (KD && i + 1 < steps) convert_k(i + 1);
    if constexpr (PV) {
      if (i + 1 >= n_t && i + 1 < steps)
        transpose_codes<DP, NTH, BK>(sVT + ((i + 1) & 1) * DP * L::LDT,
                                     sVC + ((i + 1) % 3) * BK * L::LDC);
    }
    if (i == n_t) {
      m[0] = quad_max(m[0]);
      m[1] = quad_max(m[1]);
    }

    // The step's first key; SPARSE: its key limit (keys at or past it are
    // hidden) and its bias (none read on a FULL tile).
    int k0;
    if constexpr (SPARSE) {
      if (i == n_t) w_at = w_start;
      const WalkTile t = walk_take(sw, w_at);
      k0 = t.first;
      kend = t.end;
      tb = t.full ? nullptr : bias;
    } else {
      k0 = k0_of(i);
    }
    // Rows rw..rw+15 of the tile against keys k0..k0+63: none visible, all
    // visible (and all rows real), or an edge.
    const int r_lo = q0 + rw, r_hi = r_lo + 15;
    const bool none = r_lo >= p.Sq || k0 >= (SPARSE ? kend : p.Sk) ||
                      (p.right >= 0 && k0 > r_hi + p.right) ||
                      (p.left >= 0 && k0 + BK - 1 < r_lo - p.left);
    if (none) continue;
    const bool all = k0 + BK <= (SPARSE ? kend : p.Sk) && r_hi < p.Sq &&
                     (p.right < 0 || k0 + BK - 1 <= r_lo + p.right) &&
                     (p.left < 0 || k0 >= r_hi - p.left) && (!SPARSE || sw.fetch != nullptr);
    const bool edge = !all || (SPARSE ? tb : bias);
    if (i < n_t) {
      // Pass 1: the exact row max over every visible key, QKᵀ alone; PV
      // also the tile's max into its chunk's (a tile lies in one chunk;
      // each row's entries are its quad's alone).
      float tm[2] = {MASK_VALUE, MASK_VALUE};
#pragma unroll
      for (int c = 0; c < n_chunks; ++c) {
        float s[2][4];
        chunk(i, k0, c, edge, s);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          if constexpr (PV) {
            tm[0] = fmaxf(tm[0], fmaxf(s[jj][0], s[jj][1]));
            tm[1] = fmaxf(tm[1], fmaxf(s[jj][2], s[jj][3]));
          } else {
            m[0] = fmaxf(m[0], fmaxf(s[jj][0], s[jj][1]));
            m[1] = fmaxf(m[1], fmaxf(s[jj][2], s[jj][3]));
          }
        }
      }
      if constexpr (PV) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          m[r] = fmaxf(m[r], tm[r]);
          const float x = quad_max(tm[r]);
          const int row = r ? row1 : row0;
          if (tq == 0 && row < p.Sq) {
            float* e = p.ml + (qrow + row) * nch + k0 / pvc;
            *e = fmaxf(*e, x);
          }
        }
      }
    } else if constexpr (PV) {
      // Pass 2, integer P·V: p̂ = rint(expf(s − (ml − ln A))) against the
      // chunk's max, the codes of two 16-key chunks the u8 A fragment of
      // a 32-deep step, the V codes its s8 B fragments from the transposed
      // tile; the exact s32 sum converts once a step.
      // The tile's chunk: ml − ln A (mla), β (wl) and β·sv (wv) of the
      // thread's two rows.
      const int ch = k0 / pvc;
      const float sv = p.vs[krow + (long long)ch * pvc];
      float mla[2], wl[2], wv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r ? row1 : row0;
        const float mlr = row < p.Sq ? p.ml[(qrow + row) * nch + ch] : MASK_VALUE;
        // A row with no visible key (m = −1e30) is left to the epilogue.
        const float beta = m[r] == MASK_VALUE ? 0.f : expf(__fsub_rn(mlr, m[r]));
        mla[r] = __fsub_rn(mlr, LN_P_AMP);
        wl[r] = beta;
        wv[r] = __fmul_rn(beta, sv);
      }
      const uint8_t* cT = sVT + (i & 1) * DP * L::LDT + 4 * tq;
      // The step's 16-key chunks, two to a 32-deep product, rolled up at
      // every D (the count through an empty asm, as n_chunks): unrolled,
      // the two chunks of a 32-key step kept both score fragments and their
      // Q reads live and spilled 2.4-3.2 KB a thread at D 256; rolled, D 128
      // spills 216 bytes against 448-956 and runs 6.0 ms against 6.7 at B2
      // S4096 (D 64 and 256 alike; PERF.md §6).
      int n_pv = BK / 16;
      asm volatile("" : "+r"(n_pv));
      uint32_t a[4];
      int ps[2] = {0, 0};
#pragma unroll
      for (int c = 0; c < n_pv; ++c) {
        float sc[2][4];
        chunk(i, k0, c, edge, sc);
        uint32_t w[2] = {0u, 0u};
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) {  // byte j: key 2 tq + (j & 1) + 8 (j >> 1)
            const int code = (int)rintf(expf(__fsub_rn(sc[j >> 1][2 * r + (j & 1)], mla[r])));
            ps[r] += code;
            w[r] |= (uint32_t)code << (8 * j);
          }
        if (p.pcode) {  // the codes of the lanes whose chunk counts, for checks
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = r ? row1 : row0;
            if (wl[r] <= 0.f || row >= p.Sq) continue;
            for (int j = 0; j < 4; ++j) {
              const int col = k0 + 16 * c + 8 * (j >> 1) + 2 * tq + (j & 1);
              if (col < p.Sk) p.pcode[(qrow + row) * p.Sk + col] = (uint8_t)(w[r] >> (8 * j));
            }
          }
        }
        if (c & 1) {  // the second half of a 32-key step: its product
          a[2] = w[0];
          a[3] = w[1];
#pragma unroll
          for (int n = 0; n < NA; ++n) {
            const uint8_t* bp = cT + (8 * n + g) * L::LDT + 16 * (c - 1);
            const uint32_t bf[2] = {*reinterpret_cast<const uint32_t*>(bp),
                                    *reinterpret_cast<const uint32_t*>(bp + 16)};
            int ic[4] = {0, 0, 0, 0};
            mma_u8s8(ic, a, bf);
            acc[n][0] = fmaf((float)ic[0], wv[0], acc[n][0]);
            acc[n][1] = fmaf((float)ic[1], wv[0], acc[n][1]);
            acc[n][2] = fmaf((float)ic[2], wv[1], acc[n][2]);
            acc[n][3] = fmaf((float)ic[3], wv[1], acc[n][3]);
          }
        } else {
          a[0] = w[0];
          a[1] = w[1];
        }
      }
      l[0] = fmaf((float)ps[0], wl[0], l[0]);  // Σ p̂ of the tile, exact
      l[1] = fmaf((float)ps[1], wl[1], l[1]);
    } else {
      // Pass 2: P = expf(s - m) against the final max; l sums bf16(P) at
      // D < 128 (read back from the packed A fragment) and the fp32 P at
      // D 128; P·V takes bf16(P) and the Ṽ tile.
      const __nv_bfloat16* cV = sVR + (i % 3) * BK * L::LDR;
#pragma unroll
      for (int c = 0; c < n_chunks; ++c) {
        float s[2][4];
        const unsigned vis = chunk(i, k0, c, edge, s);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool seen = !edge || ((vis >> (4 * jj + e)) & 1u);
            s[jj][e] = seen ? expf(s[jj][e] - m[e >> 1]) : 0.f;
          }
        uint32_t a[4];
        pack_a(a, s[0], s[1]);
#pragma unroll
        for (int r = 0; r < 4; ++r)  // a[r]: row r & 1 ? row1 : row0
          l[r & 1] += sum_rounded
                          ? __uint_as_float(a[r] << 16) + __uint_as_float(a[r] & 0xffff0000u)
                          : s[r >> 1][2 * (r & 1)] + s[r >> 1][2 * (r & 1) + 1];
#pragma unroll
        for (int dn = 0; dn < DP / 16; ++dn) {
          uint32_t b0[2], b1[2];
          load_b_kn(b0, b1, cV, L::LDR, c * 16, dn * 16, lane);
          mma_bf16(acc[2 * dn], a, b0);
          mma_bf16(acc[2 * dn + 1], a, b1);
        }
      }
    }
  }

  Tout* out = static_cast<Tout*>(p.out) + qrow * D;
  float* lse = p.lse + qrow;
  // PV, a row with no visible key: the reference codes every lane of each
  // chunk its query tile walks p̂ = 1 with β = 1, so its output is the mean
  // of code·sv over those lanes (+ vm), summed chunk by chunk in walk order,
  // rows past Sk coding 0 − vm in their chunk's scale (the pre-pass's rule),
  // and its LSE −1e30; none walked: exactly 0. The reference's tiles: its
  // (Tq, Tkv), or the map's; visible by its `_block_visible`.
  auto hidden_row = [&](int row) {
    const int tqr = SPARSE ? p.sm.bq : p.Tq, tkr = SPARSE ? p.sm.bk : p.Tkv;
    const int qt = row / tqr, qa = qt * tqr, qz = qa + tqr - 1;
    const float fq = (float)p.qmax_v;
    auto walked = [&](int ka) {
      if (p.right >= 0 && ka > qz + p.right) return false;
      if (p.left >= 0 && ka + tkr - 1 < qa - p.left) return false;
      if constexpr (SPARSE)
        return p.sm.map[b * p.sm.msb + h * p.sm.msh + (long long)qt * p.sm.nk + ka / tkr] !=
               MAP_SKIP;
      return true;
    };
    float hl = 0.f;
    for (int ka = 0; ka < p.Sk; ka += tkr)
      if (walked(ka)) hl += (float)tkr;
    // One column at a time (no register arrays beside acc).
    for (int ci = 0; ci < 2 * NA; ++ci) {
      const int col = 8 * (ci >> 1) + 2 * tq + (ci & 1);
      if (col >= D) continue;
      float o = 0.f;
      for (int ka = 0; ka < p.Sk; ka += tkr) {
        if (!walked(ka)) continue;
        for (int c0 = ka; c0 < ka + tkr; c0 += pvc) {
          const int real = min(pvc, max(p.Sk - c0, 0));
          int isum = 0;
          for (int j = 0; j < real; ++j) isum += p.vcode[(krow + c0 + j) * D + col];
          float sv = real ? p.vs[krow + c0] : 0.f;
          if (real < pvc) {
            float amax = 0.f;
            for (int j = 0; j < real; ++j) amax = fmaxf(amax, p.vst[krow + c0 + j]);
            for (int c = 0; c < D; ++c) amax = fmaxf(amax, fabsf(__fsub_rn(0.f, sVm[c])));
            amax = fmaxf(amax, 1e-12f);
            const float rcp = __fdiv_rn(fq, amax);
            if (!real) sv = __fdiv_rn(amax, fq);
            isum += (pvc - real) * (int)rintf(__fmul_rn(__fsub_rn(0.f, sVm[col]), rcp));
          }
          o = __fadd_rn(o, __fmul_rn((float)isum, sv));
        }
      }
      o = hl > 0.f ? o / hl : 0.f;
      if (smooth) o = hl > 0.f ? __fadd_rn(o, sVm[col]) : 0.f;
      Elem<Tout>::store(out, (long long)row * D + col, o);
    }
    if (tq == 0)
      lse[row] = hl > 0.f ? __fsub_rn(MASK_VALUE + logf(hl), LN_P_AMP) : MASK_VALUE;
  };
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i ? row1 : row0;
    const float lsum = quad_sum(l[i]);
    if (row >= p.Sq) continue;
    if constexpr (PV) {
      if (m[i] == MASK_VALUE) {
        hidden_row(row);
        continue;
      }
    }
    const bool empty = lsum == 0.f;
    const float l_safe = empty ? 1.f : lsum;
#pragma unroll
    for (int n = 0; n < NA; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * tq + e;
        if (col >= D) continue;
        float o = acc[n][2 * i + e] / l_safe;
        // The V-mean restore; rows with no visible key keep their exact 0.
        if (smooth) o = empty ? 0.f : __fadd_rn(o, sVm[col]);
        Elem<Tout>::store(out, (long long)row * D + col, o);
      }
    if constexpr (PV) {  // l in p̂ = A·p units: ln A comes back off the LSE
      if (tq == 0) lse[row] = empty ? MASK_VALUE : __fsub_rn(m[i] + logf(l_safe), LN_P_AMP);
    } else {
      if (tq == 0) lse[row] = empty ? MASK_VALUE : m[i] + logf(l_safe);
    }
  }
}

template <typename Tin, typename Tout, int DP, bool SPARSE, bool PV>
cudaError_t attend_walk(const FQParams& p, cudaStream_t stream) {
  constexpr int smem = FCfg<DP>::BYTES, bq = FCfg<DP>::BQ, nth = FCfg<DP>::NTH;
  const auto kernel = fused_qattn_tc_kernel<Tin, Tout, DP, SPARSE, PV>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + bq - 1) / bq, p.Hq, p.B);
  kernel<<<grid, nth, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename Tin, typename Tout, int DP>
cudaError_t attend(const FQParams& p, cudaStream_t stream) {
  if (p.flags & F_PV)
    return p.sm.map ? attend_walk<Tin, Tout, DP, true, true>(p, stream)
                    : attend_walk<Tin, Tout, DP, false, true>(p, stream);
  return p.sm.map ? attend_walk<Tin, Tout, DP, true, false>(p, stream)
                  : attend_walk<Tin, Tout, DP, false, false>(p, stream);
}

bool pre_pass(const FQParams& p) {
  return (p.flags & F_ASYM) || p.q_group || p.k_group || p.v_group;
}

template <typename Tin, typename Tout, int DP>
cudaError_t launch(const FQParams& p, cudaStream_t stream) {
  cudaError_t err;
  constexpr int ne = DP <= 128 ? 4 : 8;  // a row's elements a lane
  if (p.flags & (F_SMOOTH | F_SMOOTH_Q)) {
    if (p.kv_row0)
      fused_means_kernel<Tin, true><<<p.B * (p.Hq + p.Hkv), NTM, 0, stream>>>(p);
    else
      fused_means_kernel<Tin, false><<<p.B * (p.Hq + p.Hkv), NTM, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const long long kv_rows = 2LL * p.B * p.Hkv * p.Sk;
  const bool pre = pre_pass(p);
  if (pre) {
    const long long rows = ((p.flags & F_Q_DENSE) ? 0 : (long long)p.B * p.Hq * p.Sq) + kv_rows;
    const unsigned blocks = (unsigned)((rows + KV_WARPS - 1) / KV_WARPS);
    fused_rows_kernel<Tin, ne><<<blocks, KV_WARPS * 32, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((p.flags & F_PV) && (p.flags & F_V_INT4))
      fused_group_quant_kernel<ne, true><<<blocks, KV_WARPS * 32, 0, stream>>>(p);
    else
      fused_group_quant_kernel<ne><<<blocks, KV_WARPS * 32, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  } else if (kv_rows) {
    fused_kv_quant_kernel<Tin, ne>
        <<<(unsigned)((kv_rows + KV_WARPS - 1) / KV_WARPS), KV_WARPS * 32, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if ((p.flags & F_SMOOTH_Q) && p.Sk > 0) {
    constexpr int ck = cc_keys<DP>();
    const dim3 cc_grid((p.Sk + ck - 1) / ck, p.Hkv, p.B);
    fused_cc_kernel<DP><<<cc_grid, NTM, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  FQParams a = p;
  if (pre)  // V's rows' statistics, after Q's (an integer Q) and K's
    a.vst = p.st + ((p.flags & F_Q_DENSE) ? 0 : (long long)p.B * p.Hq * p.Sq) + kv_rows / 2;
  if (pre && !(p.flags & F_Q_DENSE)) {
    // The pre-pass quantized Q: the attention reads qb as a dense bf16 Q
    // whose values already carry the softmax scale (times 1, unrotated).
    a.q = p.qb;
    a.flags = (p.flags & ~F_HADAMARD) | F_Q_DENSE;
    a.scale = 1.f;
    a.qv = nullptr;
    a.qs = nullptr;
    return attend<__nv_bfloat16, Tout, DP>(a, stream);
  }
  return attend<Tin, Tout, DP>(a, stream);
}

template <typename Tin, typename Tout>
cudaError_t launch_d(const FQParams& p, cudaStream_t stream) {
  if (p.D <= 64) return launch<Tin, Tout, 64>(p, stream);
  if (p.D <= 128) return launch<Tin, Tout, 128>(p, stream);
  return launch<Tin, Tout, 256>(p, stream);
}

// How bf16 rows of D elements starting at ptr are copied (`copy_rows`).
int copy_mode(const void* ptr, int D) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(ptr);
  return D % 8 == 0 && a % 16 == 0 ? 2 : D % 2 == 0 && a % 4 == 0 ? 1 : 0;
}

// How int8 rows of D codes starting at ptr are copied (`copy_codes`).
int code_mode(const void* ptr, int D) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(ptr);
  return D % 16 == 0 && a % 16 == 0 ? 2 : D % 4 == 0 && a % 4 == 0 ? 1 : 0;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. q (B, Hq, Sq, D), k/v
// (B, Hkv, Sk, D) contiguous in in_dtype, D <= 256; bias float32 with
// element strides (or null); out (B, Hq, Sq, D) in out_dtype, lse
// (B, Hq, Sq) float32. K/V codes kv/vv (B, Hkv, Sk, D), or (B, Hkv, Sk,
// D/2) packed INT4, and float32 scales ks/vs (B, Hkv, Sk): always written
// (the residuals, or scratch). The Q residual qv/qs likewise for an integer
// Q, or null. Means (float32): qm (B, Hq, D) with SMOOTH_Q, km and vm
// (B, Hkv, D) with SMOOTH, written by this call; cc (B, Hq, Sk) float32
// scratch with SMOOTH_Q; kb and vb (B, Hkv, Sk, D) bfloat16 scratch.
// ASYM (flag 16): int32 zero points kzp/vzp (B, Hkv, Sk), and qzp
// (B, Hq, Sq) with qv. BLOCK (a group > 0) or ASYM: ys (rows, D) and st
// (2, rows) float32 scratch, rows = B·Hq·Sq (0 for a dense Q) + 2·B·Hkv·Sk,
// and qb (B, Hq, Sq, D) bfloat16 scratch for an integer Q. map (null: no
// walk): the block-sparse map (Bm, Hm, nq, nk) int32 of block_q x block_k
// tiles and fetch, its compacted key-tile table fetch_kv (Bm, Hm, nq,
// width), with the element strides of their batch and head (0 =
// broadcast); kv_row0 (B, Hkv) int32 or null: the first row of each K/V
// mean window (Tkv rows, zero past Sk). PV (flag 256, symmetric, v_group
// = pv_chunk > 0): ml (B, Hq, Sq, ceil(Sk / v_group)) float32 scratch set to
// -1e30 (the chunk maxima), vcode
// (B, Hkv, Sk, D) int8, V's unpacked codes (vv itself at INT8, else
// scratch), pcode (B, Hq, Sq, Sk) uint8 or null: the P codes of the lanes
// whose chunk counts (β > 0), for checks (the others are not written).
// Returns the cudaError_t of the launches.
extern "C" int umfa_fused_qattn(const void* q, const void* k, const void* v, const void* bias,
                                void* out, void* lse, void* qv, void* qs, void* kv, void* ks,
                                void* vv, void* vs, void* qm, void* km, void* vm, void* cc,
                                void* kb, void* vb, void* qzp, void* kzp, void* vzp, void* ys,
                                void* st, void* qb, int B,
                                int Hq, int Hkv, int Sq, int Sk, int D, long long bsb,
                                long long bsh, long long bsq, long long bsk, float scale, int left,
                                int right, int flags, int qmax_q, int qmax_k, int qmax_v, int Tq,
                                int Tkv, int q_group, int k_group, int v_group, int in_dtype,
                                int out_dtype, const void* map, const void* fetch, int block_q,
                                int block_k, int nq, int nk, int width, long long msb,
                                long long msh, long long fsb, long long fsh, const void* kv_row0,
                                void* ml, void* vcode, void* pcode, void* stream) {
  const bool int4 = flags & (F_Q_INT4 | F_K_INT4 | F_V_INT4);
  const bool asym = flags & F_ASYM, dense = flags & F_Q_DENSE;
  const bool pre = asym || q_group || k_group || v_group;
  if (D < 1 || D > MAXD || Hkv < 1 || Hq % Hkv != 0 || in_dtype < 0 || in_dtype > 1 ||
      out_dtype < 0 || out_dtype > 1 || (int4 && D % 2) ||
      ((flags & F_HADAMARD) && (D & (D - 1))) || Tq < 1 || Tkv < 1 ||
      ((flags & F_SMOOTH) && (!km || !vm)) || ((flags & F_SMOOTH_Q) && (!qm || !cc)) || !kv ||
      !ks || !vv || !vs || !kb || !vb || (!qv != !qs) || q_group < 0 || k_group < 0 ||
      v_group < 0 || (asym && (!kzp || !vzp || (!qv != !qzp))) ||
      (pre && (!ys || !st || (!dense && !qb))) ||
      ((flags & F_PV) && (asym || v_group < 1 || !ml || !vcode)))
    return cudaErrorInvalidValue;
  SparseMap sm;
  if (!sparse_map(&sm, map, fetch, block_q, block_k, nq, nk, width, msb, msh, fsb, fsh))
    return cudaErrorInvalidValue;
  const FQParams p{q, k, v, static_cast<const float*>(bias), out, static_cast<float*>(lse),
                   static_cast<int8_t*>(qv), static_cast<float*>(qs), static_cast<int8_t*>(kv),
                   static_cast<float*>(ks), static_cast<int8_t*>(vv), static_cast<float*>(vs),
                   static_cast<float*>(qm), static_cast<float*>(km), static_cast<float*>(vm),
                   static_cast<float*>(cc), static_cast<__nv_bfloat16*>(kb),
                   static_cast<__nv_bfloat16*>(vb), static_cast<int*>(qzp),
                   static_cast<int*>(kzp), static_cast<int*>(vzp), static_cast<float*>(ys),
                   static_cast<float*>(st), static_cast<__nv_bfloat16*>(qb),
                   B, Hq, Hkv, Sq, Sk, D, bsb, bsh, bsq, bsk, scale, left, right,
                   flags, qmax_q, qmax_k, qmax_v, Tq, Tkv, q_group, k_group, v_group,
                   // The rotation's entries: fp32(D^-1/2), as the host's hadamard_matrix.
                   (float)pow((double)D, -0.5),
                   copy_mode(kb, D) < copy_mode(vb, D) ? copy_mode(kb, D) : copy_mode(vb, D),
                   sm, static_cast<const int*>(kv_row0), static_cast<float*>(ml),
                   static_cast<int8_t*>(vcode), static_cast<uint8_t*>(pcode), nullptr,
                   code_mode(vcode, D)};
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0)
    return out_dtype == 0 ? launch_d<float, float>(p, strm)
                          : launch_d<float, __nv_bfloat16>(p, strm);
  return out_dtype == 0 ? launch_d<__nv_bfloat16, float>(p, strm)
                        : launch_d<__nv_bfloat16, __nv_bfloat16>(p, strm);
}

// Dynamic shared memory of the attention kernel that umfa_fused_qattn
// launches for head dim D, in bytes (0 if it does not take D).
extern "C" int umfa_fused_qattn_smem_bytes(int D) {
  if (D < 1 || D > MAXD) return 0;
  return D <= 64 ? FCfg<64>::BYTES : D <= 128 ? FCfg<128>::BYTES : FCfg<256>::BYTES;
}
