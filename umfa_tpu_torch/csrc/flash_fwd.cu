// Dense flash-attention forward (out + LSE) for Hopper, sm_90a.
//
// Replaces umfa_tpu/ops/flash_fwd.py:296 `_fwd_kernel` (host
// `flash_attention_forward`, flash_fwd.py:762), with its block-sparse walk
// (:340-357) and its in-kernel rotate-half RoPE (:284-293, :374-378,
// :425-431). The tensor-core body of fwd_tc.cuh
// (`fwd_tc_kernel`), with the product policy chosen by the input dtype:
//   * bf16 inputs: `Bf16Mma`, mma.sync m16n8k16 bf16 -> fp32, D <= 256;
//   * fp32 inputs (fp16 arrives promoted to fp32): `Tf32x3Mma`, both
//     products as three mma.sync m16n8k8 tf32 on operands split into tf32
//     big and small parts (never fp32 in one TF32 pass, which would miss
//     the fp32 gate of 2e-5), D <= 256 (at 256, 8 warps on 128 query rows
//     and 16-key tiles: fwd_tc.cuh `FwdTile`).
// Head dims are zero-padded in shared memory to the template width (64,
// 128, 256). Above 256 the wide bodies of wide_tc.cuh run instead (two
// launches: the row-max pass, then the column slices; dense walk only: a
// map or RoPE tables are refused there).
//
// What bounds it on this card: at the serving prefill (B8 Hq16 Hkv8, 4032
// causal queries against 4096 keys, D 64) the work is 4·D flops per visible
// (query, key) pair, 2.66e11 flop, against ~0.07 GB of Q/K/V/out read or
// written once (bf16): operation-bound, 0.269 ms at 989 TFLOP/s bf16
// against ~0.02 ms of HBM time; in fp32 the floor is three TF32 products
// for each fp32 one, 1.61 ms at 495 TFLOP/s (6.45 ms at D 256). With RoPE
// at the FLUX geometry (B1 H24 S4608 D128, non-causal) 2.61e11 flop, 0.264
// ms; the rotation adds 3 flop an element of Q and K and the tables' bytes
// once (2.4 MB): still operation-bound.
//
// What the design does about it (fwd_tc.cuh): the FA2 shape on mma.sync,
// 4 warps x 16 query rows (fp32 D 256: 8 warps), Q in registers as A
// fragments at bf16 D <= 128 (fp32: loaded and split at each use), K/V
// tiles double-buffered by cp.async (bf16 64 keys, fp32 32, fp32 D 256 16),
// P from the S accumulators. The running max
// starts from the row max of the first 512 visible keys, found in a K-only
// pre-pass (a quarter more Q·Kᵀ at the prefill shape): a row that sees at
// most 512 keys rounds P against its final max, as the plain version does,
// and a longer one rounds against a running max only past its first 512
// keys. Without it, P rounded against the max of each row's first 64 keys
// put the bf16 LSE of short causal rows up to 1.15e-3 from the plain
// version's at the serving prefill, over its 1e-3 gate. With a bias the
// pre-pass takes every visible tile (the bias read twice, the Q·Kᵀ work
// doubled): a bias can hide all of a row's first 512 keys and keep later
// ones (the MLA indexer's top-128), and then only the final max rounds P
// as the plain version does.
// Left for later PRs: wgmma (the only way to the full tensor-core rate),
// TMA loads with mbarriers, warp specialisation (a producer warp), and a
// persistent grid that overlaps one tile's epilogue with the next loads.
//
// Semantics held to the reference:
//   * the softmax scale is folded into Q once and Q is rounded back to the
//     input type (the TPU kernel's q scratch): Q·scale in fp32 for fp32;
//   * P is rounded to the input type before P·V (bf16; fp32 P is not
//     rounded), against the running max (seeded by the pre-pass) of the
//     kernel's own key tiles; the row sum l adds the rounded P at D < 128
//     (the reference's ones-column row sum) and the fp32 P at D >= 128 (its
//     VPU row sum: it has no ones column there);
//   * index masking (causal, window, KV tail) sets the score to -1e30 and
//     zeroes P; a -1e30 *bias* is not an index mask (a row masked by bias
//     alone averages uniformly); a row with no visible key outputs exactly
//     0 with LSE -1e30;
//   * GQA: q head h reads kv head h / (Hq / Hkv);
//   * bias: FP32, any broadcast shape, given as four element strides
//     (0 = broadcast dimension);
//   * block-sparse (a map given): key j is walked by query i iff the map
//     tile (i / block_q, j / block_k) is not SKIP; unwalked keys are hidden
//     like index-masked ones, and a row whose walked keys all carry a -1e30
//     bias averages V over exactly those keys. The walk is the body's
//     SPARSE instantiation (fwd_tc.cuh), the compacted row fetch_kv of the
//     block's map query tile; the bias is read only on tiles that are not
//     FULL. A simple walk: the map's tiles are walked in full where the
//     mask leaves part of them empty, and nothing is fused across tiles;
//   * RoPE (angle tables given): the body's ROPE instantiation rotates Q
//     (rotate-half, fp32) as it stages it, then scales and rounds it once,
//     and each K tile in shared memory after its copy lands, rounded to
//     K's type; not with a map. A simple rotation: each K tile is rotated
//     every time it is staged (by every query tile of its head, the
//     pre-pass's tiles again in the main walk), its table rows read from
//     L2 (16-byte loads of 4 pairs where D % 8 == 0, several in flight),
//     with one more barrier a step. In bf16 the tables are as many bytes
//     as the K and V tiles they rotate; the pass sits between two barriers.
#include "fwd_tc.cuh"
#include "wide_tc.cuh"

using namespace umfa;

namespace {

template <typename Tout, bool SPARSE, bool ROPE>
cudaError_t launch_d(const FwdParams& p, bool bf16, cudaStream_t stream) {
  if (bf16) {
    if (p.D <= 64) return launch_fwd_tc<Bf16Mma, Tout, 64, false, SPARSE, ROPE>(p, stream);
    if (p.D <= 128) return launch_fwd_tc<Bf16Mma, Tout, 128, false, SPARSE, ROPE>(p, stream);
    return launch_fwd_tc<Bf16Mma, Tout, 256, false, SPARSE, ROPE>(p, stream);
  }
  if (p.D <= 64) return launch_fwd_tc<Tf32x3Mma, Tout, 64, false, SPARSE, ROPE>(p, stream);
  if (p.D <= 128) return launch_fwd_tc<Tf32x3Mma, Tout, 128, false, SPARSE, ROPE>(p, stream);
  return launch_fwd_tc<Tf32x3Mma, Tout, 256, false, SPARSE, ROPE>(p, stream);
}

template <typename Tout>
cudaError_t launch_walk(const FwdParams& p, bool bf16, cudaStream_t stream) {
  if (p.rope_cos) return launch_d<Tout, false, true>(p, bf16, stream);
  return p.sm.map ? launch_d<Tout, true, false>(p, bf16, stream)
                  : launch_d<Tout, false, false>(p, bf16, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. q/k/v contiguous (B, H, S, D);
// bfloat16 inputs run the tensor-core body in bf16, float32 inputs in
// 3xTF32. At D > 256 the wide forward runs (two launches) and needs
// `scratch`, (B, Hq, Sq) float32 for the row max; no map, no RoPE there.
// out (B, Hq, Sq, D) in out_dtype; lse (B, Hq, Sq) float32. map (null: no walk): the block-sparse map (Bm, Hm, nq, nk) int32
// of block_q x block_k tiles and fetch, its compacted key-tile table
// fetch_kv (Bm, Hm, nq, width), with the element strides of their batch
// and head (0 = broadcast). rope_cos/rope_sin (null: no RoPE): the
// rotate-half angle tables, fp32 (>= max(Sq, Sk), D/2), D even, no map.
// Returns the cudaError_t of the launch.
extern "C" int umfa_flash_fwd(const void* q, const void* k, const void* v, const void* bias,
                              void* out, void* lse, int B, int Hq, int Hkv, int Sq, int Sk,
                              int D, long long bsb, long long bsh, long long bsq,
                              long long bsk, float scale, int left, int right, int in_dtype,
                              int out_dtype, const void* map, const void* fetch, int block_q,
                              int block_k, int nq, int nk, int width, long long msb,
                              long long msh, long long fsb, long long fsh,
                              const void* rope_cos, const void* rope_sin, void* scratch,
                              void* stream) {
  SparseMap sm;
  if (D > 256) {  // the wide forward: dense walk only
    if (Hkv < 1 || Hq % Hkv != 0 || in_dtype < 0 || in_dtype > 1 || out_dtype < 0 ||
        out_dtype > 1 || map != nullptr || rope_cos != nullptr || rope_sin != nullptr ||
        scratch == nullptr)
      return cudaErrorInvalidValue;
    WideParams w{};
    w.q = q;
    w.k = k;
    w.v = v;
    w.lse = static_cast<float*>(lse);
    w.bias = static_cast<const float*>(bias);
    w.mrow = static_cast<float*>(scratch);
    w.out0 = out;
    w.B = B;
    w.Hq = Hq;
    w.Hkv = Hkv;
    w.Sq = Sq;
    w.Sk = Sk;
    w.D = D;
    w.bsb = bsb;
    w.bsh = bsh;
    w.bsq = bsq;
    w.bsk = bsk;
    w.scale = scale;
    w.left = left;
    w.right = right;
    w.vec = wide_vec(D, in_dtype == 1 ? 2 : 4, {q, k, v});
    w.out_bf16 = out_dtype == 1;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return in_dtype == 1 ? launch_fwd_wide<Bf16Mma>(w, st) : launch_fwd_wide<Tf32x3Mma>(w, st);
  }
  if (D < 1 || Hkv < 1 || Hq % Hkv != 0 || in_dtype < 0 || in_dtype > 1 ||
      out_dtype < 0 || out_dtype > 1 ||
      !sparse_map(&sm, map, fetch, block_q, block_k, nq, nk, width, msb, msh, fsb, fsh))
    return cudaErrorInvalidValue;
  if ((rope_cos == nullptr) != (rope_sin == nullptr) ||
      (rope_cos && (D % 2 != 0 || map != nullptr)))
    return cudaErrorInvalidValue;
  const int per16 = in_dtype == 1 ? 8 : 4;  // elements a 16-byte copy
  const int vec = D % per16 == 0 && ((reinterpret_cast<uintptr_t>(k) |
                                      reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  FwdParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
  p.bsb = bsb;
  p.bsh = bsh;
  p.bsq = bsq;
  p.bsk = bsk;
  p.scale = scale;
  p.left = left;
  p.right = right;
  p.vec = vec;
  p.sm = sm;
  p.rope_cos = static_cast<const float*>(rope_cos);
  p.rope_sin = static_cast<const float*>(rope_sin);
  p.rope_vec = D % 8 == 0 && ((reinterpret_cast<uintptr_t>(rope_cos) |
                               reinterpret_cast<uintptr_t>(rope_sin)) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf16 = in_dtype == 1;
  return out_dtype == 0 ? launch_walk<float>(p, bf16, st) : launch_walk<__nv_bfloat16>(p, bf16, st);
}

// Dynamic shared memory of the kernel that umfa_flash_fwd launches for
// head dim D and input dtype `in_dtype`, in bytes (0 if none takes D).
extern "C" int umfa_flash_fwd_smem_bytes(int D, int in_dtype) {
  if (D < 1) return 0;
  if (D > 256) {  // the column-slice pass (the row-max pass takes less)
    int plan[5];
    wide_plan(D, 0, in_dtype == 1, plan);
    return plan[4];
  }
  if (in_dtype == 1)
    return D <= 64    ? FwdTile<64, Bf16Mma, false>::SMEM
           : D <= 128 ? FwdTile<128, Bf16Mma, false>::SMEM
                      : FwdTile<256, Bf16Mma, false>::SMEM;
  return D <= 64    ? FwdTile<64, Tf32x3Mma, false>::SMEM
         : D <= 128 ? FwdTile<128, Tf32x3Mma, false>::SMEM
                    : FwdTile<256, Tf32x3Mma, false>::SMEM;
}

// The plan of the wide body `kind` (0: forward, 1: dQ, 2: dK/dV) at head
// dim D on bf16 (bf16 = 1) or fp32 inputs: out[0..4] = depth chunk,
// chunks, slice width, slices, dynamic shared memory in bytes.
extern "C" void umfa_flash_wide_plan(int D, int kind, int bf16, int* out) {
  wide_plan(D, kind, bf16, out);
}
