"""Single-launch runtime-quantized attention (port of
umfa_tpu/ops/quant_fused_attn.py `fused_quantize_attend`).

`fused_quantize_attend` launches the CUDA kernel `csrc/fused_qattn.cu` on
CUDA tensors and runs `fused_quantize_attend_plain`, the same arithmetic in
plain PyTorch, on CPU tensors; no fallback between them.

Arithmetic, at the TPU kernel's rounding points (quant_fused_attn.py:100-828):
  * Q and K are rotated by x·H in fp32 when `hadamard` (V never is);
  * smoothing means are the reference's in-kernel estimates, not the true
    sequence means: the sum of the first min(T, S) rows over T, T being the
    reference's own first tile (`default_mean_rows`); km and vm per KV
    head, qm per query head; qm only with `smooth_q` and an integer Q;
    with a block-sparse map T is the map's tile (block_q, block_k), and K
    and V are estimated over the block_k rows of the tile each map slice
    fills first (`fill_kv`'s flag 2; rows past Sk count as zeros), so the
    window depends on the map, per batch where the map is; Q's stays
    q-block 0;
  * a row quantizes as x − mean, absmax = max(|x|, 1e-12), scale =
    absmax / qmax, code = round_half_even(x · (qmax / absmax)), no clip;
  * BLOCK: one absmax per group of rows (the reference's `_segment_stat`),
    the group the request floored to a power of two (at least 8) and
    clamped until it divides the reference's tile (`effective_group`);
    the rows past S that complete the last group are the reference's
    zero-padded tile rows, x = 0 − mean, and count in its statistic;
  * ASYMMETRIC (quant_fused_attn.py:171-193): hi and lo per row (or
    group), scale = max(hi − lo, 1e-12) / (2·qmax + 1), zp =
    round(−lo / scale) − (qmax + 1) (not clipped), code = clip(round(x /
    scale) + zp, −qmax − 1, qmax), exact divisions; deq = (code − zp)·scale;
  * dequantized operands are bf16: bf16(deq_q·sq·scale) (softmax scale
    folded in), bf16(deq_k), bf16(deq_v), deq = code·scale symmetric; a
    dense Q is bf16(q_rot·scale);
  * with `smooth_q` the score row gets cc = (bf16(qm)·k_bf)·scale, then the
    bias; index masking (causal, window, KV tail) sets −1e30;
  * the means, q_bf·k_bf and the cc row are summed in float64 and rounded
    once to fp32 (the kernel does the same), so kernel and plain version
    see the same fp32 values;
  * P = exp(S − m) against the row max, P·V on bf16(P); the row sum l adds
    bf16(P) at D < 128 (the reference's ones column) and the fp32 P at
    D ≥ 128;
  * out = acc / l + vm, except rows with l == 0: exactly 0, LSE −1e30;
  * a block-sparse map (ops/flash_fwd.py `Walk`) hides the keys outside a
    row's walked tiles like index-masked ones, the BlockMask's tiling as on
    the dense path; the kernel walks `fetch_kv`. K and V are quantized on
    every row (the reference writes residuals only for the tiles it fills:
    the values of walked tiles agree, the others are read by nothing).
The reference walks KV tiles with an online softmax and so rounds P
against a running max where it walks more than one tile; this port (kernel
and plain version) rounds against the final row max (ROADMAP §3).

`pv_int8`, the integer P·V (quant_fused_attn.py:391-411, :552-601,
:823-828): V is quantized per `pv_chunk` rows (the reference's
`min(256, block_k)`, halved until it divides its KV tile; one symmetric
scale over the chunk's rows of v − vm, rows past Sk counted as 0 − vm),
and its residual is BLOCK with that group. Each row quantizes P in each
absolute pv_chunk of keys against that chunk's own max ml (taken over
every lane, masked ones at −1e30 included): p̂ = rint(exp(s − (ml −
fp32(ln 255.49)))) in [0, 255]; l = Σ_c β_c·Σ p̂ and acc = Σ_c (the exact
integer Σ p̂·v_code)·(β_c·sv_c) with β_c = exp(ml_c − m), m the final row
max; out = acc / l + vm, LSE = m + log l − ln 255.49. A row that sees no
key has m = −1e30, so in the reference every lane of every chunk it walks
codes p̂ = 1 with β = 1: its output is the mean of the dequantized V over
the lanes of the key tiles its query tile walks (rows past Sk of the last
tile included, as 0 − vm quantized), plus vm, and its LSE −1e30; the port
reproduces that from the reference's tiles (`mean_rows`, or the map's).

Supported: ROW or BLOCK granularity, SYMMETRIC or ASYMMETRIC, INT8 or INT4
per operand, a dense Q, smoothing, Hadamard, bias, causal/window, GQA,
block-sparse maps, `pv_int8` (symmetric), D ≤ 256, fp32/bf16/fp16 inputs.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import NamedTuple, Optional

import torch

from umfa_tpu_torch import _kernels
from umfa_tpu_torch.engine.config import BlockSizeConfig, Precision, QuantMode, QuantStrategy
from umfa_tpu_torch.ops.flash_fwd import (
    DEFAULT_MASK_VALUE,
    WALK_ARGTYPES,
    Walk,
    _DTYPE_CODE,
    _check_walk,
    _choose_block,
    bias_strides,
    broadcast_bias,
    fold_mask,
    make_walk,
    refuse_wide,
    visible_mask,
    walk_args,
    walked_keys,
)
from umfa_tpu_torch.ops.quant import QuantizedTensor, _qmax, pack_int4
from umfa_tpu_torch.ops.quant_fused import rotate

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# q k v bias out lse | qv qs kv ks vv vs qm km vm cc kb vb | qzp kzp vzp ys st
# qb | B Hq Hkv Sq Sk D | bsb bsh bsq bsk | scale left right | flags qmax_q
# qmax_k qmax_v Tq Tkv | q_group k_group v_group | in out | the walk
# (WALK_ARGTYPES) | kv_row0 | ml vcode pcode | stream
_ARGTYPES = (*(_P,) * 24, *(_I,) * 6, *(_L,) * 4, ctypes.c_float, _I, _I,
             *(_I,) * 6, *(_I,) * 3, _I, _I, *WALK_ARGTYPES, _P, _P, _P, _P, _P)

# Flag bits of the C entry point.
_F_HADAMARD, _F_SMOOTH, _F_SMOOTH_Q, _F_Q_DENSE, _F_ASYM = 1, 2, 4, 8, 16
_Q_INT4, _K_INT4, _V_INT4, _F_PV = 32, 64, 128, 256

# ln of the integer P·V's amplitude, as the reference's fp32 constant
# (quant_fused_attn.py:96-97): p̂ = round(exp(s − ml + ln A)) = round(A·p).
LN_P_AMP = torch.tensor(math.log(255.49), dtype=torch.float32).item()


def pv_chunk_of(block_k: int) -> int:
    """The reference's integer P·V chunk (quant_fused_attn.py:973-975):
    min(256, block_k), halved until it divides its KV tile block_k."""
    c = min(256, int(block_k))
    while c and block_k % c:
        c //= 2
    return c


def require_symmetric_pv(config) -> None:
    """ASYMMETRIC with pv_int8 is refused, where the reference asserts
    (quant_attention.py:727-731): the integer P·V needs a symmetric V."""
    if config.pv_int8 and config.strategy == QuantStrategy.ASYMMETRIC:
        raise ValueError("pv_int8 requires symmetric quantization")


def fused_path_supported(config, seq_k: int, head_dim: int, *, causal: bool, window,
                         seq_q: int, block_map=None, fetch_kv=None, hold_kv=None, fill_kv=None,
                         num_heads: Optional[int] = None, num_kv_heads: Optional[int] = None,
                         bias_grad: bool = False) -> bool:
    """Whether the single-launch route serves this call, by the reference's
    rules (quant_fused_attn.py:1374-1440). `UMFA_DISABLE_FUSED_QUANT=1`
    (read on each call) sends the call to the two-pass route. With a
    block-sparse map it takes the whole compacted schedule (`fetch_kv`,
    `hold_kv`, `fill_kv`), no `bias_grad`, and no per-head map (Hm > 1)
    under GQA; `fetch_kv` without a map goes two-pass. pv_int8 with
    ASYMMETRIC goes two-pass, as in the reference (which refuses it there)."""
    if os.environ.get("UMFA_DISABLE_FUSED_QUANT", "0") == "1":
        return False
    if config.mode not in (QuantMode.ROW, QuantMode.BLOCK):
        return False
    if not (config.k_precision.is_integer and config.v_precision.is_integer):
        return False
    if Precision.INT4 in (config.q_precision, config.k_precision,
                          config.v_precision) and head_dim % 2:
        return False
    if config.pv_int8 and config.strategy == QuantStrategy.ASYMMETRIC:
        return False  # integer P·V needs a symmetric V: the two-pass route
    if block_map is not None:
        # The reference's reasons: a non-leader GQA head reading tiles a
        # per-head leader never filled, and a bias gradient dequantizing
        # residual tiles never written. The card has neither problem; the
        # rules stay because the route decides the numbers.
        if fetch_kv is None or hold_kv is None or fill_kv is None or bias_grad:
            return False
        if (num_heads is not None and num_kv_heads is not None
                and num_heads != num_kv_heads and block_map.shape[1] > 1):
            return False
    elif fetch_kv is not None:
        return False
    # On the TPU this is the VMEM budget of the K/V caches (long KV, about
    # Sk > 10240 at D <= 128, goes two-pass), and the fill schedule assumes
    # self-attention geometry when the right side is bounded. The card has
    # neither limit; the rules stay because the two routes compute different
    # values (estimated tile-0 means and per-tile rounding here, true means
    # there), so the route decides which numbers a call gets.
    lanes = max(head_dim, 128)
    s_pad = ((seq_k + 2047) // 2048) * 2048
    if s_pad * lanes * 4 + 2 * 8 * s_pad * 4 > 6 * 2**20:  # the reference's VMEM budget
        return False
    if _right_bound(causal, window) is not None and seq_q != seq_k:
        return False
    return True


def _right_bound(causal: bool, window) -> Optional[int]:
    r = 0 if causal else None
    if window is not None and window[1] >= 0:
        r = window[1] if r is None else min(r, window[1])
    return r


def effective_group(requested: int, tile: int) -> int:
    """The BLOCK group of the reference (`_grp`, quant_fused_attn.py:
    982-1000): the request floored to a power of two (at least 8), clamped
    to the tile and halved until it divides it."""
    g = 1 << (max(8, int(requested)).bit_length() - 1)
    g = min(g, tile)
    while tile % g:
        g //= 2
    return g


def default_mean_rows(seq_q: int, seq_k: int, head_dim: int, *, causal: bool, window,
                      has_bias: bool, pv_int8: bool = False) -> tuple:
    """(T_q, T_kv): the reference's first Q and K/V tiles at its default
    BlockSizes (quant_fused_attn.py:918-946), over which it estimates the
    smoothing means (tile zero-padded: sum of min(T, S) rows, over T).
    Causal at S = 4096, D = 64 gives (2048, 1024), (1024, 1024) with
    pv_int8; S = 256 gives (256, 256)."""
    masked = causal or window is not None
    block_k = _choose_block(1024 if masked else 2048, seq_k, head_dim)
    block_q = _choose_block(1024 if masked else 2048, seq_q, head_dim)
    # Rectangular causal mode (flash_fwd.py:262-281): plain causal, no bias,
    # aligned KV tail, Sq divisible by the doubled q tile; never with
    # pv_int8 (quant_fused_attn.py:944).
    if (causal and window is None and not has_bias and not pv_int8 and seq_k % block_k == 0
            and seq_q % (2 * block_k) == 0):
        block_q = 2 * block_k
    return block_q, block_k


class _Prepared(NamedTuple):
    q: torch.Tensor     # (B, Hq, Sq, D) fp32 or bf16, contiguous
    k: torch.Tensor     # (B, Hkv, Sk, D), q's dtype
    v: torch.Tensor
    bias: Optional[torch.Tensor]  # fp32 view expanded to (B, Hq, Sq, Sk)
    scale: float
    left: int
    right: int
    smooth: bool
    smooth_q: bool
    hadamard: bool
    emit: bool
    q_precision: Precision
    k_precision: Precision
    v_precision: Precision
    t_q: int
    t_kv: int
    asym: bool
    groups: tuple            # (q, k, v) BLOCK groups in rows, 0 = ROW
    out_dtype: torch.dtype   # what the kernel writes (fp32 or bf16)
    final_dtype: torch.dtype  # what the caller gets (fp16 cast last)
    orig_dtypes: tuple
    walk: Optional[Walk]
    kv_row0: Optional[torch.Tensor]  # (B, Hkv) int32: the first row of each K/V mean window
    pv_chunk: int = 0        # pv_int8: keys a chunk (V's group, groups[2]); 0 = bf16 P·V


def first_fill_tiles(fetch_kv: torch.Tensor, fill_kv: torch.Tensor) -> torch.Tensor:
    """(Bm, Hm) int32: the key tile of each slice's first fill (the entry of
    `fetch_kv` where `fill_kv` is 2), -1 where a slice fills none; a
    BlockMask carries it as `kv_mean_tile`, found on the host."""
    bm, hm = fill_kv.shape[:2]
    first = (fill_kv == 2).reshape(bm, hm, -1)
    at = first.int().argmax(dim=-1, keepdim=True)
    tile = fetch_kv.reshape(bm, hm, -1).gather(-1, at)[..., 0]
    return torch.where(first.any(dim=-1), tile, -1).to(torch.int32)


def kv_mean_rows(walk: Walk, b: int, hkv: int, group: int) -> torch.Tensor:
    """(B, Hkv) int32, on the map's device: the first row of the block_k
    rows each KV head's K and V means are estimated over, the tile its map
    slice fills first (the reference's flag 2, `fill_kv`): the slice of
    batch b and of the group's leader head hk·group, which fills the
    reference's cache. A slice that fills nothing (no row sees a key)
    takes tile 0; nothing reads its means."""
    tile = walk.kv_mean_tile
    if tile.shape[1] > 1:
        tile = tile[:, torch.arange(hkv, device=tile.device) * group]
    rows = tile.clamp_min(0).to(torch.int32) * walk.block_k
    return rows.expand(b, hkv).contiguous()


def _prepare(q, k, v, bias, causal, window, scale, smooth, smooth_q, hadamard, emit,
             q_precision, k_precision, v_precision, out_dtype, mean_rows, strategy, mode,
             quant_blocks, walk: Optional[Walk], pv_int8: bool = False) -> _Prepared:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, S, D)")
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"q heads {hq} must be a multiple of kv heads {hkv}")
    for name, p in (("k", k_precision), ("v", v_precision)):
        if not p.is_integer:
            raise ValueError(f"{name}_precision must be INT8 or INT4, got {p}")
    if Precision.INT4 in (q_precision, k_precision, v_precision) and d % 2:
        raise ValueError("INT4 operands need an even head_dim")
    if hadamard and d & (d - 1):
        raise ValueError(f"the Hadamard rotation needs a power-of-two head_dim, got {d}")
    if mode not in (QuantMode.ROW, QuantMode.BLOCK):
        raise ValueError(f"the single-launch kernel quantizes ROW or BLOCK, got {mode}")
    if pv_int8 and strategy == QuantStrategy.ASYMMETRIC:
        raise ValueError("pv_int8 requires symmetric quantization")
    orig_dtypes = (q.dtype, k.dtype, v.dtype)
    # fp16 is storage-only: read as fp32 (the TPU kernel's f32 tiles).
    q, k, v = (x.float() if x.dtype == torch.float16 else x for x in (q, k, v))
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"unsupported dtypes q={q.dtype} k={k.dtype} v={v.dtype}")
    final = out_dtype or orig_dtypes[0]
    kernel_out = torch.float32 if final == torch.float16 else final
    if kernel_out not in _DTYPE_CODE:
        raise ValueError(f"unsupported out_dtype {out_dtype}")
    q_dense = not q_precision.is_integer
    smooth_q = bool(smooth_q) and smooth and not q_dense
    if bias is not None:
        while bias.dim() < 4:
            bias = bias[None]
        bias = broadcast_bias(bias, b, hq, sq, sk)
    left, right = fold_mask(causal, window)
    kv_row0 = None
    if walk is not None:
        _check_walk(walk, b, hq, sq, sk)
        if walk.kv_mean_tile is None:
            # Raw tables of a public call: the tile a BlockMask finds on the host.
            if walk.fetch_kv is None or walk.fill_kv is None:
                raise ValueError("a block_map on the single-launch route needs fetch_kv and "
                                 "fill_kv: the K/V means come from each slice's first fill")
            walk = walk._replace(kv_mean_tile=first_fill_tiles(walk.fetch_kv, walk.fill_kv))
        kv_row0 = kv_mean_rows(walk, b, hkv, hq // hkv)
        if mean_rows is None:
            # The reference's tiles are the map's (quant_attention.py:1057-1075).
            mean_rows = (walk.block_q, walk.block_k)
    if mean_rows is None:
        mean_rows = default_mean_rows(sq, sk, d, causal=causal, window=window,
                                      has_bias=bias is not None, pv_int8=pv_int8)
    t_q, t_kv = (int(t) for t in mean_rows)
    if t_q < 1 or t_kv < 1:
        raise ValueError(f"mean_rows must be positive, got {mean_rows}")
    groups = (0, 0, 0)
    if mode == QuantMode.BLOCK:
        # The reference clamps each group to its own tile, the tiles the
        # means are estimated over.
        qb = quant_blocks or BlockSizeConfig()
        groups = (effective_group(qb.q, t_q), effective_group(qb.k, t_kv),
                  effective_group(qb.v, t_kv))
    pv_chunk = 0
    if pv_int8:
        # V per chunk of the reference's KV tile, whatever the mode asks
        # (quant_fused_attn.py:1360-1362).
        pv_chunk = pv_chunk_of(walk.block_k if walk is not None else t_kv)
        groups = groups[:2] + (pv_chunk,)
    return _Prepared(q.contiguous(), k.contiguous(), v.contiguous(), bias,
                     float(d**-0.5 if scale is None else scale), left, right, bool(smooth),
                     smooth_q, bool(hadamard), bool(emit), q_precision, k_precision,
                     v_precision, t_q, t_kv, strategy == QuantStrategy.ASYMMETRIC, groups,
                     kernel_out, final, orig_dtypes, walk, kv_row0, pv_chunk)


def fused_quantize_attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    causal: bool = False,
    window: Optional[tuple] = None,
    scale: Optional[float] = None,
    smooth: bool = True,
    smooth_q: Optional[bool] = None,
    hadamard: bool = False,
    pv_int8: bool = False,
    emit_residuals: bool = True,
    q_precision: Precision = Precision.INT8,
    k_precision: Precision = Precision.INT8,
    v_precision: Precision = Precision.INT8,
    strategy: QuantStrategy = QuantStrategy.SYMMETRIC,
    mode: QuantMode = QuantMode.ROW,
    quant_blocks: Optional[BlockSizeConfig] = None,
    out_dtype: Optional[torch.dtype] = None,
    mean_rows: Optional[tuple] = None,
    block_map: Optional[torch.Tensor] = None,
    fetch_kv: Optional[torch.Tensor] = None,
    hold_kv: Optional[torch.Tensor] = None,
    fill_kv: Optional[torch.Tensor] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
):
    """Runtime INT8/INT4 quantization and attention in one kernel launch.
    q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D); bias additive, broadcastable
    to (B, Hq, Sq, Sk). `mean_rows` = (T_q, T_kv) overrides the reference's
    tiles, the rows the smoothing means are estimated over and the bound of
    the BLOCK groups (default: `default_mean_rows`, or the map's tiles).
    `mode=BLOCK` takes one scale per `quant_blocks.{q,k,v}` rows
    (`effective_group`). block_map (Bm, Hm, ceil(Sq / block_q),
    ceil(Sk / block_k)) with its compacted key-tile table fetch_kv (the
    kernel walks it) and fill schedule hold_kv/fill_kv (a BlockMask's
    fields, both tables required) restricts each row to the keys of its
    walked tiles; the K/V means come from each slice's first filled tile
    (`first_fill_tiles`). `pv_int8` runs P·V on integers (the module
    docstring), symmetric only.

    Returns (out (B, Hq, Sq, D) in out_dtype (default q.dtype), lse
    (B, Hq, Sq) fp32, qt_q, qt_k, qt_v, qm, vm): the residuals (qt_q None
    for a dense Q; all None without `emit_residuals`; per-row scales and,
    ASYMMETRIC, int32 zero points (B, H, S, 1), row_sums None), qm
    (B, Hq, 1, D) with `smooth_q`, vm (B, Hkv, 1, D) with `smooth`, fp32."""
    return _fused(q, k, v, bias, _map_walk(block_map, fetch_kv, hold_kv, fill_kv, block_q,
                                           block_k),
                  causal=causal, window=window, scale=scale, smooth=smooth, smooth_q=smooth_q,
                  hadamard=hadamard, pv_int8=pv_int8, emit_residuals=emit_residuals,
                  q_precision=q_precision,
                  k_precision=k_precision, v_precision=v_precision, strategy=strategy,
                  mode=mode, quant_blocks=quant_blocks, out_dtype=out_dtype,
                  mean_rows=mean_rows)


def fused_quantize_attend_plain(q, k, v, bias=None, *, block_map=None, fetch_kv=None,
                                hold_kv=None, fill_kv=None, block_q=None, block_k=None, **kw):
    """The kernel's arithmetic in plain PyTorch, on any device. Same
    arguments and results as `fused_quantize_attend`."""
    return _fused(q, k, v, bias, _map_walk(block_map, fetch_kv, hold_kv, fill_kv, block_q,
                                           block_k), plain=True, **kw)


def _fused(q, k, v, bias, walk: Optional[Walk], plain: bool = False, *, causal=False,
           window=None, scale=None, smooth=True, smooth_q=None, hadamard=False,
           pv_int8=False, emit_residuals=True, q_precision=Precision.INT8,
           k_precision=Precision.INT8, v_precision=Precision.INT8,
           strategy=QuantStrategy.SYMMETRIC, mode=QuantMode.ROW, quant_blocks=None,
           out_dtype=None, mean_rows=None, p_codes=None):
    """`fused_quantize_attend` with its block-sparse arguments as a Walk (a
    BlockMask's carries the means tile found on the host); `plain` runs the
    plain version on any device. `p_codes`, a zeroed (B, Hq, Sq, Sk)
    uint8 tensor, receives the P codes under pv_int8, for checks: those of
    the lanes whose chunk counts (β > 0); the others stay 0."""
    p = _prepare(q, k, v, bias, causal, window, scale, smooth, smooth_q, hadamard,
                 emit_residuals, q_precision, k_precision, v_precision, out_dtype, mean_rows,
                 strategy, mode, quant_blocks, walk, pv_int8)
    if plain or p.q.device.type == "cpu":
        return _finish(p, *_plain(p, p_codes))
    return _finish(p, *_launch(p, p_codes))


def _map_walk(block_map, fetch_kv, hold_kv, fill_kv, block_q, block_k) -> Optional[Walk]:
    walk = make_walk(block_map, fetch_kv, None, block_q, block_k)
    return None if walk is None else walk._replace(hold_kv=hold_kv, fill_kv=fill_kv)


def _qt(vals, scales, zps, shape, dtype, precision, group, asym) -> QuantizedTensor:
    return QuantizedTensor(values=vals, scales=scales, zero_points=zps, row_sums=None,
                           precision=precision,
                           mode=QuantMode.BLOCK if group else QuantMode.ROW,
                           strategy=QuantStrategy.ASYMMETRIC if asym else QuantStrategy.SYMMETRIC,
                           block_size=group, orig_shape=tuple(shape), orig_dtype=dtype)


def _finish(p: _Prepared, out, lse, res):
    if p.final_dtype == torch.float16:
        out = out.half()
    if not p.emit:
        return out, lse, None, None, None, None, None
    qv, qs, kv, ks, vv, vs, qzp, kzp, vzp, qm, vm = res
    b, hq, sq, d = p.q.shape
    kshape = p.k.shape
    gq, gk, gv = p.groups
    qt_q = None if qv is None else _qt(qv, qs, qzp, (b, hq, sq, d), p.orig_dtypes[0],
                                       p.q_precision, gq, p.asym)
    qt_k = _qt(kv, ks, kzp, kshape, p.orig_dtypes[1], p.k_precision, gk, p.asym)
    qt_v = _qt(vv, vs, vzp, kshape, p.orig_dtypes[2], p.v_precision, gv, p.asym)
    return out, lse, qt_q, qt_k, qt_v, qm, vm


def _tile_mean(x: torch.Tensor, t: int, row0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's estimate: the sum of the rows of its zero-padded
    tile of T rows, over T; the first tile, or with `row0` (B, H) the one
    that starts at row0[b, h]."""
    # Summed in float64 and rounded once, as the kernel does (exact for
    # these magnitudes, so the order of the sum does not matter).
    if row0 is None:
        total = x[:, :, :t].double().sum(dim=2, keepdim=True)
    else:
        r = torch.arange(x.shape[2], device=x.device)[None, None, :, None]
        r0 = row0.to(x.device)[..., None, None]
        total = (x.double() * ((r >= r0) & (r < r0 + t))).sum(dim=2, keepdim=True)
    return total.float() / x.new_tensor(float(t))


def _group_stat(stat: torch.Tensor, group: int, pad: torch.Tensor, reduce) -> torch.Tensor:
    """A per-row statistic (..., S, 1) reduced over groups of `group` rows
    and broadcast back to every row (the reference's `_segment_stat`). The
    rows past S that complete the last group carry the statistic `pad`
    (..., 1, 1): the reference's zero-padded tile rows."""
    *lead, s, _ = stat.shape
    n = -(-s // group) * group
    if n > s:
        stat = torch.cat([stat, pad.expand(*lead, n - s, 1)], dim=-2)
    g = reduce(stat.reshape(*lead, n // group, group), dim=-1, keepdim=True)
    return g.expand(*lead, n // group, group).reshape(*lead, n, 1)[..., :s, :]


def _quantize_rows(x: torch.Tensor, mean, precision: Precision, group: int = 0,
                   asym: bool = False):
    """Register-space quantization of the TPU kernel (quant_fused_attn.py:
    127-193): symmetric by a reciprocal multiply, no clip; asymmetric by
    exact divisions, the zero point not clipped; one statistic per row, or
    per `group` rows. Returns (codes as fp32, scales, zero points as fp32
    or None)."""
    pad = x.new_zeros(x.shape[:-2] + (1, x.shape[-1]))  # a zero-padded row
    if mean is not None:
        x, pad = x - mean, pad - mean
    qmax = float(_qmax(precision))
    if asym:
        hi, lo = x.amax(dim=-1, keepdim=True), x.amin(dim=-1, keepdim=True)
        if group:
            hi = _group_stat(hi, group, pad.amax(dim=-1, keepdim=True), torch.amax)
            lo = _group_stat(lo, group, pad.amin(dim=-1, keepdim=True), torch.amin)
        # 0-dim tensor operands: `t / c` on CUDA multiplies by 1/c; the
        # kernel divides exactly.
        scale = (hi - lo).clamp_min(1e-12) / x.new_tensor(2 * qmax + 1)
        zp = torch.round(-lo / scale) - (qmax + 1)
        codes = torch.clamp(torch.round(x / scale) + zp, -qmax - 1, qmax)
        return codes, scale, zp
    absmax = x.abs().amax(dim=-1, keepdim=True)
    if group:
        absmax = _group_stat(absmax, group, pad.abs().amax(dim=-1, keepdim=True), torch.amax)
    absmax = absmax.clamp_min(1e-12)
    # 0-dim tensor operands: `c / t` in PyTorch is reciprocal(t) * c, and
    # `t / c` on CUDA multiplies by 1/c; the kernel divides exactly.
    qmax_t = absmax.new_tensor(qmax)
    return torch.round(x * (qmax_t / absmax)), absmax / qmax_t, None


def _deq(codes, scale, zp):
    return codes * scale if zp is None else (codes - zp) * scale


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _codes(codes_f: torch.Tensor, precision: Precision) -> torch.Tensor:
    codes = codes_f.to(torch.int8)
    return pack_int4(codes) if precision == Precision.INT4 else codes


def _zp(zp):
    return None if zp is None else zp.to(torch.int32)


def _plain(p: _Prepared, p_codes: Optional[torch.Tensor] = None):
    b, hq, sq, d = p.q.shape
    _, hkv, sk, _ = p.k.shape
    g = hq // hkv
    gq, gk, gv = p.groups
    q32, k32, v32 = p.q.float(), p.k.float(), p.v.float()
    if p.hadamard:
        q32, k32 = rotate(q32), rotate(k32)
    km = _tile_mean(k32, p.t_kv, p.kv_row0) if p.smooth else None
    vm = _tile_mean(v32, p.t_kv, p.kv_row0) if p.smooth else None
    qm = _tile_mean(q32, p.t_q) if p.smooth_q else None

    k_f, sk_, zk = _quantize_rows(k32, km, p.k_precision, gk, p.asym)
    if p.pv_chunk:
        # V as the reference's zero-padded KV tiles hold it: the rows past
        # Sk (0 − vm) count in the last chunk's scale and code the lanes
        # that a row with no visible key averages over.
        bk = p.walk.block_k if p.walk is not None else p.t_kv
        v_pad = torch.nn.functional.pad(v32, (0, 0, 0, -(-sk // bk) * bk - sk))
        v_fp, sv_p, _ = _quantize_rows(v_pad, vm, p.v_precision, gv)
        v_f, sv_, zv, v_bf = v_fp[:, :, :sk], sv_p[:, :, :sk], None, None
    else:
        v_f, sv_, zv = _quantize_rows(v32, vm, p.v_precision, gv, p.asym)
        v_bf = _bf16(_deq(v_f, sv_, zv))
    k_bf = _bf16(_deq(k_f, sk_, zk))
    q_dense = not p.q_precision.is_integer
    if q_dense:
        q_bf, q_f, sq_, zq = _bf16(q32 * p.scale), None, None, None
    else:
        q_f, sq_, zq = _quantize_rows(q32, qm, p.q_precision, gq, p.asym)
        q_bf = _bf16(_deq(q_f, sq_, zq) * p.scale)

    # GQA: fold the group into the query rows (h = hk * g + gi). The dots of
    # bf16 values are exact in float64 and rounded once, as in the kernel.
    s = torch.matmul(q_bf.reshape(b, hkv, g * sq, d).double(),
                     k_bf.double().transpose(-1, -2)).float()
    s = s.reshape(b, hq, sq, sk)
    if qm is not None:
        cc = torch.matmul(_bf16(qm).reshape(b, hkv, g, d).double(),
                          k_bf.double().transpose(-1, -2)).float()
        s += (cc * p.scale).reshape(b, hq, 1, sk)
    if p.bias is not None:
        s += p.bias
    hidden = ~visible_mask(sq, sk, p.left, p.right, s.device)
    if p.walk is not None:
        hidden = hidden | ~walked_keys(p.walk, sq, sk)
    s.masked_fill_(hidden, DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True).clamp_min(DEFAULT_MASK_VALUE)
    res = None
    if p.emit:
        res = (None if q_dense else _codes(q_f, p.q_precision), sq_,
               _codes(k_f, p.k_precision), sk_, _codes(v_f, p.v_precision), sv_,
               _zp(zq), _zp(zk), _zp(zv), qm, vm)
    if p.pv_chunk:
        out, lse = _plain_pv(p, s, m, v_fp, sv_p, vm, p_codes)
        return out.to(p.out_dtype), lse, res
    s.sub_(m).exp_().masked_fill_(hidden, 0.0)
    pb = _bf16(s)
    # Row sum: the bf16 P at D < 128 (it rides P·V as a ones column in the
    # reference), the fp32 P at D >= 128 (quant_fused_attn.py:612-618).
    l = (pb if d < 128 else s).sum(dim=-1)
    del s
    pv = torch.matmul(pb.reshape(b, hkv, g * sq, sk), v_bf).reshape(b, hq, sq, d)
    del pb
    empty = l == 0
    l_safe = torch.where(empty, torch.ones_like(l), l)
    out = pv / l_safe[..., None]
    if vm is not None:
        out = torch.where(empty[..., None], 0.0, out + vm.repeat_interleave(g, dim=1))
    lse = torch.where(empty, torch.full_like(l, DEFAULT_MASK_VALUE), m[..., 0] + torch.log(l_safe))
    return out.to(p.out_dtype), lse, res


def _plain_pv(p: _Prepared, s: torch.Tensor, m: torch.Tensor, v_codes: torch.Tensor,
              v_scales: torch.Tensor, vm: Optional[torch.Tensor],
              p_codes: Optional[torch.Tensor] = None):
    """The integer P·V of the reference (quant_fused_attn.py:552-601,
    :823-828) on the masked scores s (B, Hq, Sq, Sk), their row max m, and
    V's codes and scales (as fp32) over the reference's zero-padded rows."""
    b, hq, sq, sk = s.shape
    hkv, d = v_codes.shape[1], v_codes.shape[3]
    g, c = hq // hkv, p.pv_chunk
    nch = -(-sk // c)
    # Lanes past Sk are index-masked; ml is each chunk's max over all its lanes.
    s_c = torch.nn.functional.pad(s, (0, nch * c - sk), value=DEFAULT_MASK_VALUE)
    s_c = s_c.reshape(b, hq, sq, nch, c)
    ml = s_c.amax(dim=-1, keepdim=True)
    codes = s_c.sub_(ml - LN_P_AMP).exp_().round_()  # p̂ in [0, 255]
    live = m > DEFAULT_MASK_VALUE
    beta = torch.where(live, torch.exp(ml[..., 0] - m), 0.0)  # (B, Hq, Sq, nch)
    l = (codes.sum(dim=-1) * beta).sum(dim=-1)
    if p_codes is not None:
        kept = torch.where(beta[..., None] > 0, codes, 0.0).reshape(b, hq, sq, nch * c)
        p_codes.copy_(kept[..., :sk].to(torch.uint8))
    # Σ p̂·v_code of each chunk: integers below 2^24 (255 · 127 · 256), so the
    # fp32 product is exact in any order.
    vc = v_codes[:, :, :nch * c].reshape(b, hkv, 1, nch, c, d)
    isum = torch.matmul(codes.reshape(b, hkv, g, sq, nch, c).transpose(3, 4), vc)
    del codes
    sv_c = v_scales[:, :, 0:nch * c:c, 0].repeat_interleave(g, dim=1)  # (B, Hq, nch)
    w = beta * sv_c[:, :, None, :]
    acc = (isum.reshape(b, hq, nch, sq, d) * w.transpose(2, 3)[..., None]).sum(dim=2)
    del isum
    empty = l == 0
    l_safe = torch.where(empty, torch.ones_like(l), l)
    out = acc / l_safe[..., None]
    vm_q = None if vm is None else vm.repeat_interleave(g, dim=1)
    if vm_q is not None:
        out = torch.where(empty[..., None], 0.0, out + vm_q)
    lse = torch.where(empty, torch.full_like(l, DEFAULT_MASK_VALUE),
                      (m[..., 0] + torch.log(l_safe)) - LN_P_AMP)
    if not live.all():
        out = torch.where(live, out, _hidden_rows_pv(p, sq, v_codes, v_scales, vm_q))
    return out, lse


def _reference_walked_tiles(p: _Prepared, sq: int, sk: int) -> tuple:
    """(walked (Bm, Hm, nq, nk) bool, block_q, block_k): the key tiles the
    reference walks for each of its query tiles, its `_block_visible` under
    the index mask and, with a map, the map's non-SKIP tiles."""
    bq, bk = (p.walk.block_q, p.walk.block_k) if p.walk is not None else (p.t_q, p.t_kv)
    nq, nk = -(-sq // bq), -(-sk // bk)
    q_start = torch.arange(nq, device=p.q.device)[:, None] * bq
    k_start = torch.arange(nk, device=p.q.device)[None, :] * bk
    vis = torch.ones((nq, nk), dtype=torch.bool, device=p.q.device)
    if p.right >= 0:
        vis &= k_start <= q_start + bq - 1 + p.right
    if p.left >= 0:
        vis &= k_start + bk - 1 >= q_start - p.left
    vis = vis[None, None]
    if p.walk is not None:
        vis = vis & (p.walk.block_map != 0)
    return vis, bq, bk


def _hidden_rows_pv(p: _Prepared, sq: int, v_codes, v_scales, vm_q):
    """(B, Hq, Sq, D): what the reference gives a row that sees no key (row
    max −1e30): every lane of every chunk its query tile walks codes p̂ = 1
    and every β is 1, so out = the mean of code·sv over those lanes (+ vm),
    summed chunk by chunk; exactly 0 where it walks none."""
    b, hkv, skp, d = v_codes.shape
    hq = p.q.shape[1]
    g, c = hq // hkv, p.pv_chunk
    walked, bq, bk = _reference_walked_tiles(p, sq, p.k.shape[2])
    w = walked.repeat_interleave(bq, dim=2)[:, :, :sq].repeat_interleave(bk // c, dim=3)
    w = w.expand(b, hq, sq, skp // c).float()
    chunk = v_codes.reshape(b, hkv, skp // c, c, d).sum(dim=3) * v_scales[:, :, ::c]
    acc = torch.matmul(w.reshape(b, hkv, g * sq, -1), chunk).reshape(b, hq, sq, d)
    n = w.sum(dim=-1, keepdim=True) * c
    out = acc / torch.where(n == 0, 1.0, n)
    if vm_q is not None:
        out = out + vm_q
    return torch.where(n == 0, 0.0, out)


def _launch(p: _Prepared, p_codes: Optional[torch.Tensor] = None):
    dev = p.q.device
    if dev.type != "cuda" or p.k.device != dev or p.v.device != dev:
        raise ValueError(f"fused_qattn kernel needs q, k, v on one CUDA device, got "
                         f"{p.q.device}/{p.k.device}/{p.v.device}")
    if p.bias is not None and p.bias.device != dev:
        raise ValueError(f"bias on {p.bias.device}, q on {dev}")
    b, hq, sq, d = p.q.shape
    _, hkv, sk, _ = p.k.shape
    refuse_wide("the fused_qattn kernel", d)
    walk = walk_args(p.walk, "fetch_kv", dev)
    if (p.pv_chunk and p.pv_chunk % (32 if d > 128 else 64)
            and not (p.walk is not None and p.pv_chunk == p.walk.block_k)):
        # The kernel's key tiles (64 keys, 32 at D > 128, from key 0 or from
        # each map tile's first key) must each lie in one chunk.
        raise ValueError(f"fused_qattn's integer P·V takes chunks of a multiple of its key "
                         f"tile, got pv_chunk {p.pv_chunk}")
    if p.kv_row0 is not None and p.kv_row0.device != dev:
        raise ValueError(f"the block-sparse tables lie on {p.kv_row0.device}, q on {dev}")
    q_dense = not p.q_precision.is_integer
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    out = torch.empty((b, hq, sq, d), dtype=p.out_dtype, device=dev)
    lse = torch.empty((b, hq, sq), **f32)
    # Means: computed by the kernel's first pass into these buffers (km is
    # scratch; qm and vm are also residuals).
    qm = torch.empty((b, hq, 1, d), **f32) if p.smooth_q else None
    km = torch.empty((b, hkv, 1, d), **f32) if p.smooth else None
    vm = torch.empty((b, hkv, 1, d), **f32) if p.smooth else None
    # The cc row (bf16(qm)·k̃)·scale of every (b, q head, key): scratch the
    # kernel fills once and the attention reads with each key tile.
    cc = torch.empty((b, hq, sk), **f32) if p.smooth_q else None
    # The dequantized K̃ and Ṽ, bf16(deq), written by the quantize pass
    # beside the codes: the attention copies these tiles as they are.
    kb, vb = (torch.empty((b, hkv, sk, d), dtype=torch.bfloat16, device=dev) for _ in "kv")
    # BLOCK and ASYMMETRIC quantize every operand in a pre-pass (the group
    # statistics span rows of other blocks): the rows x − mean as fp32
    # (Q's rows first, then K's, then V's), their statistics (hi, or
    # absmax, then lo), and Q's dequantized bf16 values, softmax scale
    # folded in, which the attention then reads as a dense Q.
    pre = p.asym or any(p.groups)
    nq = 0 if q_dense else b * hq * sq
    rows = nq + 2 * b * hkv * sk
    ys = torch.empty((rows, d), **f32) if pre else None
    st = torch.empty((2, rows), **f32) if pre else None
    qb = torch.empty((b, hq, sq, d), dtype=torch.bfloat16, device=dev) if pre and nq else None

    def width(prec):
        return d // 2 if prec == Precision.INT4 else d

    # The K/V codes and scales are written by the kernel's quantize pass
    # whether or not residuals are asked for.
    res = [None, None,
           torch.empty((b, hkv, sk, width(p.k_precision)), dtype=torch.int8, device=dev),
           torch.empty((b, hkv, sk, 1), **f32),
           torch.empty((b, hkv, sk, width(p.v_precision)), dtype=torch.int8, device=dev),
           torch.empty((b, hkv, sk, 1), **f32), None,
           torch.empty((b, hkv, sk, 1), **i32) if p.asym else None,
           torch.empty((b, hkv, sk, 1), **i32) if p.asym else None]
    if p.emit and not q_dense:
        res[0] = torch.empty((b, hq, sq, width(p.q_precision)), dtype=torch.int8, device=dev)
        res[1] = torch.empty((b, hq, sq, 1), **f32)
        res[6] = torch.empty((b, hq, sq, 1), **i32) if p.asym else None
    # pv_int8: each row's chunk maxima, raised by the first pass from −1e30
    # and read by the second, and V's unpacked codes (the residual's own at
    # INT8).
    ml = vcode = None
    if p.pv_chunk:
        ml = torch.full((b, hq, sq, -(-sk // p.pv_chunk)), DEFAULT_MASK_VALUE, **f32)
        vcode = (torch.empty((b, hkv, sk, d), dtype=torch.int8, device=dev)
                 if p.v_precision == Precision.INT4 else res[4])
    if p_codes is not None and (not p.pv_chunk or p_codes.dtype != torch.uint8
                                or tuple(p_codes.shape) != (b, hq, sq, sk)
                                or p_codes.device != dev or not p_codes.is_contiguous()):
        raise ValueError(f"p_codes must be a contiguous uint8 {(b, hq, sq, sk)} tensor on "
                         f"{dev}, under pv_int8")
    flags = ((_F_HADAMARD if p.hadamard else 0) | (_F_SMOOTH if p.smooth else 0)
             | (_F_SMOOTH_Q if p.smooth_q else 0) | (_F_Q_DENSE if q_dense else 0)
             | (_F_ASYM if p.asym else 0) | (_F_PV if p.pv_chunk else 0)
             | (_Q_INT4 if p.q_precision == Precision.INT4 else 0)
             | (_K_INT4 if p.k_precision == Precision.INT4 else 0)
             | (_V_INT4 if p.v_precision == Precision.INT4 else 0))
    if out.numel():
        def ptr(t):
            return None if t is None else t.data_ptr()
        fn = _kernels.function("fused_qattn", "umfa_fused_qattn", _ARGTYPES)
        bsb, bsh, bsq, bsk = bias_strides(p.bias)
        with torch.cuda.device(dev):
            err = fn(
                p.q.data_ptr(), p.k.data_ptr(), p.v.data_ptr(), ptr(p.bias),
                out.data_ptr(), lse.data_ptr(), *(ptr(t) for t in res[:6]),
                ptr(qm), ptr(km), ptr(vm), ptr(cc), kb.data_ptr(), vb.data_ptr(),
                *(ptr(t) for t in res[6:]), ptr(ys), ptr(st), ptr(qb),
                b, hq, hkv, sq, sk, d, bsb, bsh, bsq, bsk, p.scale, p.left, p.right,
                flags, _qmax(p.q_precision) if not q_dense else 0,
                _qmax(p.k_precision), _qmax(p.v_precision), p.t_q, p.t_kv, *p.groups,
                _DTYPE_CODE[p.q.dtype], _DTYPE_CODE[p.out_dtype], *walk, ptr(p.kv_row0),
                ptr(ml), ptr(vcode), ptr(p_codes), torch.cuda.current_stream(dev).cuda_stream,
            )
        _kernels.check("fused_qattn", err)
        if p.pv_chunk:
            _kernels.launches["fused_qattn/pv"] += 1
    return out, lse, (*res, qm, vm) if p.emit else None
