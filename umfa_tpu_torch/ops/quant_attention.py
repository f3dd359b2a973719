"""Quantized attention forward on pre-quantized INT8/INT4 operands (port of
umfa_tpu/ops/quant_attention.py:295 `quantized_attention_forward`).

`quantized_attention_forward` launches the CUDA kernel
`csrc/quant_attn_fwd.cu` (int8 tensor cores for QKᵀ, INT4 codes unpacked to
int8 as they are staged (here first where head_dim is not a multiple of
8), bf16 for P·V; head_dim <= 256, the codes zero-padded to a multiple of
16 where head_dim is not a multiple of 4) on
CUDA tensors and runs `quantized_attention_forward_plain`, the same
arithmetic in plain PyTorch, on CPU tensors; no fallback between them.

Arithmetic (quant_attention.py:166-256): s = int32(q_code · k_code) (INT4
codes unpacked from split halves); ASYMMETRIC, s − zq·rs_k − zk·rs_q +
D·zq·zk in fp32 (zero points and code row sums); then · (q_scale ·
softmax_scale) · k_scale, + score_corr · softmax_scale (the Q-mean row),
+ bias, index mask → -1e30, P = exp(s - m) against the row max m, the FP32
row sum of P, P·V on bf16(P) and the dequantized V tile bf16(bf16(v_code) ·
bf16(v_scale)) with FP32 accumulation, or ASYMMETRIC on bf16(P · v_scale)
and the V codes, less Σ P · v_scale · zv; FP32 output. The kernel finds m
in a first pass, so it rounds P where this plain version does (the
reference's one-pass kernel rounds relative to a running max; where it
walks a single KV tile, as in the parity tests, that is the same point).
Masking semantics are those of ops/flash_fwd.py, the block-sparse walk
(`block_map` with its tiles block_q, block_k; the kernel walks the
compacted table `fetch_ids`) included.

`pv_int8` (quant_attention.py:219-229), symmetric only: V's scale must be
constant over each group of its rows (the reference quantizes V BLOCK-wise
per KV tile, `v_tile_k`); P's codes are rint(127·p) against the final row
max (0 on hidden lanes), each group's P·V is the exact integer Σ code ·
v_code times fp32(sv · fp32(1/127)), the groups summed in fp32, and l sums
the fp32 P.

Supported: INT8 or INT4 per operand, symmetric or asymmetric (one
strategy for all three), per-row (ROW/BLOCK) or per-tensor scales,
`score_corr`, bias, causal/window, GQA, block-sparse maps, `pv_int8`.

`quantized_flash_attention` is the differentiable STE route (port of
quant_attention.py:597-1095): runtime quantization and attention in one
launch (`ops/quant_fused_attn.py`) where the reference's rules allow it,
else the two-pass route (`_quantize_operands`, then the kernel above, then
the V-mean restore); the backward runs on the quantized residuals
(`ops/quant_bwd.py`), or, for a dense Q or ASYMMETRIC residuals, on the
dequantized operands through the dense backward (`ops/flash_bwd.py`). A
BlockMask (`block_mask=`) gives the bias and the walk to every route, its
tiles pinning the reference's (the fused route's means windows and BLOCK
groups; quant_attention.py:1057-1075); the bias gradient is not walked,
as the reference's is not. The reference's window auto-tiling
(quant_attention.py:1037-1056) is TPU tile scheduling and is left out.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional

import torch
from torch.autograd.function import once_differentiable

from umfa_tpu_torch import _kernels
from umfa_tpu_torch.engine.config import Precision, QuantizationConfig, QuantMode, QuantStrategy
from umfa_tpu_torch.ops.flash_bwd import _backward as flash_backward
from umfa_tpu_torch.ops.flash_bwd import flash_attention_bias_grad
from umfa_tpu_torch.ops.flash_fwd import (
    DEFAULT_MASK_VALUE,
    WALK_ARGTYPES,
    Walk,
    _check_walk,
    bias_strides,
    broadcast_bias,
    check_no_grad,
    fold_mask,
    BlockSizes,
    _choose_block,
    make_walk,
    refuse_wide,
    visible_mask,
    walk_args,
    walked_keys,
)
from umfa_tpu_torch.ops.hadamard import hadamard_rotate
from umfa_tpu_torch.ops.quant import (
    QuantizedTensor,
    choose_mode,
    dequantize,
    quantize,
    unpack_int4,
)
from umfa_tpu_torch.ops.quant_bwd import _backward as quantized_backward
from umfa_tpu_torch.ops.quant_fused import quantize_rows_fused
from umfa_tpu_torch.ops.quant_fused_attn import (
    _fused,
    fused_path_supported,
    require_symmetric_pv,
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# q k v qs ks vs bias corr qz qr kz kr vz out lse | B Hq Hkv Sq Sk D | qs_rows
# ks_rows vs_rows | bsb bsh bsq bsk | left right int4 dz | the walk | pv | stream
_ARGTYPES = (*(_P,) * 15, *(_I,) * 6, _I, _I, _I, _L, _L, _L, _L, _I, _I, _I, _I,
             *WALK_ARGTYPES, _I, _P)
_PV_SCALE = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()  # fp32(1/127)


class _Prepared(NamedTuple):
    q: torch.Tensor        # int8 (B, Hq, Sq, D), or (…, D/2) packed INT4
    k: torch.Tensor        # int8 (B, Hkv, Sk, D or D/2)
    v: torch.Tensor
    int4: tuple            # (q, k, v) INT4 packed
    d: int                 # head dim
    q_scales: torch.Tensor  # f32 (B, Hq, Sq|1, 1), softmax scale folded in
    k_scales: torch.Tensor  # f32 (B, Hkv, Sk|1, 1)
    v_scales: torch.Tensor
    asym: Optional[tuple]  # f32 (qz, qr, kz, kr, vz): zero points like the scales, row sums (…, S, 1)
    corr: Optional[torch.Tensor]  # f32 (B, Hq, 1, Sk), softmax scale folded in
    bias: Optional[torch.Tensor]
    left: int
    right: int
    out_dtype: torch.dtype
    walk: Optional[Walk]
    pv_group: int = 0  # pv_int8: rows of one V scale (Sk or more: one group); 0 = bf16 P·V


def _pv_group(qt_v, sk: int) -> int:
    """The rows over which V's scale is constant, for the integer P·V: the
    BLOCK group, or Sk for one scale per (b, h); the kernel reads one scale
    a 32-key step, so a smaller group must be a multiple of 32."""
    sc = qt_v.scales
    if sc.shape[2] == 1:
        return sk
    group = qt_v.block_size if qt_v.mode == QuantMode.BLOCK else 1
    if group < sk and group % 32:
        raise ValueError(f"pv_int8 needs V's scale constant over groups of a multiple of 32 "
                         f"rows (BLOCK scales per KV tile), got {qt_v.mode.value} groups of "
                         f"{group}")
    first = sc[:, :, ::group].repeat_interleave(group, dim=2)[:, :, :sk]
    if not torch.equal(first, sc):
        raise ValueError(f"pv_int8 needs V's scale constant over each group of {group} rows")
    return min(group, sk)


def _scales(t: torch.Tensor, b: int, h: int, s: int, name: str) -> torch.Tensor:
    if t.dim() != 4 or tuple(t.shape[:2]) != (b, h) or t.shape[2] not in (1, s) or t.shape[3] != 1:
        raise ValueError(f"{name} scales of shape {tuple(t.shape)}; expected ({b}, {h}, {s} or 1, 1)")
    return t.float()


def _prepare(qt_q, qt_k, qt_v, bias, score_corr, walk: Optional[Walk],
             causal, window, scale, out_dtype, pv_int8) -> _Prepared:
    asym = qt_q.strategy == QuantStrategy.ASYMMETRIC
    if pv_int8 and asym:
        raise ValueError("pv_int8 requires symmetric quantization")
    for qt in (qt_q, qt_k, qt_v):
        if not qt.precision.is_integer:
            raise ValueError(f"quantized operands are INT8 or INT4, got {qt.precision}")
        if (qt.strategy == QuantStrategy.ASYMMETRIC) != asym:
            raise ValueError("mixed quantization strategies are not supported")
    b, hq, sq, _ = qt_q.orig_shape
    _, hkv, sk, d = qt_k.orig_shape
    q, k, v = qt_q.values, qt_k.values, qt_v.values
    int4 = tuple(qt.precision == Precision.INT4 for qt in (qt_q, qt_k, qt_v))
    w = [d // 2 if i4 else d for i4 in int4]
    if (tuple(q.shape) != (b, hq, sq, w[0]) or tuple(k.shape) != (b, hkv, sk, w[1])
            or tuple(v.shape) != (b, hkv, sk, w[2])):
        raise ValueError(f"value shapes {tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)} do not match orig_shape")
    if any(int4) and d % 2:
        raise ValueError("INT4 operands need an even head_dim")
    if hq % hkv:
        raise ValueError(f"q heads {hq} must be a multiple of kv heads {hkv}")
    if scale is None:
        scale = d**-0.5
    # Softmax scale folded into the Q scales and the corr row
    # (quant_attention.py:359-363, :461-472).
    q_scales = _scales(qt_q.scales, b, hq, sq, "q") * scale
    k_scales = _scales(qt_k.scales, b, hkv, sk, "k")
    v_scales = _scales(qt_v.scales, b, hkv, sk, "v")
    zps = None
    if asym:
        # As fp32, as the reference reads them: integers below 2^24, exact.
        zps = []
        for name, qt, heads, s_ in (("q", qt_q, hq, sq), ("k", qt_k, hkv, sk), ("v", qt_v, hkv, sk)):
            if qt.zero_points is None or tuple(qt.zero_points.shape) != tuple(qt.scales.shape):
                raise ValueError(f"{name} zero points must be laid out as its scales")
            zps.append(qt.zero_points.float())
            if name != "v":
                if qt.row_sums is None or tuple(qt.row_sums.shape) != (b, heads, s_, 1):
                    raise ValueError(f"{name} row sums of shape ({b}, {heads}, {s_}, 1) needed")
                zps.append(qt.row_sums.float())
        zps = tuple(zps)
    corr = None
    if score_corr is not None:
        if tuple(score_corr.shape) != (b, hq, 1, sk):
            raise ValueError(f"score_corr of shape {tuple(score_corr.shape)}; expected {(b, hq, 1, sk)}")
        corr = score_corr.float() * scale
    if bias is not None:
        while bias.dim() < 4:
            bias = bias[None]
        bias = broadcast_bias(bias, b, hq, sq, sk)
    left, right = fold_mask(causal, window)
    if walk is not None:
        _check_walk(walk, b, hq, sq, sk)
    pv_group = _pv_group(qt_v, sk) if pv_int8 else 0
    return _Prepared(q, k, v, int4, d, q_scales, k_scales, v_scales, zps, corr, bias, left,
                     right, out_dtype, walk, pv_group)


def quantized_attention_forward(
    qt_q: QuantizedTensor,
    qt_k: QuantizedTensor,
    qt_v: QuantizedTensor,
    bias: Optional[torch.Tensor] = None,
    score_corr: Optional[torch.Tensor] = None,
    block_map: Optional[torch.Tensor] = None,
    fetch_ids: Optional[torch.Tensor] = None,
    *,
    causal: bool = False,
    window: Optional[tuple] = None,
    scale: Optional[float] = None,
    out_dtype: torch.dtype = torch.float32,
    pv_int8: bool = False,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
):
    """Quantized attention on pre-quantized operands. block_map
    (Bm, Hm, ceil(Sq / block_q), ceil(Sk / block_k)) and fetch_ids, its
    compacted key-tile table (a BlockMask's fetch_kv, which the kernel
    walks), restrict each row to the keys of its walked tiles. Returns
    (out (B, Hq, Sq, D) in out_dtype, lse (B, Hq, Sq) float32)."""
    return _quant_forward(qt_q, qt_k, qt_v, bias, score_corr,
                          make_walk(block_map, fetch_ids, None, block_q, block_k),
                          causal=causal, window=window, scale=scale, out_dtype=out_dtype,
                          pv_int8=pv_int8)


def _quant_forward(qt_q, qt_k, qt_v, bias, score_corr, walk: Optional[Walk], *, causal,
                   window, scale, out_dtype, pv_int8=False):
    """`quantized_attention_forward` with its block-sparse arguments as a Walk."""
    check_no_grad("quantized_attention_forward", qt_q.values, qt_q.scales,
                  qt_k.values, qt_k.scales, qt_v.values, qt_v.scales, bias,
                  hint="call quantized_flash_attention for the STE gradients of "
                       "quantized training")
    p = _prepare(qt_q, qt_k, qt_v, bias, score_corr, walk, causal, window, scale, out_dtype,
                 pv_int8)
    if p.q.device.type == "cpu":
        out, lse = _plain(p)
    else:
        out, lse = _launch(p)
    return out.to(p.out_dtype), lse


def quantized_attention_forward_plain(
    qt_q, qt_k, qt_v, bias=None, score_corr=None, block_map=None, fetch_ids=None,
    *, causal=False, window=None, scale=None, out_dtype=torch.float32, pv_int8=False,
    block_q=None, block_k=None,
):
    """The kernel's arithmetic in plain PyTorch, on any device. Same
    arguments and results as `quantized_attention_forward`."""
    p = _prepare(qt_q, qt_k, qt_v, bias, score_corr,
                 make_walk(block_map, fetch_ids, None, block_q, block_k),
                 causal, window, scale, out_dtype, pv_int8)
    out, lse = _plain(p)
    return out.to(p.out_dtype), lse


def _unpacked(p: _Prepared):
    return tuple(unpack_int4(x) if i4 else x for x, i4 in zip((p.q, p.k, p.v), p.int4))


def _plain(p: _Prepared):
    q, k, v = _unpacked(p)
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    g = hq // hkv

    def kv_row(t):  # a K/V per-key column (…, Sk|1, 1) as a q-head row (…, 1, Sk|1)
        return t.repeat_interleave(g, dim=1).transpose(-1, -2)

    # Integer dot in fp32: every partial sum of int8 products is an integer
    # below 2^24 for D <= 1024, so it is exact (even under TF32).
    s = torch.matmul(q.float().reshape(b, hkv, g * sq, d), k.float().transpose(-1, -2))
    s = s.reshape(b, hq, sq, sk)
    if p.asym is not None:
        # Σ(qq − zq)(qk − zk) = dot − zq·rs_k − zk·rs_q + D·zq·zk, fp32 steps
        # in the reference's order (quant_attention.py:176-181).
        qz, qr, kz, kr, _ = p.asym
        kz, kr = kv_row(kz), kv_row(kr)
        s = s - qz * kr - kz * qr + (d * qz) * kz
    s.mul_(p.q_scales).mul_(kv_row(p.k_scales))
    if p.corr is not None:
        s += p.corr
    if p.bias is not None:
        s += p.bias
    hidden = ~visible_mask(sq, sk, p.left, p.right, s.device)
    if p.walk is not None:
        hidden = hidden | ~walked_keys(p.walk, sq, sk)
    s.masked_fill_(hidden, DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True).clamp_min(DEFAULT_MASK_VALUE)
    s.sub_(m).exp_().masked_fill_(hidden, 0.0)
    l = s.sum(dim=-1)
    if p.pv_group:
        pv = _plain_pv(p, s, v)
        del s
    elif p.asym is not None:
        # V's scale folded into P, its zero point subtracted after the dot
        # (quant_attention.py:231-243).
        s.mul_(kv_row(p.v_scales))
        zsum = (s * kv_row(p.asym[4])).sum(dim=-1, keepdim=True)
        v_deq = v.to(torch.bfloat16).float()
    else:
        v_deq = (v.to(torch.bfloat16) * p.v_scales.to(torch.bfloat16)).float()
    if not p.pv_group:
        pb = s.to(torch.bfloat16)
        del s
        pv = torch.matmul(pb.float().reshape(b, hkv, g * sq, sk), v_deq).reshape(b, hq, sq, d)
    if p.asym is not None:
        pv = pv - zsum
    empty = l == 0
    l_safe = torch.where(empty, torch.ones_like(l), l)
    out = pv / l_safe[..., None]
    lse = torch.where(empty, torch.full_like(l, DEFAULT_MASK_VALUE),
                      m[..., 0] + torch.log(l_safe))
    return out, lse


def _plain_pv(p: _Prepared, prob: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The integer P·V (quant_attention.py:219-229) of P (B, Hq, Sq, Sk),
    0 on hidden lanes, and V's int8 codes: each group's exact Σ rint(127·p)
    · v_code, as fp32, times fp32(sv · fp32(1/127)), summed over groups."""
    b, hq, sq, sk = prob.shape
    hkv, d = v.shape[1], v.shape[3]
    g, grp = hq // hkv, p.pv_group
    ng = -(-sk // grp)
    # Sums of 128 keys are integers below 2^24 (128 · 127 · 127), exact in
    # fp32 in any order; a group's sum of them is taken in float64, exact,
    # and rounded once, as the reference's int32 sum is when cast.
    sub = 128 if grp % 128 == 0 else grp
    n = ng * grp
    codes = torch.nn.functional.pad(torch.round(prob * 127.0), (0, n - sk))
    vc = torch.nn.functional.pad(v.float(), (0, 0, 0, n - sk))
    part = torch.matmul(codes.reshape(b, hkv, g * sq, n // sub, sub).transpose(2, 3),
                        vc.reshape(b, hkv, n // sub, sub, d))  # (B, Hkv, n/sub, g·Sq, D)
    del codes
    isum = part.double().reshape(b, hkv, ng, grp // sub, g * sq, d).sum(dim=3).float()
    sv = p.v_scales[:, :, ::grp] if p.v_scales.shape[2] > 1 else p.v_scales.expand(-1, -1, ng, -1)
    w = sv * _PV_SCALE  # (B, Hkv, ng, 1)
    pv = isum * w[..., None]
    acc = pv[:, :, 0]
    for gi in range(1, ng):
        acc = acc + pv[:, :, gi]
    return acc.reshape(b, hq, sq, d)


def _launch(p: _Prepared):
    dev = p.q.device
    tensors = {"q": p.q, "k": p.k, "v": p.v, "q_scales": p.q_scales,
               "k_scales": p.k_scales, "v_scales": p.v_scales}
    if p.corr is not None:
        tensors["score_corr"] = p.corr
    for name, t in zip(("qz", "qr", "kz", "kr", "vz"), p.asym or ()):
        tensors[name] = t
    for name, t in tensors.items():
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"quant_attn_fwd kernel needs every operand on one CUDA device; {name} is on {t.device}")
    for name in ("q", "k", "v"):
        if tensors[name].dtype != torch.int8:
            raise ValueError(f"quant_attn_fwd kernel needs int8 {name}")
    if p.bias is not None and p.bias.device != dev:
        raise ValueError(f"bias on {p.bias.device}, q on {dev}")
    b, hq, sq, _ = p.q.shape
    _, hkv, sk, _ = p.k.shape
    d = p.d
    refuse_wide("the quant_attn_fwd kernel", d)
    walk = walk_args(p.walk, "fetch_kv", dev)
    if p.pv_group and p.walk is not None and p.pv_group < sk and p.walk.block_k % 32:
        # The walk's tiles start at each map tile's first key; a 32-key step
        # must not cross a change of V's scale.
        raise ValueError(f"pv_int8 under a block-sparse map needs block_k % 32 == 0, got "
                         f"{p.walk.block_k}")
    q, k, v = p.q, p.k, p.v
    int4 = p.int4
    dk = d  # the head dim the kernel sees
    if d % 4 or (any(int4) and d % 8):
        # Rows of zero codes to the next multiple of 16: exact zeros in the
        # s32 dot products, and V columns that are sliced off; the row
        # scales are unchanged. INT4 codes are unpacked here first: the
        # kernel unpacks whole 4-byte words of packed codes (D % 8 == 0),
        # and the split halves of another width do not pad.
        dk = -(-d // 16) * 16 if d % 4 else d
        q, k, v = (torch.nn.functional.pad(x, (0, dk - d)) for x in _unpacked(p))
        int4 = (False, False, False)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 4:
            raise ValueError(f"quant_attn_fwd kernel needs a 4-byte aligned {name}")
    out = torch.empty((b, hq, sq, dk), dtype=torch.float32, device=dev)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out[..., :d], lse

    def ptr(t):
        return None if t is None else t.data_ptr()

    # Keep the contiguous copies alive through the launch.
    flat = [t.contiguous() for t in (q, k, v, p.q_scales, p.k_scales, p.v_scales)]
    extra = [None if t is None else t.contiguous() for t in (p.corr, *(p.asym or (None,) * 5))]
    fn = _kernels.function("quant_attn_fwd", "umfa_quant_attn_fwd", _ARGTYPES)
    bsb, bsh, bsq, bsk = bias_strides(p.bias)
    with torch.cuda.device(dev):
        err = fn(
            *(t.data_ptr() for t in flat),
            None if p.bias is None else p.bias.data_ptr(),
            *(ptr(t) for t in extra),
            out.data_ptr(), lse.data_ptr(),
            b, hq, hkv, sq, sk, dk,
            int(p.q_scales.shape[2] > 1), int(p.k_scales.shape[2] > 1),
            int(p.v_scales.shape[2] > 1),
            bsb, bsh, bsq, bsk, p.left, p.right,
            int(int4[0]) | 2 * int(int4[1]) | 4 * int(int4[2]), d, *walk, int(p.pv_group > 0),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _kernels.check("quant_attn_fwd", err)
    if p.pv_group:
        _kernels.launches["quant_attn_fwd/pv"] += 1
    return (out if dk == d else out[..., :d].contiguous()), lse


# ---- The STE route: quantized_flash_attention (quant_attention.py:597-1095) ----


def _corr_from_quantized(qm: torch.Tensor, qt_k: QuantizedTensor) -> torch.Tensor:
    """The Q-mean score row from the quantized K, corr_j = sk_j (qm ·
    code_k_j), (B, Hq, 1, Sk) in raw dot units (quant_attention.py:597-618).
    Computed in float64 and rounded once, so no TF32 setting reaches it."""
    k_i8 = qt_k.values
    if qt_k.precision == Precision.INT4:
        k_i8 = unpack_int4(k_i8)
    b, hq, _, d = qm.shape
    hkv, sk = qt_k.orig_shape[1], qt_k.orig_shape[2]
    cint = torch.matmul(qm.reshape(b, hkv, hq // hkv, d).double(),
                        k_i8.double().transpose(-1, -2)).float()
    return (cint * qt_k.scales.float().transpose(-1, -2)).reshape(b, hq, 1, sk)


def _quantize_operands(q, k, v, config: QuantizationConfig, v_tile_k: Optional[int] = None):
    """Runtime quantization with exact mean-smoothing compensation, for the
    two-pass route (quant_attention.py:621-742): true sequence means; ROW
    symmetric goes through the row quantizer (`ops/quant_fused.py`, the
    rotation and the mean subtraction inside it), other modes through
    `ops/quant.quantize` on fp32-smoothed operands. Under pv_int8 V is
    quantized BLOCK-wise per `v_tile_k` rows (the reference's KV tile) of
    v − vm in fp32. Returns (qt_q, qt_k, qt_v, qm, vm, corr); qm/vm/corr
    are None without smoothing."""
    if config.pv_int8 and v_tile_k is None:
        raise ValueError("pv_int8 quantizes V per KV tile: pass v_tile_k")
    use_fused = config.strategy == QuantStrategy.SYMMETRIC and config.mode == QuantMode.ROW
    if config.hadamard and not use_fused:
        q, k = hadamard_rotate(q), hadamard_rotate(k)
    orig_dtypes = (q.dtype, k.dtype, v.dtype)
    qm = vm = km = corr = None
    if config.smooth:
        if config.effective_smooth_q():
            qm = q.float().mean(dim=2, keepdim=True)
        km = k.float().mean(dim=2, keepdim=True)
        vm = v.float().mean(dim=2, keepdim=True)
    if use_fused:
        if config.hadamard and config.smooth:
            # mean(x·H) = mean(x)·H: the means enter the quantizer after its
            # rotation (quant_attention.py:673-679).
            qm = None if qm is None else hadamard_rotate(qm)
            km = hadamard_rotate(km)
        qt_q = quantize_rows_fused(q, qm, precision=config.q_precision, hadamard=config.hadamard)
        qt_k = quantize_rows_fused(k, km, precision=config.k_precision, hadamard=config.hadamard)
        if config.pv_int8:
            v_in = v.float() - vm if vm is not None else v
            qt_v = quantize(v_in, config.v_precision, QuantMode.BLOCK, config.strategy, v_tile_k)
            qt_v.orig_dtype = orig_dtypes[2]
        else:
            qt_v = quantize_rows_fused(v, vm, precision=config.v_precision)
        if qm is not None:
            corr = _corr_from_quantized(qm, qt_k)
        return qt_q, qt_k, qt_v, qm, vm, corr
    if config.smooth:
        # fp32 smoothed operands: rounding x − mean back to bf16 would add a
        # second rounding on top of quantization.
        k, v = k.float() - km, v.float() - vm
        if qm is not None:
            q = q.float() - qm
            b, hq, _, d = qm.shape
            hkv = k.shape[1]
            corr = torch.matmul(qm.reshape(b, hkv, hq // hkv, d).double(),
                                k.double().transpose(-1, -2)).float().reshape(b, hq, 1, k.shape[2])
    bs = config.block_sizes
    qt_q = quantize(q, config.q_precision, config.mode, config.strategy, bs.q)
    qt_k = quantize(k, config.k_precision, config.mode, config.strategy, bs.k)
    if config.pv_int8:
        qt_v = quantize(v, config.v_precision, QuantMode.BLOCK, config.strategy, v_tile_k)
    else:
        qt_v = quantize(v, config.v_precision, config.mode, config.strategy, bs.v)
    qt_q.orig_dtype, qt_k.orig_dtype, qt_v.orig_dtype = orig_dtypes
    return qt_q, qt_k, qt_v, qm, vm, corr


def _try_fused_single_launch(q, k, v, bias, config, causal, window, scale, out_dtype,
                             emit_residuals: bool, walk: Optional[Walk] = None,
                             bias_grad: bool = False):
    """The single-launch kernel where the reference's rules allow it
    (`fused_path_supported`); None sends the call to the two-pass route."""
    tables = {}
    if walk is not None:
        tables = dict(block_map=walk.block_map, fetch_kv=walk.fetch_kv, hold_kv=walk.hold_kv,
                      fill_kv=walk.fill_kv)
    if not fused_path_supported(config, k.shape[2], k.shape[3], causal=causal, window=window,
                                seq_q=q.shape[2], num_heads=q.shape[1], num_kv_heads=k.shape[1],
                                bias_grad=bias_grad, **tables):
        return None
    return _fused(
        q, k, v, bias, walk, causal=causal, window=window, scale=scale, smooth=config.smooth,
        smooth_q=config.effective_smooth_q(), hadamard=config.hadamard, pv_int8=config.pv_int8,
        emit_residuals=emit_residuals, q_precision=config.q_precision,
        k_precision=config.k_precision, v_precision=config.v_precision,
        strategy=config.strategy, mode=config.mode, quant_blocks=config.block_sizes,
        out_dtype=out_dtype or q.dtype)


def _require_integer_q(config) -> None:
    """A dense Q exists only in the single-launch kernel (the two-pass
    quantizer has no passthrough stream): fail loudly rather than quantize Q."""
    if not config.q_precision.is_integer:
        raise ValueError(
            f"q_precision={config.q_precision.value} (dense-Q) requires the fused "
            "single-launch path, but this call goes to the two-pass kernels "
            "(see fused_path_supported). Use an integer q_precision here.")


def _two_pass(q, k, v, bias, config, causal, window, scale, out_dtype,
              walk: Optional[Walk] = None):
    """Quantize, attend on the quantized operands, restore the V mean
    (quant_attention.py:845-880)."""
    _require_integer_q(config)
    v_tile_k = None
    if config.pv_int8:
        # The reference's KV tile (quant_attention.py:845-856): its default
        # request, or the map's.
        v_tile_k = _choose_block(walk.block_k if walk is not None else BlockSizes().block_k,
                                 k.shape[2], k.shape[3])
    qt_q, qt_k, qt_v, qm, vm, corr = _quantize_operands(q, k, v, config, v_tile_k)
    out, lse = _quant_forward(qt_q, qt_k, qt_v, bias, corr, walk, causal=causal,
                              window=window, scale=scale, out_dtype=out_dtype or q.dtype,
                              pv_int8=config.pv_int8)
    if vm is not None:
        # out = P·v' + vm (softmax rows sum to 1), except rows with no
        # visible key, which keep their exact 0.
        vm_q = vm.repeat_interleave(out.shape[1] // vm.shape[1], dim=1)
        live = (lse > DEFAULT_MASK_VALUE * 0.5)[..., None]
        out = torch.where(live, out.float() + vm_q, 0.0).to(out.dtype)
    return out, lse, (qt_q, qt_k, qt_v, qm, vm)


def _forward(q, k, v, bias, config, causal, window, scale, out_dtype, emit_residuals,
             walk: Optional[Walk] = None, bias_grad: bool = False):
    fused = _try_fused_single_launch(q, k, v, bias, config, causal, window, scale, out_dtype,
                                     emit_residuals, walk, bias_grad)
    if fused is not None:
        out, lse, *res = fused
        return out, lse, tuple(res)
    return _two_pass(q, k, v, bias, config, causal, window, scale, out_dtype, walk)


def _dequantized(qt_q, qt_k, qt_v, qm, vm):
    """The operands the STE backward differentiates, fp32: deq(q') + qm,
    deq(k') (the K mean is softmax-invariant) and deq(v') + vm."""
    f32 = torch.float32
    q_dq, k_dq, v_dq = (dequantize(t, f32) for t in (qt_q, qt_k, qt_v))
    if qm is not None:
        q_dq = q_dq + qm
    if vm is not None:
        v_dq = v_dq + vm
    return q_dq, k_dq, v_dq


class _QFlash(torch.autograd.Function):
    """(q, k, v, bias) → (out, lse) with the STE backward. Saves only the
    residuals: int8/int4 values with their scales, qm, vm, bias, out and
    lse, plus the raw Q for a dense Q; never the raw q, k and v (the
    training-memory point of the reference, quant_attention.py:875-876).
    A block-sparse `walk` reaches every backward route."""

    @staticmethod
    def forward(ctx, q, k, v, bias, config, causal, window, scale, out_dtype, bias_grad, walk):
        out, lse, res = _forward(q, k, v, bias, config, causal, window, scale, out_dtype, True,
                                 walk, bias_grad)
        qt_q, qt_k, qt_v, qm, vm = res
        dense_q = q if qt_q is None else None
        ctx.save_for_backward(dense_q, bias, out, lse)
        ctx.res = (qt_q, qt_k, qt_v, qm, vm)
        ctx.attn = dict(causal=causal, window=window, scale=scale)
        ctx.config, ctx.bias_grad, ctx.walk = config, bias_grad, walk
        ctx.in_dtypes = (q.dtype, k.dtype, v.dtype)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    @once_differentiable
    def backward(ctx, g_out, g_lse):
        dense_q, bias, out, lse = ctx.saved_tensors
        qt_q, qt_k, qt_v, qm, vm = ctx.res
        if g_out is None and g_lse is None:
            return (None,) * 11
        if g_out is None:
            g_out = torch.zeros_like(out)
        f32 = torch.float32
        if dense_q is not None:
            # The dense backward on (q, deq k', deq v' + vm) with the
            # quantized forward's out and lse: the function the forward
            # computed (the K mean is softmax-invariant). As in the
            # reference, Q enters unrotated.
            q_dq = dense_q.float()
            k_dq = dequantize(qt_k, f32)
            v_dq = dequantize(qt_v, f32)
            if vm is not None:
                v_dq = v_dq + vm
            dq, dk, dv = flash_backward(q_dq, k_dq, v_dq, out.float(), lse, g_out.float(), bias,
                                        g_lse, grad_dtype=None, walk=ctx.walk, **ctx.attn)
        elif qt_q.strategy == QuantStrategy.ASYMMETRIC:
            # Zero-point corrections in the backward's products are not
            # worth their complexity: the dense backward on the dequantized
            # operands, as the reference does (quant_attention.py:937-950).
            q_dq, k_dq, v_dq = _dequantized(qt_q, qt_k, qt_v, qm, vm)
            dq, dk, dv = flash_backward(q_dq, k_dq, v_dq, out.float(), lse, g_out.float(), bias,
                                        g_lse, grad_dtype=None, walk=ctx.walk, **ctx.attn)
        else:
            corr = None if qm is None else _corr_from_quantized(qm, qt_k)
            gdt = torch.bfloat16 if qt_q.orig_dtype == torch.bfloat16 else None
            dq, dk, dv = quantized_backward(qt_q, qt_k, qt_v, out, lse, g_out, qm, vm, corr, bias,
                                            g_lse, grad_dtype=gdt, walk=ctx.walk, **ctx.attn)
        if ctx.config.hadamard:
            # Gradients in the rotated space rotate back (self-inverse).
            dq, dk = hadamard_rotate(dq), hadamard_rotate(dk)
        dbias = None
        if bias is not None and ctx.needs_input_grad[3]:
            if ctx.bias_grad:
                if dense_q is None and qt_q.strategy == QuantStrategy.SYMMETRIC:
                    q_dq, k_dq, v_dq = _dequantized(qt_q, qt_k, qt_v, qm, vm)
                b4 = bias
                while b4.dim() < 4:
                    b4 = b4[None]
                full = b4.expand(*b4.shape[:2], q_dq.shape[2], b4.shape[3])
                dbias = flash_attention_bias_grad(q_dq, k_dq, v_dq, out.float(), lse,
                                                  g_out.float(), full, **ctx.attn)
                if b4.shape[2] != q_dq.shape[2]:
                    dbias = dbias.sum(dim=2, keepdim=True)
                dbias = dbias.reshape(bias.shape).to(bias.dtype)
            else:
                dbias = torch.zeros_like(bias)
        qd, kd, vd = ctx.in_dtypes
        return (dq.to(qd), dk.to(kd), dv.to(vd), dbias) + (None,) * 7


def quantized_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    config: QuantizationConfig = QuantizationConfig(),
    causal: bool = False,
    window: Optional[tuple] = None,
    scale: Optional[float] = None,
    block_mask=None,
    out_dtype: Optional[torch.dtype] = None,
    return_lse: bool = False,
    bias_grad: bool = False,
):
    """Runtime-quantized attention, differentiable through the STE backward.
    q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D); bias additive, broadcastable
    to (B, Hq, Sq, Sk); block_mask: a BlockMask (ops/block_mask.py) on q's
    device instead of a bias: its bias, its walk (forward and backward, on
    either route) and its tiles (the reference's, for the fused route's
    means windows and BLOCK groups). Returns out (out_dtype, default
    q.dtype), or (out, lse) with return_lse=True. Gradients reach q, k, v
    and, with bias_grad=True, the bias (else it gets zeros). HYBRID mode is
    resolved from q's data (it may pick TENSOR, ROW or BLOCK); pv_int8 with
    ASYMMETRIC raises ValueError."""
    walk = None
    if block_mask is not None:
        if bias is not None:
            raise ValueError("pass either bias or block_mask, not both")
        bias, walk = block_mask.bias, block_mask.walk()
    if config.mode == QuantMode.HYBRID:
        config = dataclasses.replace(config, mode=choose_mode(q))
    require_symmetric_pv(config)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (q, k, v, bias)):
        out, lse = _QFlash.apply(q, k, v, bias, config, causal, window, scale, out_dtype,
                                 bias_grad, walk)
    else:
        # No gradient needed: the kernel writes no residuals.
        out, lse, _ = _forward(q, k, v, bias, config, causal, window, scale, out_dtype, False,
                               walk, bias_grad)
    return (out, lse) if return_lse else out
