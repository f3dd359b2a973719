"""Quantized attention forward on pre-quantized INT8 operands (port of
umfa_tpu/ops/quant_attention.py:295 `quantized_attention_forward`).

`quantized_attention_forward` launches the CUDA kernel
`csrc/quant_attn_fwd.cu` on CUDA tensors and runs
`quantized_attention_forward_plain`, the same arithmetic in plain PyTorch,
on CPU tensors; no fallback between them.

Arithmetic (quant_attention.py:166-256): s = int32(q_i8 · k_i8) ·
(q_scale · softmax_scale) · k_scale + bias, index mask → -1e30,
P = exp(s - m) against the row max m, the FP32 row sum of P, P·V on
bf16(P) and the dequantized V tile bf16(bf16(v_i8) · bf16(v_scale)) with
FP32 accumulation; FP32 output. The kernel finds m in a first pass, so it
rounds P where this plain version does (the reference's one-pass kernel
rounds relative to a running max; where it walks a single KV tile, as in
the parity tests, that is the same point). Masking semantics are those of
ops/flash_fwd.py.

Supported: symmetric INT8 with per-row (ROW/BLOCK) or per-tensor scales,
bias, causal/window, GQA. Not ported yet (raise NotImplementedError):
INT4 operands, ASYMMETRIC, `score_corr`, `pv_int8`, `block_map`/`fetch_ids`.
The STE/fused route `quantized_flash_attention` is not in this slice.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from umfa_tpu_torch import _kernels
from umfa_tpu_torch.engine.config import Precision, QuantStrategy
from umfa_tpu_torch.ops.flash_fwd import (
    DEFAULT_MASK_VALUE,
    bias_strides,
    broadcast_bias,
    check_no_grad,
    fold_mask,
    visible_mask,
)
from umfa_tpu_torch.ops.quant import QuantizedTensor

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
             _I, _I, _I, _L, _L, _L, _L, _I, _I, _P)


class _Prepared(NamedTuple):
    q: torch.Tensor        # int8 (B, Hq, Sq, D)
    k: torch.Tensor        # int8 (B, Hkv, Sk, D)
    v: torch.Tensor
    q_scales: torch.Tensor  # f32 (B, Hq, Sq|1, 1), softmax scale folded in
    k_scales: torch.Tensor  # f32 (B, Hkv, Sk|1, 1)
    v_scales: torch.Tensor
    bias: Optional[torch.Tensor]
    left: int
    right: int
    out_dtype: torch.dtype


def _scales(t: torch.Tensor, b: int, h: int, s: int, name: str) -> torch.Tensor:
    if t.dim() != 4 or tuple(t.shape[:2]) != (b, h) or t.shape[2] not in (1, s) or t.shape[3] != 1:
        raise ValueError(f"{name} scales of shape {tuple(t.shape)}; expected ({b}, {h}, {s} or 1, 1)")
    return t.float()


def _prepare(qt_q, qt_k, qt_v, bias, score_corr, block_map, fetch_ids,
             causal, window, scale, out_dtype, pv_int8) -> _Prepared:
    for qt in (qt_q, qt_k, qt_v):
        if qt.precision != Precision.INT8:
            raise NotImplementedError("INT4 operands are not ported yet")
        if qt.strategy != QuantStrategy.SYMMETRIC:
            raise NotImplementedError("ASYMMETRIC quantization is not ported yet")
    if score_corr is not None:
        raise NotImplementedError("score_corr (Q-mean smoothing) is not ported yet")
    if pv_int8:
        raise NotImplementedError("pv_int8 (integer P·V) is not ported yet")
    if block_map is not None or fetch_ids is not None:
        raise NotImplementedError("block-sparse block_map/fetch_ids are not ported yet")
    b, hq, sq, _ = qt_q.orig_shape
    _, hkv, sk, d = qt_k.orig_shape
    q, k, v = qt_q.values, qt_k.values, qt_v.values
    if tuple(q.shape) != (b, hq, sq, d) or tuple(k.shape) != (b, hkv, sk, d) or v.shape != k.shape:
        raise ValueError(f"value shapes {tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)} do not match orig_shape")
    if hq % hkv:
        raise ValueError(f"q heads {hq} must be a multiple of kv heads {hkv}")
    if scale is None:
        scale = d**-0.5
    # Softmax scale folded into the Q scales (quant_attention.py:359-363).
    q_scales = _scales(qt_q.scales, b, hq, sq, "q") * scale
    k_scales = _scales(qt_k.scales, b, hkv, sk, "k")
    v_scales = _scales(qt_v.scales, b, hkv, sk, "v")
    if bias is not None:
        while bias.dim() < 4:
            bias = bias[None]
        bias = broadcast_bias(bias, b, hq, sq, sk)
    left, right = fold_mask(causal, window)
    return _Prepared(q, k, v, q_scales, k_scales, v_scales, bias, left, right, out_dtype)


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
):
    """Quantized attention on pre-quantized operands. Returns
    (out (B, Hq, Sq, D) in out_dtype, lse (B, Hq, Sq) float32)."""
    check_no_grad("quantized_attention_forward", qt_q.values, qt_q.scales,
                  qt_k.values, qt_k.scales, qt_v.values, qt_v.scales, bias)
    p = _prepare(qt_q, qt_k, qt_v, bias, score_corr, block_map, fetch_ids,
                 causal, window, scale, out_dtype, pv_int8)
    if p.q.device.type == "cpu":
        out, lse = _plain(p)
    else:
        out, lse = _launch(p)
    return out.to(p.out_dtype), lse


def quantized_attention_forward_plain(
    qt_q, qt_k, qt_v, bias=None, score_corr=None, block_map=None, fetch_ids=None,
    *, causal=False, window=None, scale=None, out_dtype=torch.float32, pv_int8=False,
):
    """The kernel's arithmetic in plain PyTorch, on any device. Same
    arguments and results as `quantized_attention_forward`."""
    p = _prepare(qt_q, qt_k, qt_v, bias, score_corr, block_map, fetch_ids,
                 causal, window, scale, out_dtype, pv_int8)
    out, lse = _plain(p)
    return out.to(p.out_dtype), lse


def _plain(p: _Prepared):
    b, hq, sq, d = p.q.shape
    _, hkv, sk, _ = p.k.shape
    g = hq // hkv
    # Integer dot in fp32: every partial sum of int8 products is an integer
    # below 2^24 for D <= 1024, so it is exact (even under TF32).
    s = torch.matmul(p.q.float().reshape(b, hkv, g * sq, d), p.k.float().transpose(-1, -2))
    s = s.reshape(b, hq, sq, sk)
    s.mul_(p.q_scales).mul_(p.k_scales.repeat_interleave(g, dim=1).transpose(-1, -2))
    if p.bias is not None:
        s += p.bias
    hidden = ~visible_mask(sq, sk, p.left, p.right, s.device)
    s.masked_fill_(hidden, DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True).clamp_min(DEFAULT_MASK_VALUE)
    s.sub_(m).exp_().masked_fill_(hidden, 0.0)
    l = s.sum(dim=-1)
    pb = s.to(torch.bfloat16)
    del s
    v_deq = (p.v.to(torch.bfloat16) * p.v_scales.to(torch.bfloat16)).float()
    pv = torch.matmul(pb.float().reshape(b, hkv, g * sq, sk), v_deq).reshape(b, hq, sq, d)
    empty = l == 0
    l_safe = torch.where(empty, torch.ones_like(l), l)
    out = pv / l_safe[..., None]
    lse = torch.where(empty, torch.full_like(l, DEFAULT_MASK_VALUE),
                      m[..., 0] + torch.log(l_safe))
    return out, lse


def _launch(p: _Prepared):
    dev = p.q.device
    tensors = {"q": p.q, "k": p.k, "v": p.v, "q_scales": p.q_scales,
               "k_scales": p.k_scales, "v_scales": p.v_scales}
    for name, t in tensors.items():
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"quant_attn_fwd kernel needs every operand on one CUDA device; {name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"quant_attn_fwd kernel needs a contiguous {name}")
    for name in ("q", "k", "v"):
        if tensors[name].dtype != torch.int8:
            raise ValueError(f"quant_attn_fwd kernel needs int8 {name}")
        if tensors[name].data_ptr() % 4:
            raise ValueError(f"quant_attn_fwd kernel needs a 4-byte aligned {name}")
    if p.bias is not None and p.bias.device != dev:
        raise ValueError(f"bias on {p.bias.device}, q on {dev}")
    b, hq, sq, d = p.q.shape
    _, hkv, sk, _ = p.k.shape
    if d > 128 or d % 4:
        raise ValueError(f"quant_attn_fwd kernel takes head_dim <= 128 and a multiple of 4, got {d}")
    out = torch.empty((b, hq, sq, d), dtype=torch.float32, device=dev)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out, lse
    fn = _kernels.function("quant_attn_fwd", "umfa_quant_attn_fwd", _ARGTYPES)
    bsb, bsh, bsq, bsk = bias_strides(p.bias)
    with torch.cuda.device(dev):
        err = fn(
            p.q.data_ptr(), p.k.data_ptr(), p.v.data_ptr(),
            p.q_scales.data_ptr(), p.k_scales.data_ptr(), p.v_scales.data_ptr(),
            None if p.bias is None else p.bias.data_ptr(),
            out.data_ptr(), lse.data_ptr(),
            b, hq, hkv, sq, sk, d,
            int(p.q_scales.shape[2] > 1), int(p.k_scales.shape[2] > 1),
            int(p.v_scales.shape[2] > 1),
            bsb, bsh, bsq, bsk, p.left, p.right,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _kernels.check("quant_attn_fwd", err)
    return out, lse
