"""Differentiable flash attention and the CPU oracle (port of
umfa_tpu/ops/attention.py).

`flash_attention` ties the forward (`ops/flash_fwd.py`) and the backward
(`ops/flash_bwd.py`) into one `torch.autograd.Function` returning
(out, lse), both differentiable: a cotangent on LSE folds into the
backward's δ. The forward saves (q, k, v, bias, out, lse) and the backward
recomputes P from LSE (the reference's `_flash` custom_vjp,
attention.py:40-108). The reference's `window=` auto-tiling
(`maybe_window_block_mask`) is TPU tile scheduling; the port's kernels
compute the same values with their index math. A `block_mask`
(ops/block_mask.py) gives the bias and the walk (`flash_fwd.Walk`) that
both passes take.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from umfa_tpu_torch.ops.flash_bwd import _backward, flash_attention_bias_grad
from umfa_tpu_torch.ops.flash_fwd import _forward, walked_keys


class _Flash(torch.autograd.Function):
    """(q, k, v, bias) → (out, lse) with the FA2 backward kernels; `walk`
    (a `flash_fwd.Walk` or None) is the block-sparse map and its tables."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, window, scale, out_dtype, bias_grad, walk):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = _forward(q, k, v, bias, causal, window, scale, out_dtype, walk)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.walk = walk
        ctx.attn = dict(causal=causal, window=window, scale=scale)
        ctx.bias_grad = bias_grad
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    @once_differentiable
    def backward(ctx, g_out, g_lse):
        q, k, v, bias, out, lse = ctx.saved_tensors
        if g_out is None and g_lse is None:
            return (None,) * 10
        if g_out is None:
            g_out = torch.zeros_like(out)
        # bf16 inputs: the kernels emit bf16 gradients (the consumer casts
        # anyway, attention.py:67-70); fp32 and fp16 get fp32 emission.
        gdt = torch.bfloat16 if q.dtype == torch.bfloat16 else None
        dq, dk, dv = _backward(q, k, v, out, lse, g_out, bias, g_lse, grad_dtype=gdt,
                               walk=ctx.walk, **ctx.attn)
        dbias = None
        if bias is not None and ctx.needs_input_grad[3]:
            if ctx.bias_grad:
                # A q-broadcast bias is expanded and its gradient summed
                # back over the queries (attention.py:85-98).
                full = bias.expand(*bias.shape[:-2], q.shape[2], bias.shape[-1])
                dbias = flash_attention_bias_grad(q, k, v, out, lse, g_out, full, **ctx.attn)
                if bias.shape[-2] != q.shape[2]:
                    dbias = dbias.sum(dim=2, keepdim=True)
                dbias = dbias.reshape(bias.shape).to(bias.dtype)
            else:
                # Masks are usually constants: zeros unless asked (the
                # reference's AttnConfig.bias_grad, attention.py:34-37).
                dbias = torch.zeros_like(bias)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias,
                None, None, None, None, None, None)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    causal: bool = False,
    window: Optional[tuple] = None,
    scale: Optional[float] = None,
    block_mask=None,
    out_dtype: Optional[torch.dtype] = None,
    return_lse: bool = False,
    bias_grad: bool = False,
):
    """Differentiable fused flash attention. q: (B, Hq, Sq, D); k, v:
    (B, Hkv, Sk, D) with Hq % Hkv == 0 (GQA); bias: additive, broadcastable
    to (B, Hq, Sq, Sk); block_mask: a BlockMask (ops/block_mask.py) on q's
    device, which gives the bias (pass one or the other) and the tiles
    each row walks. Returns out, or (out, lse) with return_lse=True.

    Gradients reach q, k, v through the backward kernels (fp32
    accumulation, cast back to the input types); bias_grad=True computes
    the real bias gradient, else the bias gets zeros."""
    walk = None
    if block_mask is not None:
        if bias is not None:
            raise ValueError("pass either bias or block_mask, not both")
        bias, walk = block_mask.bias, block_mask.walk()
    out, lse = _Flash.apply(q, k, v, bias, causal, window, scale, out_dtype, bias_grad, walk)
    return (out, lse) if return_lse else out


def reference_attention(q, k, v, bias=None, *, causal=False, window=None, scale=None,
                        walk=None):
    """Naive softmax(QKᵀ)V in fp32 (the tests' oracle): -inf masking,
    fully-masked rows → 0. walk: a block-sparse `flash_fwd.Walk` (a
    BlockMask's `walk()`); keys outside a row's walked tiles are masked
    too, so a row whose walked keys all carry the -1e30 bias averages V
    over exactly those keys, as the kernels do."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
    if scale is None:
        scale = d**-0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        while bias.dim() < 4:
            bias = bias[None]
        s = s + bias.float()
    q_ids = torch.arange(sq, device=q.device)[:, None]
    k_ids = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_ids <= q_ids
    if window is not None:
        left, right = window
        if left >= 0:
            mask &= k_ids >= q_ids - left
        if right >= 0:
            mask &= k_ids <= q_ids + right
    if walk is not None:
        mask = mask & walked_keys(walk, sq, sk)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)  # fully-masked rows → 0
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
