"""Flash attention entry point and the CPU oracle (port of
umfa_tpu/ops/attention.py).

`flash_attention` is forward-only in this slice: it refuses inputs that
require grad (the backward kernels arrive with the training slice). The
reference's `window=` auto-tiling (`maybe_window_block_mask`) is TPU tile
scheduling; the port computes the same values with the kernel's index
math.
"""

from __future__ import annotations

from typing import Optional

import torch

from umfa_tpu_torch.ops.flash_fwd import flash_attention_forward


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    causal: bool = False,
    window: Optional[tuple] = None,
    scale: Optional[float] = None,
    out_dtype: Optional[torch.dtype] = None,
    return_lse: bool = False,
):
    """Fused flash attention. q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D)
    with Hq % Hkv == 0 (GQA); bias: additive, broadcastable. Returns out,
    or (out, lse) with return_lse=True."""
    out, lse = flash_attention_forward(
        q, k, v, bias, causal=causal, window=window, scale=scale,
        out_dtype=out_dtype,
    )
    return (out, lse) if return_lse else out


def reference_attention(q, k, v, bias=None, *, causal=False, window=None, scale=None):
    """Naive softmax(QKᵀ)V in fp32 (the tests' oracle): -inf masking,
    fully-masked rows → 0."""
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
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)  # fully-masked rows → 0
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
