"""RoPE fused with flash attention (port of umfa_tpu/ops/rope.py). The
angle tables and the rotation (`rope_angles`, `apply_rope`) live in
ops/rotary.py, below the forward kernel's plain version, and are
re-exported here.

`rope_attention` composes the rotation with the flash kernels by one of the
reference's two routes (its rope.py:135-182):

  * in-kernel (`interleaved=False`, rotate-half pairing, no extra attention
    kwargs, even D): the forward passes the angle tables to
    `flash_attention_forward`, whose ROPE kernel rotates Q as it stages it
    and each K tile in shared memory, so rotated Q and K never reach device
    memory (ops/flash_fwd.py). The backward rotates Q and K again in plain
    PyTorch (rounded to their type), runs the dense backward kernels on
    them, and applies the exact inverse rotation (`negate_sin`) to dQ and
    dK;
  * two-pass (`interleaved=True`, a bias, a block_mask, any other kwarg):
    `apply_rope` on Q and K, then the differentiable `flash_attention`;
    autograd carries the gradients through the rotation.

Each call counts in the dispatch stats' `total` only, as the reference's
route names (`rope_fused_inkernel`, `rope_xla_two_pass`) are not among its
counted routes.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from umfa_tpu_torch.engine.stats import record_dispatch
from umfa_tpu_torch.ops.attention import flash_attention
from umfa_tpu_torch.ops.flash_bwd import _backward
from umfa_tpu_torch.ops.flash_fwd import _forward
from umfa_tpu_torch.ops.rotary import apply_rope, rope_angles

__all__ = ["apply_rope", "rope_angles", "rope_attention"]


class _RopeFlash(torch.autograd.Function):
    """(q, k, v, cos, sin) → out with the rotation inside the forward
    kernel; the backward of the reference's `_rope_flash` custom_vjp
    (rope.py:105-129). cos and sin take no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, causal, window, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = _forward(q, k, v, None, causal, window, scale, None, None, (cos, sin))
        ctx.save_for_backward(q, k, v, cos, sin, out, lse)
        ctx.attn = dict(causal=causal, window=window, scale=scale)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, cos, sin, out, lse = ctx.saved_tensors
        nq, nk = q.shape[-2], k.shape[-2]
        cq, sq = cos[:nq], sin[:nq]
        ck, sk = cos[:nk], sin[:nk]
        q_rot = apply_rope(q, cq, sq, interleaved=False)
        k_rot = apply_rope(k, ck, sk, interleaved=False)
        gdt = torch.bfloat16 if q.dtype == torch.bfloat16 else None
        dq, dk, dv = _backward(q_rot, k_rot, v, out, lse, g, None, None,
                               grad_dtype=gdt, walk=None, **ctx.attn)
        dq = apply_rope(dq, cq, sq, negate_sin=True, interleaved=False)
        dk = apply_rope(dk, ck, sk, negate_sin=True, interleaved=False)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None, None


def rope_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cos: Optional[torch.Tensor] = None,
    sin: Optional[torch.Tensor] = None,
    *,
    base: float = 10000.0,
    interleaved: bool = True,
    causal: bool = False,
    window: Optional[tuple] = None,
    scale: Optional[float] = None,
    **attention_kwargs,
) -> torch.Tensor:
    """RoPE(Q, K) → flash attention, differentiable, with the exact inverse
    rotation in the backward. q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D);
    cos, sin: (S >= max(Sq, Sk), D/2) angle tables (default
    `rope_angles(max(Sq, Sk), D, base)` on q's device).

    `interleaved=False` (rotate-half pairing, the LLaMA/GPT-NeoX convention)
    rotates inside the forward kernel; `interleaved=True` or any extra
    attention kwargs (bias, block_mask, ...) take the two-pass route (the
    module docstring)."""
    sq, sk, d = q.shape[-2], k.shape[-2], q.shape[-1]
    if cos is None or sin is None:
        cos, sin = rope_angles(max(sq, sk), d, base=base, device=q.device)
    if not interleaved and not attention_kwargs and d % 2 == 0:
        record_dispatch("rope_fused_inkernel")
        return _RopeFlash.apply(q, k, v, cos, sin, causal,
                                None if window is None else tuple(window), scale)
    record_dispatch("rope_xla_two_pass")
    q_rot = apply_rope(q, cos[:sq], sin[:sq], interleaved=interleaved)
    k_rot = apply_rope(k, cos[:sk], sin[:sk], interleaved=interleaved)
    return flash_attention(q_rot, k_rot, v, causal=causal, window=window, scale=scale,
                           **attention_kwargs)
