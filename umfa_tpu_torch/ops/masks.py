"""Mask canonicalization (port of umfa_tpu/ops/masks.py).

Bool and integer masks (nonzero = attend) become an fp32 additive bias of
{0, -1e30}; float masks are cast to fp32. Broadcast batch, head and query
dimensions stay at size 1 (the kernels read the bias through stride-0
dimensions), so no (B, H, Sq, Sk) tensor is materialized for them; a
size-1 key dimension is expanded.
"""

from __future__ import annotations

from typing import Optional

import torch

from umfa_tpu_torch.ops.flash_fwd import DEFAULT_MASK_VALUE


def canonicalize_mask(
    mask: Optional[torch.Tensor],
    batch: int,
    num_heads: int,
    seq_q: int,
    seq_k: int,
) -> Optional[torch.Tensor]:
    """A user mask as an fp32 additive bias of shape (Bm, Hm, Sqm, Sk), each
    of Bm, Hm, Sqm either 1 or full, or None."""
    if mask is None:
        return None
    if mask.dim() > 4:
        raise ValueError(f"mask must be ≤4-D, got shape {tuple(mask.shape)}")
    while mask.dim() < 4:
        mask = mask[None]
    for dim, full, name in zip(mask.shape, (batch, num_heads, seq_q, seq_k),
                               ("batch", "head", "seq_q", "seq_k")):
        if dim not in (1, full):
            raise ValueError(f"mask {name} dim {dim} not broadcastable to {full}")
    if mask.shape[3] == 1 and seq_k != 1:
        # Broadcasting along KV would mask everything or nothing per row.
        mask = mask.expand(*mask.shape[:3], seq_k)
    if not mask.is_floating_point():
        # Bool and byte masks are boolean-valued: nonzero = attend.
        zero = torch.zeros((), dtype=torch.float32, device=mask.device)
        return torch.where(mask != 0, zero, DEFAULT_MASK_VALUE)
    return mask.float()


def is_all_true(mask: Optional[torch.Tensor]) -> bool:
    """True for None and for an all-True bool mask (the all-True elision,
    reference: metal_sdpa_backend.cpp:1767-1784). Reads the mask's values:
    a CUDA mask costs one device sync."""
    if mask is None:
        return True
    return mask.dtype == torch.bool and bool(mask.all())
