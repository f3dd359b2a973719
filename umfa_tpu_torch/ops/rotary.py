"""RoPE angle tables and the rotation with its exact inverse (port of
umfa_tpu/ops/rope.py's `rope_angles` and `apply_rope`).

A leaf module: the forward kernel's plain version (ops/flash_fwd.py) rotates
with `apply_rope`, and ops/rope.py composes that kernel into
`rope_attention`, so the rotation lives below both.
"""

from __future__ import annotations

import torch

from umfa_tpu_torch.utils.device import default_device


def rope_angles(seq_len: int, head_dim: int, base: float = 10000.0,
                dtype=torch.float32, device=None):
    """Standard RoPE angle table: (cos, sin), each (seq, head_dim // 2), on
    `device` (default the card, as every entry point: pass device="cpu"
    for the plain path)."""
    device = default_device(device)
    inv_freq = 1.0 / (
        base ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                 / head_dim)
    )
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, *,
               negate_sin: bool = False, interleaved: bool = True) -> torch.Tensor:
    """Rotate x (..., S, D) by the angle tables (S, D/2), FP32 math.

    `interleaved=True` pairs features (0::2, 1::2); False pairs the two
    halves (rotate-half). `negate_sin=True` applies the exact inverse."""
    orig_dtype = x.dtype
    xf = x.float()
    cos = cos.float()
    sin = (-sin if negate_sin else sin).float()
    if interleaved:
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        r1 = x1 * cos - x2 * sin
        r2 = x1 * sin + x2 * cos
        out = torch.stack([r1, r2], dim=-1).reshape(xf.shape)
    else:
        h = xf.shape[-1] // 2
        x1, x2 = xf[..., :h], xf[..., h:]
        r1 = x1 * cos - x2 * sin
        r2 = x1 * sin + x2 * cos
        out = torch.cat([r1, r2], dim=-1)
    return out.to(orig_dtype)
