"""Blockwise Fast Walsh–Hadamard Transform, the pre-quantization rotation
(port of umfa_tpu/ops/hadamard.py; plain tensor math, no kernel).

`hadamard_rotate` is the reference's butterfly in fp32, normalized by
1/√N so it is self-inverse; `hadamard_matrix` is the ±1/√n Sylvester
matrix the quantizing kernels multiply by (umfa_tpu/ops/quant_fused.py:80-89).
Rotating both Q and K leaves QKᵀ unchanged and spreads outliers over the
row, which shrinks the per-row absmax before quantization.
"""

from __future__ import annotations

import numpy as np
import torch


def hadamard_rotate(x: torch.Tensor, block_size: int = 0, axis: int = -1) -> torch.Tensor:
    """Normalized FWHT along `axis`, in independent blocks of `block_size`
    (0 = the whole axis; a power of two). Computed in fp32, returned in
    x's dtype. hadamard_rotate(hadamard_rotate(x)) == x up to rounding."""
    axis = axis % x.dim()
    n = x.shape[axis]
    if block_size <= 0:
        block_size = n
    if n % block_size != 0:
        raise ValueError(f"axis length {n} not divisible by block {block_size}")
    if block_size & (block_size - 1):
        raise ValueError(f"block_size {block_size} must be a power of two")
    xt = x.movedim(axis, -1).float()
    lead = xt.shape[:-1]
    xt = xt.reshape(*lead, n // block_size, block_size)
    h = 1
    while h < block_size:
        xb = xt.reshape(*xt.shape[:-1], block_size // (2 * h), 2, h)
        a, b = xb[..., 0, :], xb[..., 1, :]
        xt = torch.stack([a + b, a - b], dim=-2).reshape(xt.shape)
        h *= 2
    xt = xt * block_size**-0.5
    return xt.reshape(*lead, n).movedim(-1, axis).to(x.dtype)


def hadamard_matrix(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Normalized Sylvester-Hadamard matrix (entries ±1/√n): entry (i, j)
    is (-1)^popcount(i & j) / √n, rounded once to `dtype`."""
    if n & (n - 1):
        raise ValueError(f"{n} must be a power of two")
    h = np.array([[1.0]])
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return torch.from_numpy(h * (n**-0.5)).to(device=device, dtype=dtype)
