"""Quantized GEMM ops: weight quantization for linear layers (port of
umfa_tpu/ops/gemm.py).

  * W8A16 / W4A16: int8 or packed int4 weights with per-output-channel
    scales, dequantized on load; bf16 activations, fp32 sums, then scales.
  * W8A8: activations quantized per row at run time, an exact integer
    product, then the outer product of the scales.
  * Mean-centering: w' = w − μ per column shrinks the quantization range;
    the exact correction rowsum(x) ⊗ μ is added back after the product.

The products are plain torch matmuls (the reference leaves them to XLA).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from umfa_tpu_torch.engine.config import Precision
from umfa_tpu_torch.ops.quant import pack_int4, unpack_int4

# W8A8 sums int8 × int8 products in float64: each product is at most 2**14
# in magnitude, so every partial sum is an exact integer while
# K · 2**14 <= 2**53.
_W8A8_MAX_K = 2**39


@dataclasses.dataclass
class QuantizedWeight:
    """int8 (or packed int4) weight (K, N) + per-column fp32 scales (1, N)
    and optional centering means (1, N)."""

    values: torch.Tensor
    scales: torch.Tensor
    means: Optional[torch.Tensor]
    precision: Precision
    orig_dtype: torch.dtype


def quantize_weight(w: torch.Tensor, precision: Precision = Precision.INT8, *,
                    center: bool = False) -> QuantizedWeight:
    """Quantize a (K, N) weight per output channel (column). INT4 codes are
    packed along K (split halves of the contraction dim), so K must be even."""
    if w.dim() != 2:
        raise ValueError(f"quantize_weight takes a (K, N) weight, got {tuple(w.shape)}")
    wf = w.float()
    means = None
    if center:
        means = wf.mean(dim=0, keepdim=True)
        wf = wf - means
    qmax = 127 if precision == Precision.INT8 else 7
    absmax = wf.abs().amax(dim=0, keepdim=True)
    scales = torch.clamp(absmax, min=1e-12) / qmax
    q = torch.clamp(torch.round(wf / scales), -qmax - 1, qmax).to(torch.int8)
    if precision == Precision.INT4:
        q = pack_int4(q.T).T
    return QuantizedWeight(values=q, scales=scales, means=means, precision=precision,
                           orig_dtype=w.dtype)


def _codes(qw: QuantizedWeight) -> torch.Tensor:
    """The (K, N) int8 codes (INT4 unpacked along K)."""
    return unpack_int4(qw.values.T).T if qw.precision == Precision.INT4 else qw.values


def dequantize_weight(qw: QuantizedWeight, dtype=None) -> torch.Tensor:
    w = _codes(qw).float() * qw.scales
    if qw.means is not None:
        w = w + qw.means
    return w.to(dtype or qw.orig_dtype)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product of int8 a (..., K) and int8 b (K, N), as
    float64 (the sums are exact integers: see _W8A8_MAX_K)."""
    if a.shape[-1] > _W8A8_MAX_K:
        raise ValueError(f"int8_matmul is exact for K <= {_W8A8_MAX_K}, got {a.shape[-1]}")
    return torch.matmul(a.double(), b.double())


def quantize_activations(x: torch.Tensor):
    """W8A8's run-time activation quantizer: x (..., K) per row, symmetric,
    127 → (int8 codes, fp32 scales (..., 1))."""
    xf = x.float()
    x_scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-12) / 127.0
    return torch.clamp(torch.round(xf / x_scale), -128, 127).to(torch.int8), x_scale


def quantized_matmul(x: torch.Tensor, qw: QuantizedWeight, *,
                     activation_precision: Optional[Precision] = None) -> torch.Tensor:
    """x (..., K) @ quantized weight (K, N) → (..., N) in x's dtype.

    activation_precision None (or not integer): W8A16/W4A16, the bf16
    activations against the codes with fp32 sums (the products of bf16
    values and int8 codes are exact in fp32), then the scales.
    Precision.INT8: W8A8, x quantized per row (symmetric, 127), the exact
    integer product of `int8_matmul` rounded to fp32 (as the reference's
    int32 sum is), then x_scale ⊗ scales."""
    vals = _codes(qw)
    if activation_precision is None or not activation_precision.is_integer:
        out = torch.matmul(x.to(torch.bfloat16).float(), vals.float()) * qw.scales
    else:
        x_q, x_scale = quantize_activations(x)
        out = int8_matmul(x_q, vals).float() * (x_scale * qw.scales)
    if qw.means is not None:
        # Centering restored: x @ (w' + μ) = x @ w' + rowsum(x) ⊗ μ.
        out = out + x.float().sum(dim=-1, keepdim=True) * qw.means
    return out.to(x.dtype)
