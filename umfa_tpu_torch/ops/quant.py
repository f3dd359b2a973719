"""Runtime quantization: INT8 / INT4, tensor-/row-/block-wise, sym/asym
(port of umfa_tpu/ops/quant.py; plain tensor math, no kernel).

Granularities: TENSOR (one scale per (batch, head) slice), ROW (one per
token row), BLOCK (one per block of sequence rows, broadcast back to a
per-row view). SYMMETRIC has zero_point 0; ASYMMETRIC keeps an int32
zero point (not clipped) plus int32 row sums for the kernels' corrections.

INT4 packing is split-halves along the last dim: byte j holds element j
(low nibble) and element j + D/2 (high nibble).

Rounding follows the reference exactly: round half to even, division by
the scale (not multiplication by its reciprocal), clip to [-qmax-1, qmax];
INT8 values come out bit-identical to the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from umfa_tpu_torch.engine.config import Precision, QuantMode, QuantStrategy


@dataclasses.dataclass
class QuantizedTensor:
    """Quantized array + scale metadata.

    values: int8; for INT4, packed (last dim halved, split-halves).
    scales: FP32, broadcastable against the unquantized shape.
    zero_points: int32 like scales, or None (symmetric).
    row_sums: int32 per-row sums of quantized values, or None.
    """

    values: torch.Tensor
    scales: torch.Tensor
    zero_points: Optional[torch.Tensor]
    row_sums: Optional[torch.Tensor]
    precision: Precision
    mode: QuantMode
    strategy: QuantStrategy
    block_size: int
    orig_shape: tuple
    orig_dtype: torch.dtype

    @property
    def compression_ratio(self) -> float:
        orig_bytes = 1
        for dim in self.orig_shape:
            orig_bytes *= dim
        orig_bytes *= torch.empty((), dtype=self.orig_dtype).element_size()
        q_bytes = self.values.numel() * self.values.element_size()
        q_bytes += self.scales.numel() * 4
        if self.zero_points is not None:
            q_bytes += self.zero_points.numel() * 4
        return orig_bytes / q_bytes


def _qmax(precision: Precision) -> int:
    return 127 if precision == Precision.INT8 else 7


def _group_reduce(x, mode: QuantMode, block_size: int, reduce_fn):
    """Reduce over the quantization group. x: (..., S, D) FP32; returns
    stats broadcastable to x. reduce_fn(t, dims) reduces with keepdim."""
    if mode == QuantMode.TENSOR:
        return reduce_fn(x, (-1, -2))
    if mode == QuantMode.ROW:
        return reduce_fn(x, (-1,))
    if mode == QuantMode.BLOCK:
        *lead, s, d = x.shape
        nb = -(-s // block_size)
        pad = nb * block_size - s
        if pad:
            # Pad with edge values so padding never dominates the stats.
            x = torch.cat([x, x[..., -1:, :].expand(*lead, pad, d)], dim=-2)
        xb = x.reshape(*lead, nb, block_size, d)
        stat = reduce_fn(xb, (-1, -2))  # (..., nb, 1, 1)
        stat = stat.expand(*lead, nb, block_size, 1).reshape(*lead, nb * block_size, 1)
        return stat[..., :s, :]  # (..., S, 1) per-row view of per-block stat
    raise ValueError(f"unsupported mode {mode}")


def _amax(t, dims):
    return torch.amax(t, dim=dims, keepdim=True)


def _amin(t, dims):
    return torch.amin(t, dim=dims, keepdim=True)


def choose_mode(x: torch.Tensor, block_size: int = 64) -> QuantMode:
    """HYBRID auto-selection from the data: TENSOR when the per-row absmax
    varies little, BLOCK when it varies strongly, else ROW. (Eager torch
    always sees the data, as the JAX reference does when called eagerly.)"""
    absmax_rows = torch.amax(x.abs().float(), dim=-1)
    ratio = absmax_rows.max() / torch.clamp(absmax_rows.mean(), min=1e-12)
    r = float(ratio)
    if r < 2.0:
        return QuantMode.TENSOR
    if r < 16.0:
        return QuantMode.ROW
    return QuantMode.BLOCK


def pack_int4(x_i8: torch.Tensor) -> torch.Tensor:
    """Pack int8 values in [-8, 7] into nibbles, split-halves layout."""
    d = x_i8.shape[-1]
    if d % 2:
        raise ValueError("INT4 packing requires an even last dim")
    x = x_i8.to(torch.int32)
    byte = (x[..., : d // 2] & 0xF) | ((x[..., d // 2:] & 0xF) << 4)  # 0..255
    return torch.where(byte > 127, byte - 256, byte).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_int4 (int32 nibble math, sign-extending)."""
    p = packed.to(torch.int32)
    low = ((p & 0xF) ^ 8) - 8
    high = p >> 4  # arithmetic shift of the sign-extended byte
    return torch.cat([low, high], dim=-1).to(torch.int8)


def quantize(
    x: torch.Tensor,
    precision: Precision = Precision.INT8,
    mode: QuantMode = QuantMode.ROW,
    strategy: QuantStrategy = QuantStrategy.SYMMETRIC,
    block_size: int = 64,
) -> QuantizedTensor:
    """Quantize x (..., S, D) on its own device."""
    if mode == QuantMode.HYBRID:
        mode = choose_mode(x, block_size)
    orig_shape, orig_dtype = tuple(x.shape), x.dtype
    xf = x.float()
    qmax = _qmax(precision)

    if strategy == QuantStrategy.SYMMETRIC:
        absmax = _group_reduce(xf.abs(), mode, block_size, _amax)
        scale = torch.clamp(absmax, min=1e-12) / qmax
        q = torch.clamp(torch.round(xf / scale), -qmax - 1, qmax).to(torch.int8)
        zp = None
    else:
        hi = _group_reduce(xf, mode, block_size, _amax)
        lo = _group_reduce(xf, mode, block_size, _amin)
        scale = torch.clamp(hi - lo, min=1e-12) / (2 * qmax + 1)
        # zp is int32 and applied after the integer matmul: not clipped.
        zp = torch.round(-lo / scale).to(torch.int32) - (qmax + 1)
        q = torch.clamp(
            torch.round(xf / scale) + zp.float(), -qmax - 1, qmax
        ).to(torch.int8)

    row_sums = None
    if strategy == QuantStrategy.ASYMMETRIC:
        row_sums = q.to(torch.int32).sum(dim=-1, keepdim=True, dtype=torch.int32)

    if precision == Precision.INT4:
        q = pack_int4(q)

    return QuantizedTensor(
        values=q,
        scales=scale.float(),
        zero_points=zp,
        row_sums=row_sums,
        precision=precision,
        mode=mode,
        strategy=strategy,
        block_size=block_size,
        orig_shape=orig_shape,
        orig_dtype=orig_dtype,
    )


def dequantize(qt: QuantizedTensor, dtype=None) -> torch.Tensor:
    """Exact dequantization."""
    vals = qt.values
    if qt.precision == Precision.INT4:
        vals = unpack_int4(vals)
    vf = vals.float()
    if qt.zero_points is not None:
        vf = vf - qt.zero_points.float()
    return (vf * qt.scales).to(dtype or qt.orig_dtype)


def fake_quantize(
    x: torch.Tensor,
    precision: Precision = Precision.INT8,
    mode: QuantMode = QuantMode.ROW,
    strategy: QuantStrategy = QuantStrategy.SYMMETRIC,
    block_size: int = 64,
) -> torch.Tensor:
    """quantize → dequantize round trip in x's dtype."""
    return dequantize(quantize(x, precision, mode, strategy, block_size), x.dtype)
