"""One-pass ROW-wise symmetric quantizer (port of umfa_tpu/ops/quant_fused.py).

`quantize_rows_fused` launches the CUDA kernel `csrc/quant_rows.cu` on
CUDA tensors and runs `quantize_rows_fused_plain`, the same arithmetic in
plain PyTorch, on CPU tensors; no fallback between them.

Arithmetic, in order (quant_fused.py:46-73): the optional Hadamard
rotation x·H in fp32, minus the optional channel mean (given in the rotated
space), per-row absmax over D, scale = max(absmax, 1e-12) / qmax (an exact
division), clip(round_half_even(x / scale), -qmax-1, qmax), INT4 codes
packed split-halves (ops/quant.pack_int4). Without the rotation the plain
version is bit-identical to `ops.quant.quantize(x - mean)` in ROW mode;
the rotation is a float64 product rounded once to fp32, in the kernel too
(which sums it in another order, so a code may differ by one where the
double sum lands within ~1e-16 of an fp32 rounding boundary).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from umfa_tpu_torch import _kernels
from umfa_tpu_torch.engine.config import Precision, QuantMode, QuantStrategy
from umfa_tpu_torch.ops.flash_fwd import refuse_wide
from umfa_tpu_torch.ops.hadamard import hadamard_matrix
from umfa_tpu_torch.ops.quant import QuantizedTensor, _qmax, pack_int4

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P)
_IN_CODE = {torch.float32: 0, torch.bfloat16: 1}


def load_width(d: int, itemsize: int, x_ptr: int, mean_ptr: Optional[int] = None) -> int:
    """Elements of x one lane of the kernel loads at once: the widest of 16
    bytes, 8, 4, 2 or one element that divides the row length d and that
    x's address (itemsize bytes an element) and the fp32 mean's are aligned
    to (the mean is read in pieces of up to 16 bytes)."""
    vec = 16 // itemsize
    while vec > 1 and (d % vec or x_ptr % (vec * itemsize)
                       or (mean_ptr is not None and mean_ptr % (4 * min(vec, 4)))):
        vec //= 2
    return vec


def rotate(x: torch.Tensor) -> torch.Tensor:
    """x·H over the last dim as fp32, H with fp32 entries as the kernels
    use it: one rounding of the float64 product (never TF32, whatever the
    matmul settings)."""
    h = hadamard_matrix(x.shape[-1], torch.float32, x.device).double()
    return torch.matmul(x.double(), h).float()


def _check(x, mean, precision, hadamard):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, S, D), got shape {tuple(x.shape)}")
    d = x.shape[3]
    if precision not in (Precision.INT8, Precision.INT4):
        raise ValueError(f"precision must be INT8 or INT4, got {precision}")
    if precision == Precision.INT4 and d % 2:
        raise ValueError("INT4 packing requires an even head_dim")
    if hadamard and d & (d - 1):
        raise ValueError(f"the Hadamard rotation needs a power-of-two head_dim, got {d}")
    if mean is not None and tuple(mean.shape) != (x.shape[0], x.shape[1], 1, d):
        raise ValueError(f"mean of shape {tuple(mean.shape)}; expected {(x.shape[0], x.shape[1], 1, d)}")


def _result(x, vals, scales, precision) -> QuantizedTensor:
    return QuantizedTensor(
        values=vals, scales=scales, zero_points=None, row_sums=None,
        precision=precision, mode=QuantMode.ROW, strategy=QuantStrategy.SYMMETRIC,
        block_size=0, orig_shape=tuple(x.shape), orig_dtype=x.dtype,
    )


def quantize_rows_fused(
    x: torch.Tensor,
    mean: Optional[torch.Tensor] = None,
    *,
    precision: Precision = Precision.INT8,
    hadamard: bool = False,
) -> QuantizedTensor:
    """ROW-wise symmetric quantization in one pass. x: (B, H, S, D); mean:
    optional (B, H, 1, D) channel mean, subtracted after the rotation (so
    given in the rotated space when `hadamard`). Returns a QuantizedTensor
    with int8 values (packed (B, H, S, D/2) for INT4), fp32 scales
    (B, H, S, 1), and x's shape and dtype."""
    _check(x, mean, precision, hadamard)
    if x.device.type == "cpu":
        return quantize_rows_fused_plain(x, mean, precision=precision, hadamard=hadamard)
    return _launch(x, mean, precision, hadamard)


def quantize_rows_fused_plain(x, mean=None, *, precision=Precision.INT8, hadamard=False):
    """The kernel's arithmetic in plain PyTorch, on any device. Same
    arguments and result as `quantize_rows_fused`."""
    _check(x, mean, precision, hadamard)
    qmax = _qmax(precision)
    xf = rotate(x.float()) if hadamard else x.float()
    if mean is not None:
        xf = xf - mean.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    # A 0-dim tensor divisor: on CUDA `t / c` multiplies by 1/c, the kernel
    # divides exactly.
    scale = torch.clamp(absmax, min=1e-12) / absmax.new_tensor(float(qmax))
    q = torch.clamp(torch.round(xf / scale), -qmax - 1, qmax).to(torch.int8)
    if precision == Precision.INT4:
        q = pack_int4(q)
    return _result(x, q, scale, precision)


def _launch(x, mean, precision, hadamard) -> QuantizedTensor:
    dev = x.device
    if dev.type != "cuda" or (mean is not None and mean.device != dev):
        raise ValueError(f"quant_rows kernel needs x and mean on one CUDA device, got {dev}")
    b, h, s, d = x.shape
    refuse_wide("the quant_rows kernel", d)
    if x.dtype == torch.float16:
        x32 = x.float()  # fp16 is storage-only: read as fp32
    else:
        x32 = x
    if x32.dtype not in _IN_CODE:
        raise ValueError(f"quant_rows kernel takes fp32, bf16 or fp16, got {x.dtype}")
    x32 = x32.contiguous()
    mean32 = None if mean is None else mean.float().contiguous()
    int4 = precision == Precision.INT4
    vals = torch.empty((b, h, s, d // 2 if int4 else d), dtype=torch.int8, device=dev)
    scales = torch.empty((b, h, s, 1), dtype=torch.float32, device=dev)
    if x.numel():
        fn = _kernels.function("quant_rows", "umfa_quant_rows", _ARGTYPES)
        with torch.cuda.device(dev):
            err = fn(x32.data_ptr(), None if mean32 is None else mean32.data_ptr(),
                     vals.data_ptr(), scales.data_ptr(), b * h, s, d,
                     _qmax(precision), int(int4), int(hadamard), _IN_CODE[x32.dtype],
                     load_width(d, x32.element_size(), x32.data_ptr(),
                                None if mean32 is None else mean32.data_ptr()),
                     torch.cuda.current_stream(dev).cuda_stream)
        _kernels.check("quant_rows", err)
    return _result(x, vals, scales, precision)
