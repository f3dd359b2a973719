"""Tensor-core rate probe (port of scripts/d64_ab.py:64 `_mxu_probe_fn`).

`mma_probe(a, b, reps)` returns fp32 Σ over reps of a·(b + eps), with
a (M, K) and b (K, N) in bf16 and eps = bf16(max(acc[0, :]) · 1e-38)
taken from the accumulator before each product. eps rounds away in
b + eps (|b| is far above it), so b is unchanged, but it ties every
product to the one before: the compiler can neither hoist the
loop-invariant product nor fold the sum. On CUDA tensors it launches
`csrc/mma_probe.cu` (`mma.sync` m16n8k16, bf16 into fp32); on CPU tensors
it runs `mma_probe_plain`, the same loop in torch.

The kernel measures the rate `mma.sync` reaches on the card; the bounds
of the attention kernels keep the 989 TFLOP/s datasheet peak.
"""

from __future__ import annotations

import ctypes

import torch

from umfa_tpu_torch import _kernels

# (M, K, N) of the reference's probe shapes (scripts/d64_ab.py:52-61).
SHAPES = {
    "mxu_k64": (2048, 64, 256),
    "mxu_k128": (2048, 128, 256),
    "mxu_n64": (2048, 512, 64),
    "mxu_n128": (2048, 512, 128),
    "mxu_deep": (2048, 512, 256),
}
TILE = 64      # rows and columns of the output tile of one block
MAX_K = 896    # A and Bᵀ tiles of 64 x (K + 8) bf16 within 227 KB of shared memory

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _I, _I, _I, _I, _P)


def _eps(acc: torch.Tensor) -> torch.Tensor:
    return (acc[0].max() * 1e-38).to(torch.bfloat16)


def mma_probe_plain(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """The probe's loop in plain PyTorch, on any device."""
    af, acc = a.float(), torch.zeros((a.shape[0], b.shape[1]), device=a.device)
    for _ in range(reps):
        bi = (b + _eps(acc)).float()  # bf16 + bf16, rounded to bf16
        acc = acc + af @ bi
    return acc


def mma_probe(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """Σ_reps a·(b + eps) in fp32 (see the module docstring)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"a (M, K) and b (K, N) expected, got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise ValueError(f"mma_probe takes bfloat16 operands, got {a.dtype}, {b.dtype}")
    if a.device.type == "cpu":
        return mma_probe_plain(a, b, reps)
    m, k = a.shape
    n = b.shape[1]
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"mma_probe kernel needs a and b on one CUDA device, got {a.device}/{b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("mma_probe kernel needs contiguous operands")
    if m % TILE or n % TILE or k % 32 or not 32 <= k <= MAX_K or reps < 1:
        raise ValueError(f"mma_probe kernel takes M and N multiples of {TILE}, K a multiple of 32 "
                         f"up to {MAX_K} and reps >= 1, got M {m}, K {k}, N {n}, reps {reps}")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    fn = _kernels.function("mma_probe", "umfa_mma_probe", _ARGTYPES)
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n, reps,
                 torch.cuda.current_stream(a.device).cuda_stream)
    _kernels.check("mma_probe", err)
    return out
