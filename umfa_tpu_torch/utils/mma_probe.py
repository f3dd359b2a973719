"""Tensor-core rate probe (port of scripts/d64_ab.py:64 `_mxu_probe_fn`).

`mma_probe(a, b, reps)` returns fp32 Σ over reps of a·(b + eps), with
a (M, K) and b (K, N) in bf16 and eps = bf16(max(acc[0, :]) · 1e-38)
taken from the accumulator before each product. eps rounds away in
b + eps (|b| is far above it), so b is unchanged, but it ties every
product to the one before: the compiler can neither hoist the
loop-invariant product nor fold the sum. On CUDA tensors it launches
`csrc/mma_probe.cu` (warpgroup products, `wgmma.mma_async` m64nNk16 bf16
into fp32, with eps added to the A operand in registers, where it rounds
away as well); on CPU tensors it runs `mma_probe_plain`, the same loop in
torch.

The kernel measures the rate `wgmma` reaches on the card; the bounds of
the attention kernels keep the 989 TFLOP/s datasheet peak. `plan` picks
its work items: 64 x tn output tiles, K split until there are about two
items an SM (each item drains its products before it forms the next eps;
the other item on its SM keeps the tensor cores busy meanwhile).
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
TILE = 64       # output rows of a work item, and the unit of M and N
MAX_K = 4096    # K up to this, a multiple of 16 (any depth splits into slices the kernel takes)
MIN_ITEMS = 256  # work items a plan aims at: about two an SM of the card's 132
# Output tile widths and the 16-deep steps a K slice may have at each (a
# kernel instantiation each): the slice's A fragments and the accumulator
# stay in registers.
STEPS = {128: (8, 4, 2, 1), 64: (16, 8, 4, 2, 1)}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)


def plan(m: int, k: int, n: int) -> tuple[int, int]:
    """(tn, split) of the kernel for a (M, K) by (K, N) probe: 64 x tn
    output tiles (128 where N allows, else 64), each over `split` K slices
    of 16·steps columns (steps in STEPS[tn]): the fewest slices that give
    MIN_ITEMS work items, or the most the steps allow where none does."""
    if m % TILE or n % TILE or k % 16 or not 16 <= k <= MAX_K:
        raise ValueError(f"mma_probe kernel takes M and N multiples of {TILE} and K a multiple "
                         f"of 16 up to {MAX_K}, got M {m}, K {k}, N {n}")
    tn = 128 if n % 128 == 0 else 64
    tiles = (m // TILE) * (n // tn)
    splits = [k // (16 * st) for st in STEPS[tn] if k % (16 * st) == 0]
    return tn, next((sp for sp in splits if tiles * sp >= MIN_ITEMS), splits[-1])


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
    if not (a.is_contiguous() and b.is_contiguous()) or a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("mma_probe kernel needs contiguous, 16-byte aligned operands")
    if reps < 1:
        raise ValueError(f"mma_probe kernel takes reps >= 1, got {reps}")
    tn, split = plan(m, k, n)
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    partial = (torch.empty((split, m, n), dtype=torch.float32, device=a.device)
               if split > 1 else None)
    fn = _kernels.function("mma_probe", "umfa_mma_probe", _ARGTYPES)
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                 None if partial is None else partial.data_ptr(), m, k, n, reps, tn, split,
                 torch.cuda.current_stream(a.device).cuda_stream)
    _kernels.check("mma_probe", err)
    return out
