"""Op timing (port of umfa_tpu/utils/timing.py).

`time_op(op, *args)` returns the best seconds per iteration of `op(*args)`.
On CUDA tensors it times with CUDA events: after a warm-up, `iters` calls
between two events, the best of `reps` such runs, so the device time of the
calls is measured, not the host's enqueue. On CPU tensors it times the same
runs with `time.perf_counter`.

The reference's slope timing through a relay (`_looped`, `_perturb`: a
jitted fori_loop at two iteration counts, chained by a tiny perturbation so
XLA can neither hoist nor merge the op) answers a TPU behind a network relay,
where a dispatch costs ~30 ms and `block_until_ready` can return early. The
card has neither problem: PyTorch runs eagerly, every call runs, and
CUDA events read the device's own clock. It is not ported.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def _on_cuda(args) -> bool:
    """Whether any tensor among `args` (searched one level into lists,
    tuples and dicts) lies on a CUDA device."""
    for a in args:
        items = a.values() if isinstance(a, dict) else a if isinstance(a, (list, tuple)) else (a,)
        if any(isinstance(t, torch.Tensor) and t.is_cuda for t in items):
            return True
    return False


def time_op(op: Callable, *args, iters: int = 64, reps: int = 3) -> float:
    """Return the best per-iteration seconds of op(*args) over `reps` runs
    of `iters` calls each, after one warm-up call (which also builds any
    kernel). CUDA events on the card, the host clock on the CPU."""
    if iters < 1 or reps < 1:
        raise ValueError(f"iters and reps must be positive, got {iters}, {reps}")
    op(*args)
    best = float("inf")
    if _on_cuda(args):
        torch.cuda.synchronize()
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                op(*args)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3 / iters)
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(iters):
                op(*args)
            best = min(best, (time.perf_counter() - t0) / iters)
    return max(best, 1e-9)


def attention_flops(batch, heads, seq_q, seq_k, head_dim, causal=False,
                    backward=False):
    f = 4 * batch * heads * seq_q * seq_k * head_dim
    if causal:
        f //= 2
    if backward:
        f = f * 5 // 2  # bwd ≈ 2.5× fwd FLOPs (dQ + dKdV recompute)
    return f
