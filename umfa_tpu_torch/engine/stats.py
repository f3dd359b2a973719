"""Dispatch-route statistics (port of umfa_tpu/engine/stats.py).

Every call through the public `attention()` records which route handled
it, under the reference's route names. When the port's native runtime
library builds and loads (`native/runtime.py`), the counters are its
process-wide atomics; otherwise Python integers under a lock.
"""

from __future__ import annotations

import threading
from typing import Dict

_ROUTES = (
    "total",
    "fused_fwd",            # fused kernel, (out, lse) returned
    "fused_autograd",       # differentiable fused path
    "quantized_fwd",        # quantized fused kernel, inference
    "quantized_autograd",   # quantized + STE backward
    "rope_fused",           # fused RoPE + attention
    "naive_fallback",       # plain reference path (opt-in routes)
    "mask_all_true_skipped",
    "window_auto_tiled",    # plain window= promoted to an auto-tiled walk
)

_lock = threading.Lock()
_counters: Dict[str, int] = {r: 0 for r in _ROUTES}


def _native():
    from umfa_tpu_torch.native import runtime

    return runtime if runtime.available() else None


def record_dispatch(route: str) -> None:
    nat = _native()
    if nat is not None:
        nat.record_dispatch(route)
        return
    with _lock:
        _counters["total"] += 1
        if route in _counters:
            _counters[route] += 1


def get_dispatch_stats() -> Dict[str, int]:
    nat = _native()
    if nat is not None:
        return nat.get_dispatch_stats()
    with _lock:
        return dict(_counters)


def reset_dispatch_stats() -> None:
    nat = _native()
    if nat is not None:
        nat.reset_dispatch_stats()
        return
    with _lock:
        for key in _counters:
            _counters[key] = 0
