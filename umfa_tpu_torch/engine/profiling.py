"""Latency and trace observability (port of umfa_tpu/engine/profiling.py).

`timed()` records the wall time of a block into the native runtime's
latency atomics (`native/runtime.py`), so `get_last_latency_ms()` reads it
anywhere in the process; `trace(log_dir)` runs `torch.profiler` over a
block, with CPU and CUDA activities where a card is present, and writes a
Chrome trace (`trace.json`, viewable in chrome://tracing or Perfetto) into
`log_dir`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

from umfa_tpu_torch.native import runtime


@contextlib.contextmanager
def timed(record: bool = True):
    """Time a block on the host clock. Waiting for the device work the
    block launched (`torch.cuda.synchronize()`) is the caller's job, as it
    is in the reference. With `record`, the nanoseconds go to the native
    runtime when it is available."""
    t0 = time.perf_counter_ns()
    yield
    dt = time.perf_counter_ns() - t0
    if record and runtime.available():
        runtime.record_latency_ns(dt)


def get_last_latency_ms() -> Optional[float]:
    """The last latency `timed()` recorded, in ms; None without the native
    runtime."""
    if runtime.available():
        return runtime.get_last_latency_ns() / 1e6
    return None


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with torch.profiler (CPU, and CUDA where a card is
    present) and write its Chrome trace to `log_dir/trace.json`. Yields
    `log_dir`, as the reference does."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
