"""The port's engine/profiling.py (umfa_tpu/engine/profiling.py).

`trace(log_dir)` writes a Chrome trace of the block; `timed()` records the
block's wall nanoseconds into the native runtime, which
`get_last_latency_ms()` reads back.
"""

import json
import time

import numpy as np
import torch

from umfa_tpu_torch.engine import profiling
from umfa_tpu_torch.native import runtime
from umfa_tpu_torch.ops.attention import flash_attention


def test_trace_writes_a_chrome_trace(tmp_path):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (1, 2, 32, 16)).astype(np.float32))
               for _ in range(3))
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)) as where:
        flash_attention(q, k, v, causal=True)
    assert where == str(log_dir)
    events = json.loads((log_dir / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_timed_records_the_last_latency():
    assert runtime.available()
    with profiling.timed():
        time.sleep(0.002)
    ms = profiling.get_last_latency_ms()
    assert ms is not None and 2.0 <= ms < 2000.0
    with profiling.timed(record=False):
        time.sleep(0.02)
    assert profiling.get_last_latency_ms() == ms
