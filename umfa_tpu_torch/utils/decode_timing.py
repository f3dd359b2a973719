"""Time the flash-decode kernel (`flash_decode`) of a source tree on the card.

    python umfa_tpu_torch/utils/decode_timing.py [--tree DIR] [--label NAME]

Imports `umfa_tpu_torch` from DIR (default: the tree this file is in), so
another tree, such as a parent commit unpacked with `git archive`, can be
timed beside this one: run parent, change, change, parent, each in its own
process, one after another on the same card (each tree builds its kernels
into its own `_build/`). At the serving decode geometry (B8 Hq16 Hkv8
S4096, a full INT8 cache of seeded codes and scales, bf16 queries, the
decode route's length-and-causal bias) it times the whole
`quantized_flash_decode` call at Tq 1 D 64, Tq 16 D 64 and Tq 1 D 256:
median, min and max of 10 CUDA-event timings after 2 warm-up calls. Before
each call the 50 MB L2 is evicted by reading 256 MB, and the card then
spins while the host enqueues the call, so the events time the device
(every kernel the call launches and the gaps between them), not the Python
wrapper. Beside it: each kernel's device ms of one call (`kernels_ms`,
torch.profiler over 3 calls, L2 evicted before each), the byte bound, and
the relerr of out against the plain tile walk.

Prints one JSON line per timing, then the card's name and power limit as
nvidia-smi gives them. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

B, HQ, HKV, S = 8, 16, 8, 4096
SHAPES = ((1, 64), (16, 64), (1, 256))  # (Tq, D)
HBM_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s


def _inputs(tq, d, seed):
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    k = torch.randint(-128, 128, (B, HKV, S, d), generator=g, dtype=torch.int8, device=dev)
    v = torch.randint(-128, 128, (B, HKV, S, d), generator=g, dtype=torch.int8, device=dev)
    ks = torch.rand((B, HKV, S, 1), generator=g, device=dev) * 0.05 + 1e-3
    vs = torch.rand((B, HKV, S, 1), generator=g, device=dev) * 0.05 + 1e-3
    pos = torch.arange(S, device=dev)
    qpos = S - tq + torch.arange(tq, device=dev)
    bias = torch.where(pos[None] > qpos[:, None], -1e30, 0.0).expand(B, 1, tq, S).contiguous()
    q = torch.randn((B, HQ, tq, d), generator=g, device=dev).to(torch.bfloat16)
    return q, k, ks, v, vs, bias


# The timing helpers are this file's own, not those of `bwd_timing.py` and
# `qfwd_timing.py` (which take no `before`): the tree being timed, whose
# `umfa_tpu_torch` is imported, may be an older one.
def _time(fn, before, iters=10, warmup=2):
    import statistics

    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        before()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return {"ms": statistics.median(times), "ms_min": min(times), "ms_max": max(times)}


def _kernel_ms(fn, before, calls=3):
    """{kernel name: device ms per call} of the flash-decode kernels fn()
    launches, each call after before()."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            before()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if us > 0 and "flash_decode" in e.key:
            # "void (anonymous namespace)::name<...>(...)" -> "name"
            name = e.key.split("<")[0].split("::")[-1].split("(")[0].strip()
            name = name.removeprefix("void ").strip() or e.key[:60]
            out[name] = out.get(name, 0.0) + us / calls / 1e3
    return out


def _time_decode(emit):
    import torch

    from umfa_tpu_torch import _kernels
    from umfa_tpu_torch.serving import decode_kernel as dk
    from umfa_tpu_torch.utils.testing import rel_err

    _kernels.build_all(("flash_decode",))
    flush_buf = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")

    def flush():
        flush_buf.sum()
        torch.cuda._sleep(1_000_000)

    for tq, d in SHAPES:
        args = _inputs(tq, d, seed=1000 + tq + d)

        def run(args=args):
            return dk.quantized_flash_decode(*args, block_k=2048)

        got, want = run(), dk.quantized_flash_decode_plain(*args, block_k=2048)
        q, k, ks, v, vs, bias = args
        nbytes = (k.numel() + v.numel() + 4 * (ks.numel() + vs.numel() + bias.numel())
                  + 2 * q.numel() + 4 * got.numel())
        emit("flash_decode", Tq=tq, D=d, **_time(run, flush), kernels_ms=_kernel_ms(run, flush),
             bound_ms=nbytes / HBM_BYTES * 1e3, relerr=rel_err(got, want))
        del args, got, want, q, k, ks, v, vs, bias
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    if sys.path and os.path.abspath(sys.path[0]) == here:
        sys.path.pop(0)  # run as a script: its own directory would shadow top-level names
    sys.path.insert(0, tree)

    import torch

    from umfa_tpu_torch import _kernels

    if not torch.cuda.is_available():
        print("decode_timing: no CUDA device", file=sys.stderr)
        return 2
    if not _kernels.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"imported {_kernels.__file__}, not the tree {tree}")

    def emit(kernel, **kw):
        print(json.dumps({"tree": args.label, "kernel": kernel, **kw}), flush=True)

    _time_decode(emit)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
