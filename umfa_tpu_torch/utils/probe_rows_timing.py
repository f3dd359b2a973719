"""Time the tensor-core probe (`mma_probe`) and the row quantizer
(`quant_rows`) of a source tree on the card.

    python umfa_tpu_torch/utils/probe_rows_timing.py [--tree DIR] [--label NAME]

Imports `umfa_tpu_torch` from DIR (default: the tree this file is in), so
another tree, such as a parent commit unpacked with `git archive`, can be
timed beside this one: run parent, change, change, parent, each in its own
process, one after another on the same card (each tree builds its kernels
into its own `_build/`).

- `mma_probe` at the five shapes of scripts/d64_ab.py, reps 1024: median of
  5 CUDA-event timings after one warm-up call, with its TFLOP/s and share
  of the 989 TFLOP/s bf16 peak, the fp32 relerr against `mma_probe_plain`
  at reps 1 and 8, whether two calls give the same bits, and the tree's
  plan (tile width, K split, work items) where it has one.
- `quant_rows` at the Q shape of the quantized training (B8 H16 S4096 D64
  bf16, INT8, channel mean), and with the rotation at D 64 and 128, INT4
  rotated at D 64, fp32 input at D 64: median of 10 timings. Before each
  call the 50 MB L2 is evicted by reading 256 MB and the card then spins
  while the host enqueues the call, so the events time the device, not the
  Python wrapper (`ms`); `ms_host` is the same call timed without the spin,
  as `chip_smoke.py` timed it before. Beside them the byte bound and
  whether codes and scales equal the plain version's.

Prints one JSON line per timing, then the card's name and power limit as
nvidia-smi gives them. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

PROBE_REPS = 1024
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
HBM_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
ROWS = (8, 16, 4096)  # B, H, S of the Q shape


# The tree being timed, whose `umfa_tpu_torch` is imported, may be an older
# one: the helpers here are this file's own.
def _time(fn, before=None, iters=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if before is not None:
            before()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return {"ms": statistics.median(times), "ms_min": min(times), "ms_max": max(times)}


def _rel_err(x, y):
    return float((x.double() - y.double()).norm() / y.double().norm())


def time_probe(emit, label):
    import torch

    from umfa_tpu_torch.utils import mma_probe as mp

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(13)
    for name, (m, k, n) in mp.SHAPES.items():
        a = torch.randn((m, k), generator=gen).to(dev, torch.bfloat16)
        b = (torch.randn((k, n), generator=gen) * 1e-3).to(dev, torch.bfloat16)
        row = {"tree": label, "kernel": "mma_probe", "name": name, "shape": f"M{m} K{k} N{n}",
               "reps": PROBE_REPS}
        for reps in (1, 8):
            got = mp.mma_probe(a, b, reps)
            row[f"relerr_reps{reps}"] = _rel_err(got, mp.mma_probe_plain(a, b, reps))
        row["same_bits_twice"] = bool(torch.equal(mp.mma_probe(a, b, 8), mp.mma_probe(a, b, 8)))
        if hasattr(mp, "plan"):
            tn, split = mp.plan(m, k, n)
            row.update(tile=f"64x{tn}", split=split, work_items=(m // 64) * (n // tn) * split)
        else:
            row.update(tile="64x64", split=1, work_items=(m // 64) * (n // 64))
        row.update(_time(lambda: mp.mma_probe(a, b, PROBE_REPS), iters=5, warmup=1))
        flops = 2 * m * k * n * PROBE_REPS
        row["tflops"] = flops / row["ms"] / 1e9
        row["share_of_989"] = row["tflops"] * 1e12 / BF16_FLOPS
        emit(row)


def time_rows(emit, label):
    import torch

    from umfa_tpu_torch.engine.config import Precision
    from umfa_tpu_torch.ops.quant_fused import quantize_rows_fused, quantize_rows_fused_plain

    dev = torch.device("cuda")
    flush_buf = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)

    def flush():
        flush_buf.sum()
        torch.cuda._sleep(1_000_000)

    b, h, s = ROWS
    gen = torch.Generator().manual_seed(4)
    cases = (("int8", 64, torch.bfloat16, False), ("int8", 64, torch.bfloat16, True),
             ("int8", 128, torch.bfloat16, True), ("int4", 64, torch.bfloat16, True),
             ("int8", 64, torch.float32, False))
    for prec_name, d, dtype, had in cases:
        prec = Precision.INT8 if prec_name == "int8" else Precision.INT4
        x = (torch.randn((b, h, s, d), generator=gen) + 0.3).to(dev, dtype)
        mean = x.float().mean(dim=2, keepdim=True)
        if had:  # the mean is given in the rotated space
            from umfa_tpu_torch.ops.quant_fused import rotate

            mean = rotate(x.float()).mean(dim=2, keepdim=True)

        def run(x=x, mean=mean, prec=prec, had=had):
            return quantize_rows_fused(x, mean, precision=prec, hadamard=had)

        got = run()
        want = quantize_rows_fused_plain(x, mean, precision=prec, hadamard=had)
        nbytes = (x.element_size() * x.numel() + got.values.numel() + 4 * got.scales.numel()
                  + 4 * mean.numel())
        row = {"tree": label, "kernel": "quant_rows",
               "shape": f"B{b} H{h} S{s} D{d} {str(dtype).split('.')[-1]}, {prec_name}"
                        f"{', rotated' if had else ''}, mean",
               **_time(run, before=flush), "ms_host": _time(run)["ms"],
               "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES * 1e3,
               "codes_equal": bool(torch.equal(got.values, want.values)),
               "scales_equal": bool(torch.equal(got.scales, want.scales))}
        if had:
            diff = (got.values.int() - want.values.int()).abs() if prec == Precision.INT8 else None
            row["codes_off_by_one_max"] = None if diff is None else int(diff.max())
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        emit(row)
        del x, mean, got, want
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        print("probe_rows_timing: no CUDA device", file=sys.stderr)
        return 2
    from umfa_tpu_torch import _kernels

    _kernels.build_all(("mma_probe", "quant_rows"))

    def emit(row):
        print(json.dumps(row), flush=True)

    time_probe(emit, args.label)
    time_rows(emit, args.label)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
