"""Time the INT8 attention forward (`quant_attn_fwd`) of a source tree on the card.

    python umfa_tpu_torch/utils/qfwd_timing.py [--tree DIR] [--label NAME]

Imports `umfa_tpu_torch` from DIR (default: the tree this file is in), so
another tree, such as a parent commit unpacked with `git archive`, can be
timed beside this one: run parent, change, change, parent, each in its own
process, one after another on the same card (each tree builds its kernels
into its own `_build/`). At the serving prefill shape (B8 Hq16 Hkv8, 4032
causal queries against 4096 keys, int8 ROW operands quantized from seeded
bf16 normals) it times `quantized_attention_forward` at D 64, 128 and 256:
median, min and max of 10 CUDA-event timings after 2 warm-up calls, and
at D 64 the worst abs error of out against the plain version. A head dim
the tree's kernel refuses is reported as refused. Prints one JSON line per
head dim, then the card's name and power limit as nvidia-smi gives them.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

B, HQ, HKV, SQ, SK = 8, 16, 8, 4032, 4096


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
    from umfa_tpu_torch.engine.config import QuantMode
    from umfa_tpu_torch.ops.quant import quantize
    from umfa_tpu_torch.ops.quant_attention import (
        quantized_attention_forward,
        quantized_attention_forward_plain,
    )
    from umfa_tpu_torch.utils.bwd_timing import _stats

    if not torch.cuda.is_available():
        print("qfwd_timing: no CUDA device", file=sys.stderr)
        return 2
    if not _kernels.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"imported {_kernels.__file__}, not the tree {tree}")
    _kernels.build_all(("quant_attn_fwd",))

    def emit(**kw):
        print(json.dumps({"tree": args.label, "kernel": "quant_attn_fwd", **kw}), flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    for d in (64, 128, 256):
        x = [torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
             for shape in ((B, HQ, SQ, d), (B, HKV, SK, d), (B, HKV, SK, d))]
        qt = [quantize(t, mode=QuantMode.ROW) for t in x]
        del x

        def run(qt=qt):
            return quantized_attention_forward(*qt, causal=True)

        try:
            run()
        except ValueError as e:
            emit(D=d, refused=str(e))
            continue
        err = None
        if d == 64:
            got, want = run()[0], quantized_attention_forward_plain(*qt, causal=True)[0]
            err = float((got - want).abs().max())
            del got, want
            torch.cuda.empty_cache()
        emit(D=d, **_stats(run), max_abs_err=err)
        del qt
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
