"""FLUX.1-Schnell-shaped attention benchmark (torch version of
examples/flux_attention_benchmark.py): at resolution R, joint attention over
(R/16)^2 image tokens plus 512 text tokens, 24 heads of 128; bf16
`flash_attention` beside the int8 and int4 `quantized_flash_attention`,
each timed by `utils/timing.time_op` (CUDA events on the card, the host
clock on the CPU). Every time is printed beside the device it ran on: the
card's name and power limit (nvidia-smi), or "cpu".

    python -m umfa_tpu_torch.examples.flux_attention_benchmark [--res 256,512,1024]
"""

import argparse
import json
import subprocess
import sys

import torch

from umfa_tpu_torch.engine.config import Precision, QuantizationConfig, QuantMode
from umfa_tpu_torch.ops.attention import flash_attention
from umfa_tpu_torch.ops.quant_attention import quantized_flash_attention
from umfa_tpu_torch.utils.device import default_device
from umfa_tpu_torch.utils.timing import attention_flops, time_op


def device_label(dev: torch.device) -> str:
    """The card's `nvidia-smi` name and power limit, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[dev.index or 0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--res", default="256,512,1024")
    ap.add_argument("--iters", type=int, default=32)
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    label = device_label(dev)

    g = torch.Generator().manual_seed(0)
    H, D = 24, 128  # FLUX.1 joint-attention geometry

    def qcfg(p):
        return QuantizationConfig(q_precision=p, k_precision=p, v_precision=p, mode=QuantMode.ROW)

    variants = {
        "bf16_fused": lambda q, k, v: flash_attention(q, k, v),
        "int8": lambda q, k, v: quantized_flash_attention(q, k, v, config=qcfg(Precision.INT8)),
        "int4": lambda q, k, v: quantized_flash_attention(q, k, v, config=qcfg(Precision.INT4)),
    }
    results = {}
    with torch.no_grad():
        for res in (int(r) for r in args.res.split(",")):
            seq = (res // 16) ** 2 + 512
            q, k, v = (torch.randn((1, H, seq, D), generator=g).to(dev, torch.bfloat16)
                       for _ in range(3))
            flops = attention_flops(1, H, seq, seq, D)
            row = {}
            for name, fn in variants.items():
                t = time_op(fn, q, k, v, iters=args.iters)
                row[name] = {"ms": t * 1e3, "tflops": flops / t / 1e12, "device": label}
            row["int8_speedup_vs_bf16"] = row["bf16_fused"]["ms"] / row["int8"]["ms"]
            row["int4_speedup_vs_bf16"] = row["bf16_fused"]["ms"] / row["int4"]["ms"]
            results[f"{res}px_seq{seq}"] = row
            print(f"{res}px (seq={seq}) on {label}: {json.dumps(row)}", file=sys.stderr)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
