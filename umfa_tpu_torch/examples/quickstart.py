"""Quickstart: SDPA-shaped attention on the card (torch version of
examples/quickstart.py).

    python -m umfa_tpu_torch.examples.quickstart [--device cpu]
"""

import argparse

import torch

import umfa_tpu_torch
from umfa_tpu_torch.utils.device import default_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    g = torch.Generator().manual_seed(0)
    B, H, S, D = 1, 8, 1024, 64
    q, k, v = (torch.randn((B, H, S, D), generator=g).to(dev, torch.bfloat16) for _ in range(3))

    # Dense fused attention.
    out = umfa_tpu_torch.attention(q, k, v, is_causal=True)
    print("dense:", tuple(out.shape), out.dtype)

    # Sliding window + additive bias.
    bias = torch.zeros((1, 1, S, S), dtype=torch.float32, device=dev)
    out = umfa_tpu_torch.attention(q, k, v, bias, window=(256, 0))
    print("windowed:", tuple(out.shape))

    # Runtime INT8 quantization: a process-global mode.
    umfa_tpu_torch.set_quantization_mode("int8", "row")
    out_q = umfa_tpu_torch.attention(q, k, v, is_causal=True)
    umfa_tpu_torch.clear_quantization_mode()
    print("int8:", tuple(out_q.shape))

    # Scoped quantization.
    with umfa_tpu_torch.use_quantization("int4", "block"):
        out_q4 = umfa_tpu_torch.attention(q, k, v)
    print("int4:", tuple(out_q4.shape))

    # A FlexAttention-style mask_mod, compiled once into a block-sparse map
    # whose skipped tiles the kernels never visit.
    def doc_mask(qi, ki):
        return (qi // 256) == (ki // 256)

    out_s = umfa_tpu_torch.attention(q, k, v, doc_mask)
    print("block-sparse (mask_mod):", tuple(out_s.shape))

    # Training: gradients flow through the fused kernels (STE when quantized).
    qg = q.clone().requires_grad_(True)
    (umfa_tpu_torch.attention(qg, k, v, is_causal=True).float() ** 2).sum().backward()
    print("grad:", tuple(qg.grad.shape), qg.grad.dtype)

    print("dispatch stats:", umfa_tpu_torch.get_dispatch_stats())


if __name__ == "__main__":
    main()
