"""Drop-in torch SDPA replacement (torch version of
examples/torch_sdpa_replacement.py): after `install_torch_sdpa()`, any torch
model that calls `F.scaled_dot_product_attention`, `nn.MultiheadAttention`
included, gets its attention from the port's kernels, unchanged.

    python -m umfa_tpu_torch.examples.torch_sdpa_replacement [--device cpu]
"""

import argparse

import torch
import torch.nn.functional as F

from umfa_tpu_torch.utils.device import default_device
from umfa_tpu_torch.utils.interop import install_torch_sdpa


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    torch.manual_seed(0)
    B, H, S, D = 2, 8, 1024, 64
    q, k, v = (torch.randn(B, H, S, D).to(dev) for _ in range(3))

    # torch's own SDPA (before the override).
    want = F.scaled_dot_product_attention(q, k, v, is_causal=True)

    uninstall = install_torch_sdpa()
    try:
        assert getattr(F.scaled_dot_product_attention, "_umfa_override", False)
        got = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        rel = (got - want).norm() / want.norm()
        print(f"causal SDPA via umfa_tpu_torch: relerr {rel:.2e}")

        # A whole torch module runs unmodified: MultiheadAttention calls
        # F.scaled_dot_product_attention inside.
        mha = torch.nn.MultiheadAttention(H * D, H, batch_first=True).to(dev)
        x = torch.randn(B, S, H * D).to(dev)
        with torch.no_grad():
            out_umfa, _ = mha(x, x, x, need_weights=False)
        uninstall()
        with torch.no_grad():
            out_native, _ = mha(x, x, x, need_weights=False)
        rel = (out_umfa - out_native).norm() / out_native.norm()
        print(f"nn.MultiheadAttention via umfa_tpu_torch: relerr {rel:.2e}")

        # GQA and a bool mask through the override.
        uninstall = install_torch_sdpa()
        kg, vg = (torch.randn(B, H // 4, S, D).to(dev) for _ in range(2))
        mask = (torch.rand(S, S) > 0.1).to(dev)
        got = F.scaled_dot_product_attention(q, kg, vg, attn_mask=mask, enable_gqa=True)
        uninstall()
        want = F.scaled_dot_product_attention(q.double(), kg.double(), vg.double(),
                                              attn_mask=mask, enable_gqa=True).float()
        rel = (got - want).norm() / want.norm()
        print(f"GQA + bool mask via umfa_tpu_torch: relerr {rel:.2e}")
    finally:
        uninstall()


if __name__ == "__main__":
    main()
