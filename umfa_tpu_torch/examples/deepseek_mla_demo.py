"""DeepSeek-style demo: MLA latent KV compression, the sparse indexer, MoE
routing and latent-cache generation (torch version of
examples/deepseek_mla_demo.py).

    python -m umfa_tpu_torch.examples.deepseek_mla_demo [--device cpu]
"""

import argparse

import torch

from umfa_tpu_torch.models import deepseek, mla_model
from umfa_tpu_torch.utils.device import default_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    g = torch.Generator().manual_seed(0)
    cfg = mla_model.MLAConfig(dim=1024, num_heads=16, latent_dim=128,  # 8x KV compression
                              causal=True, dtype="bfloat16")
    params = mla_model.init_params(cfg, g, device=dev)
    x = torch.randn((1, 512, cfg.dim), generator=g).to(dev, cfg.tdtype)

    with torch.no_grad():
        latent = mla_model.compress_kv(params, x)
        full_kv_bytes = 2 * x.numel() * x.element_size()  # K and V at full width
        latent_bytes = latent.numel() * latent.element_size()
        print(f"KV cache: full {full_kv_bytes / 1e6:.1f} MB -> latent "
              f"{latent_bytes / 1e6:.1f} MB ({full_kv_bytes / latent_bytes:.0f}x smaller)")

        out = mla_model.forward(params, x, cfg)
        print("MLA forward:", tuple(out.shape), out.dtype)

        sparse_cfg = mla_model.MLAConfig(dim=1024, num_heads=16, latent_dim=128, causal=True,
                                         dtype="bfloat16", indexer_topk=128)
        out_sparse = mla_model.forward(params, x, sparse_cfg)
        print("MLA + sparse indexer (top-128):", tuple(out_sparse.shape))

        # The whole random-weight model: MLA attention, the MoE FFN with a
        # shared expert, generation against the latent cache (absorbed
        # weights).
        dcfg = deepseek.DeepSeekConfig(vocab=512, dim=512, num_heads=8, latent_dim=64, depth=2,
                                       num_experts=16, top_k=4, n_shared=1, moe_hidden=512,
                                       dtype="bfloat16")
        dparams = deepseek.init_params(dcfg, torch.Generator().manual_seed(1), device=dev)
        prompt = torch.randint(0, 512, (1, 16), generator=g).to(dev)
        tokens = deepseek.generate(dparams, prompt, dcfg, max_new_tokens=8)
    print("MoE model generate (16 experts / 4 active, latent-cache decode):",
          tokens[0].tolist())


if __name__ == "__main__":
    main()
