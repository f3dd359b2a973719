"""Serving demo: a GPT-style LM with KV caches and continuous batching
(torch version of examples/serving_demo.py).

    python -m umfa_tpu_torch.examples.serving_demo [--device cpu]
"""

import argparse

import torch

from umfa_tpu_torch.models import gpt
from umfa_tpu_torch.serving.scheduler import ContinuousBatcher
from umfa_tpu_torch.utils.device import default_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    cfg = gpt.GPTConfig(vocab=128, dim=256, num_heads=8, num_kv_heads=4, depth=2,
                        max_seq=128, dtype="float32")
    model = gpt.init_params(cfg, torch.Generator().manual_seed(0), device=dev)

    prompt = torch.randint(0, cfg.vocab, (2, 12), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = gpt.generate(model, prompt.to(dev), steps=8)
    print("generate:", tuple(out.shape), "->", out[0, :20].tolist())

    batcher = ContinuousBatcher(num_slots=4)
    for _ in range(6):
        batcher.submit(prompt_len=12, max_new_tokens=4)
    rounds = 0
    while not batcher.idle:
        batcher.step()
        rounds += 1
    s = batcher.stats
    print(f"continuous batching: {s.completed} requests in {rounds} rounds, "
          f"mean slot occupancy {s.mean_occupancy:.2f}")


if __name__ == "__main__":
    main()
