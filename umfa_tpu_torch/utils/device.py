"""The port's device rule: entry points run on the card unless the caller
asks for the CPU. There is no silent CPU fallback."""

from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """Resolve `device` (None → "cuda"). Raises RuntimeError when a CUDA
    device is asked for (explicitly or by default) and none is present;
    pass device="cpu" to run the plain PyTorch versions on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "umfa_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
