"""Checkpoint save/restore and MLA weight loading (port of
umfa_tpu/utils/checkpoint.py).

`save(path, tree)` writes the tensors of a tree: nested dicts (an
`nn.Module`'s `state_dict()` among them), lists and tuples whose leaves are
tensors, `QuantizedTensor`s (ops/quant.py) or `QuantizedWeight`s
(ops/gemm.py), so a quantized model round-trips without re-quantization.
The file is one `torch.save` of a flat {path: tensor} dict, each tensor
copied to the host. `restore(path, like)` reads it with
`torch.load(weights_only=True)` (tensors only: no code runs on load) and
rebuilds `like`'s structure: each leaf comes back in `like`'s dtype and on
`like`'s device, and a quantized leaf's metadata (precision, mode, shapes)
is `like`'s. The reference's orbax route has no counterpart; nothing is
downloaded.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict

import numpy as np
import torch

from umfa_tpu_torch.ops.gemm import QuantizedWeight
from umfa_tpu_torch.ops.quant import QuantizedTensor
from umfa_tpu_torch.utils.device import default_device

_QUANTIZED = (QuantizedTensor, QuantizedWeight)


def _flatten(tree, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    """The tensor leaves of `tree` under '/'-joined paths (dict keys, list
    indices, dataclass field names); None fields are skipped."""
    if isinstance(tree, torch.Tensor):
        out[prefix] = tree
    elif isinstance(tree, dict):
        for key, val in tree.items():
            _flatten(val, f"{prefix}/{key}", out)
    elif isinstance(tree, (list, tuple)):
        for i, val in enumerate(tree):
            _flatten(val, f"{prefix}/{i}", out)
    elif isinstance(tree, _QUANTIZED):
        for f in dataclasses.fields(tree):
            val = getattr(tree, f.name)
            if isinstance(val, torch.Tensor):
                out[f"{prefix}/{f.name}"] = val
    elif tree is not None:
        raise TypeError(f"checkpoint: unsupported leaf {type(tree).__name__} at {prefix or '/'}")


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A compact host copy (torch.save writes a view's whole storage)."""
    t = t.detach()
    return t.cpu() if t.device.type != "cpu" else t.clone()


def save(path: str, tree: Any) -> None:
    """Save the tensors of `tree` (module docstring) to `path`."""
    flat: Dict[str, torch.Tensor] = {}
    _flatten(tree, "", flat)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    torch.save({key: _host_copy(t) for key, t in flat.items()}, path)


def _rebuild(like, prefix: str, data: Dict[str, torch.Tensor]):
    if isinstance(like, torch.Tensor):
        if prefix not in data:
            raise KeyError(f"checkpoint holds no tensor at {prefix or '/'}")
        t = data[prefix]
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint tensor {prefix} has shape {tuple(t.shape)}, "
                             f"the template {tuple(like.shape)}")
        return t.to(device=like.device, dtype=like.dtype)
    if isinstance(like, dict):
        return type(like)((key, _rebuild(val, f"{prefix}/{key}", data))
                          for key, val in like.items())
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(val, f"{prefix}/{i}", data) for i, val in enumerate(like))
    if isinstance(like, _QUANTIZED):
        return dataclasses.replace(like, **{
            f.name: _rebuild(getattr(like, f.name), f"{prefix}/{f.name}", data)
            for f in dataclasses.fields(like) if isinstance(getattr(like, f.name), torch.Tensor)})
    return like


def restore(path: str, like: Any) -> Any:
    """Restore a tree saved by `save`, with `like` as the template of its
    structure, dtypes, devices and quantized metadata."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    return _rebuild(like, "", data)


def load_mla_weights(path_or_arrays, latent_dim: int, out_dim: int, device=None):
    """MLA decompression weights (W_k, W_v), each (latent_dim, out_dim), from
    a `(w_k, w_v)` pair (arrays or tensors) or an `.npz` holding `w_k` and
    `w_v`; returned as tensors on `device` (default: the card; pass
    device="cpu" on a host without one), keeping their dtypes."""
    device = default_device(device)
    if isinstance(path_or_arrays, (tuple, list)):
        w_k, w_v = path_or_arrays
    else:
        with np.load(path_or_arrays) as data:
            w_k, w_v = data["w_k"], data["w_v"]
    out = []
    for name, w in (("w_k", w_k), ("w_v", w_v)):
        t = w if isinstance(w, torch.Tensor) else torch.from_numpy(np.array(w))
        if tuple(t.shape) != (latent_dim, out_dim):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(latent_dim, out_dim)}")
        out.append(t.to(device))
    return tuple(out)
