"""Device meshes (port of umfa_tpu/parallel/mesh.py).

A mesh in the port is what `LocalRing` is for the ring: one process drives
every virtual rank in lockstep on one device. `devices` is an array of
`torch.device` whose entries may repeat, one entry a virtual rank; the
entry points that take a mesh (`sharded_attention`, `pipeline_apply`, the
DiT's `tp_axis`/`sp_axis` and the MoE's `ep_axis`) take the global tensors
and split them over the ranks themselves.

Axis convention, as the reference:

  * "dp": data parallel (batch);
  * "sp": sequence parallel (ring attention's K/V rotation rides it);
  * "tp": tensor parallel (attention heads, MLP columns).

A mesh over two different devices, or over the processes of a
`torch.distributed` group, is refused: those need more than one card
(ROADMAP.md, Queue 3).
"""

from __future__ import annotations

import collections
import threading
from typing import Optional, Sequence

import numpy as np
import torch

_MULTI_CARD = ("needs a machine with more than one card, not ported yet (ROADMAP.md, "
               "Queue 3)")

_current = threading.local()


def _normal(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", 0)
    return dev


class Mesh:
    """`devices`: an array (any nesting of sequences) of `torch.device` or
    device strings, one entry a virtual rank, all the same device;
    `axis_names`: one name a dimension. `shape` maps each axis to its size,
    as `jax.sharding.Mesh.shape`. `with mesh:` makes it the current mesh of
    this thread (`current_mesh`)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        src = np.array(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for idx, d in np.ndenumerate(src):
            arr[idx] = _normal(d)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"devices of shape {arr.shape} need {arr.ndim} axis names, got "
                             f"{axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names repeat: {axis_names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        kinds = sorted({str(d) for d in arr.flat})
        if len(kinds) > 1:
            raise ValueError(f"a mesh over the devices {kinds} {_MULTI_CARD}; every entry "
                             "must be the same device, one virtual rank each")
        self.devices = arr
        self.axis_names = axis_names

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        return collections.OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def device(self) -> torch.device:
        """The one device every virtual rank runs on."""
        return self.devices.flat[0]

    def axis_size(self, name: Optional[str]) -> int:
        """The size of axis `name` (1 for None); a ValueError names an axis
        the mesh does not have."""
        if name is None:
            return 1
        if name not in self.axis_names:
            raise ValueError(f"mesh axis {name!r} is not one of {self.axis_names}")
        return self.shape[name]

    def __enter__(self) -> "Mesh":
        stack = getattr(_current, "stack", None)
        if stack is None:
            stack = _current.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _current.stack.pop()

    def __repr__(self) -> str:
        sizes = ", ".join(f"{n}={s}" for n, s in self.shape.items())
        return f"Mesh({sizes}, device={self.device})"


def current_mesh() -> Optional[Mesh]:
    """The innermost mesh entered with `with mesh:` in this thread, or None."""
    stack = getattr(_current, "stack", None)
    return stack[-1] if stack else None


def mesh_axis_size(name: Optional[str]) -> int:
    """The size of axis `name` of the current mesh (1 for None). A name set
    while no current mesh has that axis raises ValueError."""
    if name is None:
        return 1
    mesh = current_mesh()
    if mesh is None:
        raise ValueError(f"mesh axis {name!r} is set but no mesh is current: run the call "
                         "under `with mesh:`")
    return mesh.axis_size(name)


def make_mesh(
    dp: int = 1,
    sp: int = 1,
    tp: int = 1,
    *,
    devices: Optional[Sequence] = None,
    axis_names: Sequence[str] = ("dp", "sp", "tp"),
) -> Mesh:
    """Build a Mesh of shape (dp, sp, tp) from `devices` (default: the
    visible CUDA devices). A size of -1 absorbs the remaining devices.
    Pass `devices=[torch.device("cuda")] * 8` for eight virtual ranks on one
    card, or `[torch.device("cpu")] * 8` for the plain path."""
    if devices is None:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            raise ValueError(f"a mesh with one rank a process of torch.distributed {_MULTI_CARD}")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    sizes = [dp, sp, tp]
    known = int(np.prod([s for s in sizes if s != -1]))
    for i, s in enumerate(sizes):
        if s == -1:
            sizes[i] = len(devices) // known
    total = int(np.prod(sizes))
    if total > len(devices):
        raise ValueError(f"mesh {sizes} needs {total} devices, have {len(devices)}")
    arr = np.empty(total, dtype=object)
    arr[:] = devices[:total]
    return Mesh(arr.reshape(sizes), axis_names=tuple(axis_names))
