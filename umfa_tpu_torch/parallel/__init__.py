"""The multi-device layer (port of umfa_tpu/parallel/).

The ring of flash-attention calls (`ring.py`), the ring with its own
kernels, forward and backward (`ring_pallas.py`), and the transports that
carry a ring's hops (`transport.py`): `LocalRing(n)` for n virtual ranks on
one device, `SelfLoop(n_steps)`, and `DistRing` over `torch.distributed`.
The mesh layer on one device: `make_mesh` (`mesh.py`), `sharded_attention`
(`sharded.py`: batch, heads and the sequence over a mesh) and
`pipeline_apply` (`pipeline.py`: the GPipe tick schedule).

    from umfa_tpu_torch.parallel import LocalRing, ring_flash_attention_pallas
    out, lse = ring_flash_attention_pallas(q, k, v, ring=LocalRing(4), causal=True,
                                           return_lse=True)
    mesh = make_mesh(dp=2, tp=4, devices=[torch.device("cuda")] * 8)
    out = sharded_attention(mesh, causal=True)(q, k, v)
"""

from umfa_tpu_torch.parallel.mesh import Mesh, current_mesh, make_mesh
from umfa_tpu_torch.parallel.pipeline import pipeline_apply
from umfa_tpu_torch.parallel.ring import (
    merge_partials,
    ring_flash_attention,
    zigzag_shard,
    zigzag_unshard,
)
from umfa_tpu_torch.parallel.ring_pallas import ring_flash_attention_pallas
from umfa_tpu_torch.parallel.sharded import sharded_attention
from umfa_tpu_torch.parallel.transport import DistRing, LocalRing, SelfLoop

__all__ = [
    "make_mesh",
    "sharded_attention",
    "pipeline_apply",
    "Mesh",
    "current_mesh",
    "ring_flash_attention",
    "ring_flash_attention_pallas",
    "merge_partials",
    "zigzag_shard",
    "zigzag_unshard",
    "LocalRing",
    "SelfLoop",
    "DistRing",
]
