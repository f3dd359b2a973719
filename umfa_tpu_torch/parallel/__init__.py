"""Sequence-parallel ring attention (port of umfa_tpu/parallel/).

Ported: the ring of flash-attention calls (`ring.py`), the ring with its
own kernels, forward and backward (`ring_pallas.py`), and the transports
that carry a ring's hops (`transport.py`): `LocalRing(n)` for n virtual
ranks on one device, `SelfLoop(n_steps)`, and `DistRing` over
`torch.distributed`. `make_mesh`, `sharded_attention` and `pipeline_apply`
are not ported yet (ROADMAP.md).

    from umfa_tpu_torch.parallel import LocalRing, ring_flash_attention_pallas
    out, lse = ring_flash_attention_pallas(q, k, v, ring=LocalRing(4), causal=True,
                                           return_lse=True)
"""

from umfa_tpu_torch.parallel.ring import (
    merge_partials,
    ring_flash_attention,
    zigzag_shard,
    zigzag_unshard,
)
from umfa_tpu_torch.parallel.ring_pallas import ring_flash_attention_pallas
from umfa_tpu_torch.parallel.transport import DistRing, LocalRing, SelfLoop

__all__ = [
    "ring_flash_attention",
    "ring_flash_attention_pallas",
    "merge_partials",
    "zigzag_shard",
    "zigzag_unshard",
    "LocalRing",
    "SelfLoop",
    "DistRing",
]
