"""Ring attention over a sequence sharded into ring chunks, one flash
attention call per step with an online-softmax merge (port of
umfa_tpu/parallel/ring.py).

Each step every rank runs the port's differentiable `flash_attention`
(ops/attention.py: the kernels of table rows 1-3 on the card) on its
resident Q chunk against the K/V chunk it holds, with a step bias built
from global token positions under causal masking, merges the partial
(out, lse) into its running result, and rotates K/V to its right
neighbour through the transport's differentiable `ppermute`. This path
adds no kernel of its own.

`ring` is a transport of `parallel/transport.py`: with `LocalRing(n)` the
inputs hold the whole sequence (n contiguous chunks, or `zigzag_shard`'s
layout) and the result does too; with `DistRing` they hold this process's
chunk.
"""

from __future__ import annotations

from typing import Optional

import torch

from umfa_tpu_torch.ops.attention import flash_attention
from umfa_tpu_torch.ops.flash_fwd import DEFAULT_MASK_VALUE
from umfa_tpu_torch.parallel.transport import ppermute


def merge_partials(o1, lse1, o2, lse2):
    """Merge two normalized partial attention results.

    o_i: (B, H, S, D) softmax-normalized partial outputs; lse_i: (B, H, S)
    log-sum-exp of the partial score sets. The merged output is cast to
    o1's dtype."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    denom = w1 + w2
    safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    o = o1.float() * (w1 / safe)[..., None] + o2.float() * (w2 / safe)[..., None]
    return o.to(o1.dtype), m + torch.log(safe)


def _zigzag_order(s: int, n: int) -> list:
    if s % (2 * n):
        raise ValueError(f"sequence length {s} is not divisible by 2 * {n}")
    half = s // (2 * n)
    order = []
    for i in range(n):
        order.extend(range(i * half, (i + 1) * half))
        order.extend(range((2 * n - 1 - i) * half, (2 * n - i) * half))
    return order


def zigzag_shard(x: torch.Tensor, n: int, axis: int = 2) -> torch.Tensor:
    """Reorder a sequence axis into the zigzag layout for n ring ranks: the
    global sequence splits into 2n half-chunks and rank i receives
    (i, 2n-1-i), which balances causal work across the ring.
    `zigzag_unshard` inverts it."""
    order = torch.tensor(_zigzag_order(x.shape[axis], n), device=x.device)
    return torch.index_select(x, axis, order)


def zigzag_unshard(x: torch.Tensor, n: int, axis: int = 2) -> torch.Tensor:
    """Inverse of zigzag_shard."""
    order = _zigzag_order(x.shape[axis], n)
    inv = [0] * len(order)
    for dst, src in enumerate(order):
        inv[src] = dst
    return torch.index_select(x, axis, torch.tensor(inv, device=x.device))


def _global_positions(chunk_idx: int, n: int, s_loc: int, zigzag: bool, device=None):
    """Global token positions of the chunk held by ring position `chunk_idx`."""
    if zigzag:
        half = s_loc // 2
        lo = chunk_idx * half + torch.arange(half, device=device)
        hi = (2 * n - 1 - chunk_idx) * half + torch.arange(half, device=device)
        return torch.cat([lo, hi])
    return chunk_idx * s_loc + torch.arange(s_loc, device=device)


def ring_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    ring,
    causal: bool = False,
    scale: Optional[float] = None,
    local_attention=None,
    zigzag: bool = False,
):
    """Flash attention over a sequence sharded across the ranks of `ring`
    (contiguous chunks, or with zigzag=True the `zigzag_shard` layout).
    q: (B, Hq, S, D); k, v: (B, Hkv, S, D). Returns the output in q's
    layout; differentiable.

    `local_attention(q, k, v, bias) -> (out, lse)` overrides the per-step
    attention."""
    n = ring.n
    qs, ks, vs = ring.shard(q), ring.shard(k), ring.shard(v)
    batch, heads, s_loc, d = qs[0].shape
    outs = []
    for i, my in enumerate(ring.ranks):
        o = torch.zeros((batch, heads, s_loc, d), dtype=q.dtype, device=q.device)
        lse = torch.full((batch, heads, s_loc), DEFAULT_MASK_VALUE, device=q.device)
        outs.append([o, lse])
    if causal:
        qpos = [_global_positions(my, n, s_loc, zigzag, q.device) for my in ring.ranks]
    for step in range(n):
        for i, my in enumerate(ring.ranks):
            src = (my - step) % n  # ring position of the chunk held now
            bias = None
            if causal:
                kpos = _global_positions(src, n, s_loc, zigzag, q.device)
                keep = kpos[None, :] <= qpos[i][:, None]
                bias = torch.where(keep, 0.0, DEFAULT_MASK_VALUE).float()[None, None]
            if local_attention is not None:
                o_step, lse_step = local_attention(qs[i], ks[i], vs[i], bias)
            else:
                o_step, lse_step = flash_attention(qs[i], ks[i], vs[i], bias, scale=scale,
                                                   return_lse=True)
            outs[i] = list(merge_partials(outs[i][0], outs[i][1], o_step, lse_step))
        if step != n - 1:
            ks = ppermute(ks, ring)
            vs = ppermute(vs, ring)
    return ring.unshard([o for o, _ in outs])
