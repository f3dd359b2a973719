"""Heads-, batch- and sequence-sharded attention over a mesh (port of
umfa_tpu/parallel/sharded.py).

The reference wraps a per-device body in `shard_map`: the batch rides
`data_axis`, the heads ride `head_axis` (each device attends its resident
heads, no traffic), and a long sequence rides `seq_axis` through ring
attention. The port keeps that body and the split, over the virtual ranks
of a one-device `Mesh` (parallel/mesh.py): the returned callable takes the
global (B, H, S, D) tensors, runs the body once for each (data, head)
shard, the sequence shards of each as a `LocalRing`, and puts the outputs
back in place. It adds no kernel: each shard runs `flash_attention` (table
rows 1-3) or `quantized_flash_attention` (rows 7-9, or rows 5-6 where the
route rule sends the call), and the ring runs one of those a rank and step.

The reference's `interpret` and `jit` are TPU/XLA switches and its
`block_sizes` a Pallas tiling; the port's calls pick their own tiles, so
all three are dropped.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from umfa_tpu_torch.engine.config import QuantizationConfig
from umfa_tpu_torch.ops.attention import flash_attention
from umfa_tpu_torch.ops.quant_attention import quantized_flash_attention
from umfa_tpu_torch.parallel.mesh import Mesh
from umfa_tpu_torch.parallel.ring import ring_flash_attention, zigzag_shard, zigzag_unshard
from umfa_tpu_torch.parallel.transport import LocalRing


def _quantized_ring(q, k, v, ring, *, causal, scale, quantization, zigzag):
    """The ring under an integer quantization (sharded.py:61-113).

    Per-chunk smoothing would shift each chunk's LSE by its own constant and
    break the ring's online-softmax merge, so the chunk calls run with it
    off. Global K/V channel means (the mean of the chunk means, fp32) are
    merge-safe: the K shift is the same for every chunk, and since the
    merged weights sum to 1 a row, the V mean goes back on once after the
    ring. The Q-mean term would need a per-chunk score correction, skipped
    as in the reference."""
    f32 = torch.float32
    km = torch.stack([c.float().mean(dim=2, keepdim=True) for c in ring.shard(k)]).mean(dim=0)
    vm = torch.stack([c.float().mean(dim=2, keepdim=True) for c in ring.shard(v)]).mean(dim=0)
    k = (k.float() - km).to(k.dtype)
    v = (v.float() - vm).to(v.dtype)
    qcfg = dataclasses.replace(quantization, smooth=False)

    def local_attention(qc, kc, vc, bias):
        return quantized_flash_attention(qc, kc, vc, bias, config=qcfg, scale=scale,
                                         return_lse=True)

    out = ring_flash_attention(q, k, v, ring=ring, causal=causal, scale=scale,
                               local_attention=local_attention, zigzag=zigzag)
    group = out.shape[1] // vm.shape[1]
    vm_q = torch.repeat_interleave(vm, group, dim=1) if group > 1 else vm
    return (out.to(f32) + vm_q).to(out.dtype)


def sharded_attention(
    mesh: Mesh,
    *,
    data_axis: Optional[str] = "dp",
    head_axis: Optional[str] = "tp",
    seq_axis: Optional[str] = None,
    causal: bool = False,
    scale: Optional[float] = None,
    quantization: Optional[QuantizationConfig] = None,
    zigzag: bool = False,
) -> Callable:
    """Build a sharded attention callable over `mesh`.

    The returned fn takes q (B, Hq, S, D) and k, v (B, Hkv, S, D) on the
    mesh's device and returns the attention output (B, Hq, S, D),
    differentiable in q, k and v: B split over `data_axis`, the heads over
    `head_axis` (Hkv must divide by its size, so each rank's q heads map onto
    its own kv heads), S over `seq_axis` (ring attention over a `LocalRing`)
    or whole on every rank. zigzag=True (ring only) reorders the sequence
    into the zigzag layout before the ring and back after it, which balances
    causal work across the ring."""
    if zigzag and seq_axis is None:
        raise ValueError("zigzag requires a ring (seq_axis)")
    dp, tp, sp = (mesh.axis_size(a) for a in (data_axis, head_axis, seq_axis))
    quantized = quantization is not None and quantization.q_precision.is_integer

    def local(q, k, v):
        """One (data, head) shard: the reference's shard_map body."""
        if quantized and seq_axis is None:
            return quantized_flash_attention(q, k, v, config=quantization, causal=causal,
                                             scale=scale)
        if seq_axis is not None:
            ring = LocalRing(sp)
            if quantized:
                return _quantized_ring(q, k, v, ring, causal=causal, scale=scale,
                                       quantization=quantization, zigzag=zigzag)
            return ring_flash_attention(q, k, v, ring=ring, causal=causal, scale=scale,
                                        zigzag=zigzag)
        return flash_attention(q, k, v, causal=causal, scale=scale)

    def fn(q, k, v):
        b, hq = q.shape[:2]
        hkv = k.shape[1]
        for t in (q, k, v):
            if t.device != mesh.device:
                raise ValueError(f"an input lies on {t.device}, the mesh on {mesh.device}")
        if b % dp or hq % tp or hkv % tp:
            raise ValueError(f"batch {b} must divide by {data_axis}={dp}, and q heads {hq} and "
                             f"kv heads {hkv} by {head_axis}={tp}")
        if zigzag:
            q, k, v = (zigzag_shard(t, sp) for t in (q, k, v))
        bl, hl, kl = b // dp, hq // tp, hkv // tp
        rows = []
        for i in range(dp):
            bs = slice(i * bl, (i + 1) * bl)
            rows.append(torch.cat([
                local(q[bs, j * hl:(j + 1) * hl], k[bs, j * kl:(j + 1) * kl],
                      v[bs, j * kl:(j + 1) * kl])
                for j in range(tp)], dim=1))
        out = torch.cat(rows, dim=0)
        return zigzag_unshard(out, sp) if zigzag else out

    return fn
