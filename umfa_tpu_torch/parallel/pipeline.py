"""GPipe-style pipeline parallelism over a mesh axis (port of
umfa_tpu/parallel/pipeline.py).

Stage i's weights live on pipeline rank i (a leading stage dimension), the
batch is split into M microbatches, and the schedule runs S + M - 1 ticks.
On each tick every stage applies itself to its in-flight microbatch: stage
0 reads a fresh microbatch, every other stage what it was handed on the
tick before (zeros at first); the last stage banks microbatch t - (S - 1);
then the activations rotate one hop along the axis. The port runs the
ranks of a one-device `Mesh` in lockstep and rotates through the ring
transport's differentiable `ppermute` (parallel/transport.py), so `fn` runs
S·(S + M - 1) times, the fill and drain ticks included, as in the
reference, and gradients flow through autograd.

Every stage maps activations of one shape to the same shape; the bubble
fraction is (S - 1)/(S + M - 1).
"""

from __future__ import annotations

from typing import Callable

import torch

from umfa_tpu_torch.parallel.mesh import Mesh
from umfa_tpu_torch.parallel.transport import LocalRing, ppermute


def pipeline_apply(
    fn: Callable,
    stacked_params: dict,
    x: torch.Tensor,
    *,
    mesh: Mesh,
    axis: str = "pp",
    num_microbatches: int,
) -> torch.Tensor:
    """Apply the mesh axis's S stages to x with pipeline parallelism.

    fn(params_i, x) -> y: one stage (shape-preserving). stacked_params: a
    dict of tensors whose leading dimension is the stage (its size that of
    `axis`). x: (B, ...), B divisible by num_microbatches. Computes
    `for i in range(S): x = fn(params_i, x)`."""
    s = mesh.axis_size(axis)
    b, m = x.shape[0], num_microbatches
    if m < 1 or b % m:
        raise ValueError(f"batch {b} not divisible by microbatches {m}")
    if x.device != mesh.device:
        raise ValueError(f"x lies on {x.device}, the mesh on {mesh.device}")
    for name, p in stacked_params.items():
        if p.shape[0] != s:
            raise ValueError(f"{name} has {p.shape[0]} stages, axis {axis!r} has {s}")
    params = [{name: p[i] for name, p in stacked_params.items()} for i in range(s)]
    x_mb = x.reshape(m, b // m, *x.shape[1:])
    ring = LocalRing(s)
    state = [x.new_zeros(x_mb.shape[1:]) for _ in range(s)]
    out = [None] * m
    for t in range(m + s - 1):
        ys = [fn(params[i], x_mb[min(t, m - 1)] if i == 0 else state[i]) for i in range(s)]
        done = t - (s - 1)
        if done >= 0:
            out[done] = ys[s - 1]
        # One hop forward (stage i -> i + 1); the wrap (last -> 0) carries
        # what stage 0 ignores.
        state = ppermute(ys, ring)
    return torch.stack(out).reshape(x.shape)
