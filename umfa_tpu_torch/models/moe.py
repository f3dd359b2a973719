"""DeepSeek-style Mixture-of-Experts FFN (port of umfa_tpu/models/moe.py).

Gating: softmax router probabilities (fp32), top-k, renormalized over the
chosen experts, times `routed_scale`, plus always-active shared experts;
the load-balance loss E·Σ f_e·p_e is returned beside the output. Two
dispatches, as the reference:

- "ragged" (default, dropless): the token→expert slots stably sorted by
  expert, each expert's rows through its SwiGLU as one group of matmuls
  (the reference's `jax.lax.ragged_dot`, an XLA op, becomes a loop over
  the experts);
- "dense" (GShard capacity dispatch): a per-expert capacity; a token past
  its expert's capacity is dropped from that expert (the residual carries
  it). The reference's one-hot (T, E, C) einsums become the same gathers
  and writes by index, each (expert, slot) written by its one token.

Both combine without atomics: each slot's weighted output goes back to its
(token, k) place and the K of a token are summed by one reduction, so a
call gives the same bits every time (`index_add_` on CUDA would not).

Expert parallelism (`ep_axis`, `ep_specs`): under the current `Mesh`
(parallel/mesh.py, `with mesh:`) of virtual ranks on one device, the dense
dispatch splits its (E, C, dim) block into the ep ranks' expert groups and
each rank runs its own experts' SwiGLU; the combine keeps its fixed order.
The ragged dispatch ignores `ep_axis`, as the reference's does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from umfa_tpu_torch.parallel.mesh import mesh_axis_size
from umfa_tpu_torch.utils.device import default_device

EXPERT_PARAMS = ("router", "w1", "w3", "w2")
SHARED_PARAMS = ("ws1", "ws3", "ws2")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    dim: int = 256
    hidden: int = 512            # per-expert SwiGLU hidden width
    num_experts: int = 8         # routed experts
    top_k: int = 2
    n_shared: int = 0            # shared experts (always active)
    routed_scale: float = 1.0    # DeepSeek routed_scaling_factor
    capacity_factor: float = 1.5  # dense dispatch only
    dispatch: str = "ragged"     # "ragged" (dropless) | "dense" (capacity)
    dtype: str = "bfloat16"
    # Mesh axis for expert parallelism (dense dispatch; module docstring).
    ep_axis: Optional[str] = None

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def _param_names(cfg: MoEConfig) -> tuple:
    return EXPERT_PARAMS + (SHARED_PARAMS if cfg.n_shared else ())


class MoE(nn.Module):
    """The FFN's parameters under their JAX names (router fp32, the experts
    w1, w3 (E, dim, hidden) and w2 (E, hidden, dim), the shared ws1, ws3,
    ws2 in the config's dtype); `moe_ffn` runs them."""

    def __init__(self, cfg: MoEConfig, **weights):
        super().__init__()
        for name in _param_names(cfg):
            setattr(self, name, nn.Parameter(weights[name]))


def init_params(cfg: MoEConfig, generator: Optional[torch.Generator] = None,
                device=None) -> MoE:
    """Random weights with the reference's scales (N(0,1)·dim^-0.5, w2 by
    hidden^-0.5, ws2 by (hidden·n_shared)^-0.5), the router in fp32. Drawn
    in fp32 on the CPU from `generator`; the numbers differ from
    jax.random."""
    device = default_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    d, h, e = cfg.dim, cfg.hidden, cfg.num_experts

    def normal(shape, std, dtype=cfg.tdtype):
        return (torch.randn(shape, generator=g) * std).to(device=device, dtype=dtype)

    p = dict(router=normal((d, e), d**-0.5, torch.float32), w1=normal((e, d, h), d**-0.5),
             w3=normal((e, d, h), d**-0.5), w2=normal((e, h, d), h**-0.5))
    if cfg.n_shared:
        hs = h * cfg.n_shared
        p.update(ws1=normal((d, hs), d**-0.5), ws3=normal((d, hs), d**-0.5),
                 ws2=normal((hs, d), hs**-0.5))
    return MoE(cfg, **p)


def params_from_jax(params_np: dict, cfg: MoEConfig, device=None) -> MoE:
    """Carry JAX parameters into the port: the router stays fp32 (gate
    order is precision-sensitive), the rest in the config's dtype."""
    device = default_device(device)

    def t(name):
        dtype = torch.float32 if name == "router" else cfg.tdtype
        return torch.from_numpy(np.array(params_np[name], np.float32)).to(device=device,
                                                                          dtype=dtype)

    return MoE(cfg, **{name: t(name) for name in _param_names(cfg)})


def ep_specs(cfg: MoEConfig) -> dict:
    """Expert-parallel placement of each parameter, as a tuple of mesh axis
    names for its leading dimensions (the reference's PartitionSpecs): the
    expert-stacked w1, w3 and w2 split their expert dimension over
    `cfg.ep_axis`; the router and the shared experts are whole on every
    rank."""
    specs = {"router": (), "w1": (cfg.ep_axis,), "w3": (cfg.ep_axis,), "w2": (cfg.ep_axis,)}
    if cfg.n_shared:
        specs.update(ws1=(), ws3=(), ws2=())
    return specs


def router_topk(params: MoE, x: torch.Tensor,
                cfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (T, dim) → (weights (T, K) fp32, expert idx (T, K) int64, full
    probabilities (T, E) fp32 for the aux loss)."""
    probs = torch.softmax(torch.matmul(x.float(), params.router.float()), dim=-1)
    w, idx = torch.topk(probs, cfg.top_k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-20)  # norm_topk_prob
    return w * cfg.routed_scale, idx, probs


def load_balance_loss(probs: torch.Tensor, idx: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Switch/GShard auxiliary loss E · Σ_e f_e · p_e, 1 at a uniform route.
    probs: (T, E); idx: (T, K)."""
    f = torch.bincount(idx.reshape(-1), minlength=num_experts).float()
    f = f / torch.clamp(f.sum(), min=1.0)
    return num_experts * torch.sum(f * probs.mean(0))


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (batched over leading dims) with fp32 sums, rounded to a's dtype."""
    return torch.matmul(a.float(), b.to(a.dtype).float()).to(a.dtype)


def _swiglu(xe, w1, w3, w2):
    return _dot(F.silu(_dot(xe, w1)) * _dot(xe, w3), w2)


def _moe_ragged(params: MoE, x, w, idx, cfg: MoEConfig):
    """Dropless dispatch: the (T·K) slots stably sorted by expert, each
    expert's rows through its SwiGLU, the weighted outputs put back in
    (T, K) order and summed over K. Returns (T, dim) fp32."""
    t, d = x.shape
    k, e = cfg.top_k, cfg.num_experts
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)    # slots grouped by expert
    xs = x[order // k]                              # (T·K, d) gather
    sizes = torch.bincount(flat_e, minlength=e).tolist()
    ys = torch.cat([_swiglu(rows, params.w1[i], params.w3[i], params.w2[i])
                    for i, rows in enumerate(torch.split(xs, sizes))])
    ys = ys.float() * w.reshape(-1)[order].float()[:, None]
    return ys[torch.argsort(order)].reshape(t, k, d).sum(dim=1)


def _moe_dense(params: MoE, x, w, idx, cfg: MoEConfig):
    """GShard capacity dispatch: token t's slot in expert e is the count of
    earlier tokens routed to e; slots at or past the capacity are dropped.
    Under `ep_axis` each ep rank runs its own group of experts. Returns
    (T, dim) fp32."""
    t, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    cap = max(int(cfg.capacity_factor * k * t / e), k)
    with torch.no_grad():
        cw = torch.zeros((t, e), dtype=torch.float32, device=x.device)
        cw.scatter_(1, idx, w.float())  # top-k never repeats an expert per token
        pos = torch.cumsum((cw > 0).to(torch.int32), dim=0) - 1  # slot in expert
        slot = pos.gather(1, idx)                                # (T, K)
        kept = (cw.gather(1, idx) > 0) & (slot < cap)
        slot = torch.where(kept, slot, cap).reshape(-1)          # dropped → scratch row
    toks = torch.arange(t, device=x.device).repeat_interleave(k)
    experts = idx.reshape(-1)
    xe = x.new_zeros((e, cap + 1, d)).index_put((experts, slot), x[toks])[:, :cap]
    ep = mesh_axis_size(cfg.ep_axis)
    if e % ep:
        raise ValueError(f"{e} experts do not divide over {cfg.ep_axis}={ep}")
    g = e // ep  # each ep rank's experts
    ye = torch.cat([_swiglu(xe[r * g:(r + 1) * g], params.w1[r * g:(r + 1) * g],
                            params.w3[r * g:(r + 1) * g], params.w2[r * g:(r + 1) * g])
                    for r in range(ep)])                          # (E, C, d)
    ye = torch.cat([ye, ye.new_zeros((e, 1, d))], dim=1)         # the scratch row reads 0
    yk = ye[experts, slot].float() * (w.float() * kept).reshape(-1)[:, None]
    return yk.reshape(t, k, d).sum(dim=1)


def moe_ffn(params: MoE, x: torch.Tensor, cfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, dim) → (y (B, S, dim) in x's dtype, aux load-balance loss)."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    w, idx, probs = router_topk(params, xf, cfg)
    aux = load_balance_loss(probs, idx, cfg.num_experts)
    if cfg.dispatch == "ragged":
        y = _moe_ragged(params, xf, w, idx, cfg)
    elif cfg.dispatch == "dense":
        y = _moe_dense(params, xf, w, idx, cfg)
    else:
        raise ValueError(f"unknown dispatch {cfg.dispatch!r}")
    if cfg.n_shared:
        h = F.silu(torch.matmul(xf, params.ws1)) * torch.matmul(xf, params.ws3)
        y = y + torch.matmul(h, params.ws2).float()
    return y.reshape(b, s, d).to(x.dtype), aux
