"""FLUX-style DiT attention stack (port of umfa_tpu/models/dit.py).

adaLN-zero modulated pre-LN transformer blocks whose attention runs through
the port's flash kernels, dense (`flash_attention`: rows 1-3) or with
`cfg.quantization` through `quantized_flash_attention` (rows 7-9, STE
gradients), with RoPE. The rotation is the reference's: `apply_rope` in its
default interleaved pairing on Q and K before the attention call
(dit.py:127-144), so the DiT does not take `rope_attention`'s in-kernel
route. The projections, MLP and modulation are plain torch matmuls, as the
reference leaves them to XLA.

Parameters keep the JAX layouts (wqkv (dim, 3, H, Dh), wo (H, Dh, dim), w1,
b1, w2, b2, wmod (dim, 6, dim), bmod (6, dim)) so `params_from_jax` carries
a JAX checkpoint over as is. Every parameter requires grad: `forward` runs
under autograd, so a loss on its output takes `.backward()`.

Numerics held to the reference: LayerNorm without affine, eps 1e-6,
population variance, in fp32 and cast back (`models/gpt.py` `_ln`); GELU
with the tanh approximation (jax.nn.gelu's default); the modulation from
`silu` of the fp32 cond and an fp32 einsum, then cast to the model dtype.

The reference's `tp_axis`/`sp_axis` routes run the same forward inside
`shard_map` (dit.py:84-160). The port runs them over the current `Mesh`
(parallel/mesh.py, `with mesh:`) of virtual ranks on one device: `forward`
takes the global x (B, S, dim) and the whole parameters, splits the batch
over the mesh's "dp" axis (where it has one); over `tp_axis` it splits the
heads (`wqkv[:, :, h]`, `wo[h]`) and the MLP's hidden columns (`w1[:, c]`,
`b1[c]`, `w2[c]`) and adds the ranks' fp32 partials in rank order, cast once
after the sum where the reference's `_tp_psum` sits; over `sp_axis` the
attention is ring attention over a `LocalRing` (RoPE at global positions).
Gradients are plain autograd on the whole parameters, so they equal the
single-device gradients (the reference's shard_map step scales the
tp-sharded ones by tp and all of them by sp: ROADMAP.md, "Reference faults
not queued").
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from umfa_tpu_torch.engine.config import QuantizationConfig
from umfa_tpu_torch.models.gpt import _ln
from umfa_tpu_torch.ops.attention import flash_attention
from umfa_tpu_torch.ops.quant_attention import quantized_flash_attention
from umfa_tpu_torch.ops.rope import apply_rope, rope_angles
from umfa_tpu_torch.parallel.mesh import current_mesh, mesh_axis_size
from umfa_tpu_torch.parallel.ring import ring_flash_attention
from umfa_tpu_torch.parallel.transport import LocalRing
from umfa_tpu_torch.utils.device import default_device

PARAMS = ("wqkv", "wo", "w1", "b1", "w2", "b2", "wmod", "bmod")


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    dim: int = 512
    num_heads: int = 8
    depth: int = 2
    mlp_ratio: int = 4
    causal: bool = False
    rope: bool = True
    dtype: str = "bfloat16"
    quantization: Optional[QuantizationConfig] = None
    # Mesh axis names of the current mesh (None = single device).
    tp_axis: Optional[str] = None
    sp_axis: Optional[str] = None

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


class Block(nn.Module):
    def __init__(self, **weights):
        super().__init__()
        for name in PARAMS:
            setattr(self, name, nn.Parameter(weights[name]))


class DiT(nn.Module):
    """Parameters in the JAX layouts; `forward(x, cond)` maps x (B, S, dim)
    and cond (B, dim) to (B, S, dim), differentiable in every parameter."""

    def __init__(self, cfg: DiTConfig, blocks):
        super().__init__()
        self.cfg = cfg
        self.blocks = nn.ModuleList(Block(**b) for b in blocks)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block_forward(block, x, cond, self.cfg)
        return x


def init_params(cfg: DiTConfig, generator: Optional[torch.Generator] = None,
                device=None) -> DiT:
    """Random weights with the reference's scales (N(0,1)·dim^-0.5, w2 by
    hidden^-0.5, wmod by 0.1·dim^-0.5, biases 0). Drawn in fp32 on the CPU
    from `generator`, so a seed gives the same weights on every device; the
    numbers differ from jax.random."""
    device = default_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    dim, heads, dh = cfg.dim, cfg.num_heads, cfg.head_dim
    hidden = dim * cfg.mlp_ratio
    s = dim**-0.5

    def normal(shape, std):
        return (torch.randn(shape, generator=g) * std).to(device=device, dtype=cfg.tdtype)

    def zeros(shape):
        return torch.zeros(shape, device=device, dtype=cfg.tdtype)

    blocks = [
        dict(wqkv=normal((dim, 3, heads, dh), s), wo=normal((heads, dh, dim), s),
             w1=normal((dim, hidden), s), b1=zeros((hidden,)),
             w2=normal((hidden, dim), hidden**-0.5), b2=zeros((dim,)),
             wmod=normal((dim, 6, dim), s * 0.1), bmod=zeros((6, dim)))
        for _ in range(cfg.depth)
    ]
    return DiT(cfg, blocks)


def params_from_jax(params_np: dict, cfg: DiTConfig, device=None) -> DiT:
    """Carry JAX parameters (the nested dict after
    `jax.tree_util.tree_map(np.asarray, params)`) into the port as trainable
    parameters, in the config's dtype."""
    device = default_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device=device, dtype=cfg.tdtype)

    return DiT(cfg, [{name: t(b[name]) for name in PARAMS} for b in params_np["blocks"]])


def _attention(q, k, v, cfg: DiTConfig, sp: int = 1):
    """(B, H, S, Dh) → same (dit.py:90-105): over `sp_axis` a ring of `sp`
    ranks, each holding S / sp of the sequence."""
    if cfg.quantization is not None:
        return quantized_flash_attention(q, k, v, config=cfg.quantization, causal=cfg.causal)
    if cfg.sp_axis is not None:
        return ring_flash_attention(q, k, v, ring=LocalRing(sp), causal=cfg.causal)
    return flash_attention(q, k, v, causal=cfg.causal)


def _mesh_sizes(cfg: DiTConfig) -> tuple:
    """(dp, sp, tp) of the current mesh for cfg's axes; (1, 1, 1) without
    axes. An axis that no current mesh has raises ValueError."""
    if cfg.tp_axis is None and cfg.sp_axis is None:
        return 1, 1, 1
    if cfg.quantization is not None and cfg.sp_axis is not None:
        raise ValueError("quantized ring attention in the DiT is not in the reference "
                         "(dit.py:95): set sp_axis=None with a quantization")
    tp, sp = mesh_axis_size(cfg.tp_axis), mesh_axis_size(cfg.sp_axis)
    dp = mesh_axis_size("dp") if "dp" in current_mesh().axis_names else 1
    return dp, sp, tp


def block_forward(block: Block, x: torch.Tensor, cond: torch.Tensor,
                  cfg: DiTConfig) -> torch.Tensor:
    """One DiT block. x: (B, S, dim); cond: (B, dim). With cfg's mesh axes
    set, x and cond are global: the batch splits over "dp", the heads and
    MLP columns over `tp_axis`, the sequence over `sp_axis`."""
    dp, sp, tp = _mesh_sizes(cfg)
    if x.shape[0] % dp or x.shape[1] % sp or cfg.num_heads % tp or (cfg.dim * cfg.mlp_ratio) % tp:
        raise ValueError(f"batch {x.shape[0]}, sequence {x.shape[1]}, {cfg.num_heads} heads and "
                         f"{cfg.dim * cfg.mlp_ratio} MLP columns must divide by dp={dp}, "
                         f"sp={sp} and tp={tp}")
    if dp > 1:
        return torch.cat([_block(block, xi, ci, cfg, sp, tp)
                          for xi, ci in zip(x.chunk(dp), cond.chunk(dp))])
    return _block(block, x, cond, cfg, sp, tp)


def _block(block: Block, x, cond, cfg: DiTConfig, sp: int, tp: int):
    """One data rank's block: tp head and column shards, the ring over sp."""
    mod = (torch.einsum("bd,dme->bme", F.silu(cond.float()), block.wmod.float())
           + block.bmod.float()).to(x.dtype)  # (B, 6, dim)
    shift_a, scale_a, gate_a, shift_m, scale_m, gate_m = (mod[:, i][:, None, :]
                                                          for i in range(6))

    # --- attention (heads over tp) ---
    h = _ln(x) * (1 + scale_a) + shift_a
    if cfg.rope:
        # The reference's in-block tables (dit.py:127-144) are rope_angles';
        # the ring's chunk j holds rows j·S/sp onward, its global positions.
        cos, sin = rope_angles(x.shape[1], cfg.head_dim, device=x.device)
    heads = cfg.num_heads // tp
    partials = []
    for r in range(tp):
        hs = slice(r * heads, (r + 1) * heads)
        qkv = torch.einsum("bsd,dthe->btshe", h, block.wqkv[:, :, hs])  # t ∈ {q, k, v}
        q, k, v = (qkv[:, i].transpose(1, 2) for i in range(3))  # (B, H/tp, S, Dh)
        if cfg.rope:
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        attn = _attention(q, k, v.contiguous(), cfg, sp)
        partials.append(torch.einsum("bhse,hed->bsd", attn.to(x.dtype), block.wo[hs]))
    x = x + gate_a * _tp_sum(partials, x.dtype)

    # --- MLP (w1 column-sharded, w2 row-sharded over tp) ---
    h = _ln(x) * (1 + scale_m) + shift_m
    cols = cfg.dim * cfg.mlp_ratio // tp
    partials = []
    for r in range(tp):
        cs = slice(r * cols, (r + 1) * cols)
        hc = torch.einsum("bsd,dk->bsk", h, block.w1[:, cs]) + block.b1[cs]
        hc = F.gelu(hc.float(), approximate="tanh").to(x.dtype)
        partials.append(torch.einsum("bsk,kd->bsd", hc, block.w2[cs]))
    h = _tp_sum(partials, x.dtype) + block.b2
    return x + gate_m * h


def _tp_sum(partials, dtype):
    """The reference's `_tp_psum`: each rank's product cast to fp32, the
    ranks added in rank order, cast back once (a no-op at tp 1)."""
    if len(partials) == 1:
        return partials[0]
    total = partials[0].float()
    for p in partials[1:]:
        total = total + p.float()
    return total.to(dtype)


def forward(model: DiT, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    """DiT stack forward. x: (B, S, dim), cond: (B, dim)."""
    return model(x, cond)
