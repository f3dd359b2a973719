"""DeepSeek-style MLA (Multi-head Latent Attention) layer (port of
umfa_tpu/models/mla_model.py).

KV is compressed into a small latent per token (`compress_kv`), and
decompressed through per-layer up-projections at attention time
(`attend`), whose fused attention is `flash_attention` (ops/attention.py,
the `flash_fwd` kernel on the card). With `indexer_topk`, the sparse
indexer's relu(QKᵀ) scores in latent space keep the top-k keys of each
query as an additive 0 / -1e30 bias; under causal, a row whose kept keys
all lie in its future sees only -1e30 biases and averages V over its
visible keys (a bias is not an index mask). Serving (`decode_step`) appends
to a LatentKVCache in place and attends in latent space by weight
absorption (`mla_absorbed_decode`), which launches no kernel.

Parameters keep the JAX names and layouts (wq (dim, dim), w_down (dim, L),
w_k_up and w_v_up (L, dim), wo (dim, dim)), so `params_from_jax` carries a
JAX checkpoint over as is.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from umfa_tpu_torch.ops.attention import flash_attention
from umfa_tpu_torch.ops.flash_fwd import DEFAULT_MASK_VALUE
from umfa_tpu_torch.ops.mla import (
    mla_absorbed_decode,
    mla_decompress,
    sparse_indexer_scores,
)
from umfa_tpu_torch.serving.kv_cache import LatentKVCache, append_latent
from umfa_tpu_torch.utils.device import default_device

PARAMS = ("wq", "w_down", "w_k_up", "w_v_up", "wo")


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    dim: int = 512
    num_heads: int = 8
    latent_dim: int = 64          # compressed KV width
    causal: bool = True
    dtype: str = "bfloat16"
    # Sparse indexer (DeepSeek-V3.2-exp style): keep the top-k keys per query.
    indexer_topk: Optional[int] = None

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


class MLA(nn.Module):
    """The layer's parameters under their JAX names; `forward(x)` is the
    module-level `forward` with this layer's config."""

    def __init__(self, cfg: MLAConfig, **weights):
        super().__init__()
        self.cfg = cfg
        for name in PARAMS:
            setattr(self, name, nn.Parameter(weights[name]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return forward(self, x, self.cfg)


def init_params(cfg: MLAConfig, generator: Optional[torch.Generator] = None,
                device=None) -> MLA:
    """Random weights with the reference's scales (N(0,1)·dim^-0.5, the
    up-projections by latent^-0.5). Drawn in fp32 on the CPU from
    `generator`, so a seed gives the same weights on every device; the
    numbers differ from jax.random."""
    device = default_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    dim, lat = cfg.dim, cfg.latent_dim

    def normal(shape, std):
        return (torch.randn(shape, generator=g) * std).to(device=device, dtype=cfg.tdtype)

    return MLA(cfg, wq=normal((dim, dim), dim**-0.5), w_down=normal((dim, lat), dim**-0.5),
               w_k_up=normal((lat, dim), lat**-0.5), w_v_up=normal((lat, dim), lat**-0.5),
               wo=normal((dim, dim), dim**-0.5))


def params_from_jax(params_np: dict, cfg: MLAConfig, device=None) -> MLA:
    """Carry JAX parameters (the dict after `jax.tree_util.tree_map(
    np.asarray, params)`) into the port, in the config's dtype."""
    device = default_device(device)
    return MLA(cfg, **{name: torch.from_numpy(np.array(params_np[name], np.float32)).to(
        device=device, dtype=cfg.tdtype) for name in PARAMS})


def compress_kv(params: MLA, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, dim) → the latent KV (B, S, latent), what a serving stack
    stores."""
    return torch.matmul(x, params.w_down)


def _queries(params: MLA, x: torch.Tensor, cfg: MLAConfig) -> torch.Tensor:
    b, s, _ = x.shape
    return torch.matmul(x, params.wq).reshape(b, s, cfg.num_heads, cfg.head_dim).transpose(1, 2)


@torch.no_grad()
def indexer_bias(params: MLA, x: torch.Tensor, latent: torch.Tensor,
                 topk: int) -> torch.Tensor:
    """The sparse indexer's mask: relu(QKᵀ) of the latent-space query
    against the latent, the top-k keys of each query kept (ties at the k-th
    score all kept) → (B, 1, S, S_kv) fp32 bias, 0 kept, -1e30 else."""
    scores = sparse_indexer_scores(compress_kv(params, x), latent)  # (B, S, S_kv)
    kth = torch.topk(scores, topk, dim=-1).values[..., -1:]
    bias = torch.where(scores >= kth, 0.0, DEFAULT_MASK_VALUE).to(torch.float32)
    return bias[:, None]


def attend(params: MLA, x: torch.Tensor, latent: torch.Tensor, cfg: MLAConfig) -> torch.Tensor:
    """Full MLA attention: Q from x, K/V decompressed from the latent, one
    `flash_attention` call (with the indexer's bias when `indexer_topk` is
    below the key count), the output projection."""
    b, s, d = x.shape
    q = _queries(params, x, cfg)
    k, v = mla_decompress(latent, params.w_k_up, params.w_v_up, num_heads=cfg.num_heads)
    bias = None
    if cfg.indexer_topk is not None and cfg.indexer_topk < latent.shape[1]:
        bias = indexer_bias(params, x, latent, cfg.indexer_topk)
    out = flash_attention(q, k, v, bias, causal=cfg.causal)
    out = out.transpose(1, 2).reshape(b, s, d).to(x.dtype)
    return torch.matmul(out, params.wo)


def forward(params: MLA, x: torch.Tensor, cfg: MLAConfig) -> torch.Tensor:
    return x + attend(params, x, compress_kv(params, x), cfg)


def absorbed_attend(params: MLA, x: torch.Tensor, cache: LatentKVCache, cfg: MLAConfig,
                    uniform_pos: bool = True) -> torch.Tensor:
    """Append x's latent to `cache` (in place) and attend against the whole
    cache by weight absorption; returns the output projection (B, Tq, dim),
    before the residual. `uniform_pos=True` promises uniform fill lengths
    (one slice write at sequence 0's length, read on the host)."""
    b, tq, dim = x.shape
    chunk_start = cache.length  # the fill before the append (append rebinds it)
    append_latent(cache, compress_kv(params, x),
                  pos=int(cache.length[0]) if uniform_pos else None)
    out = mla_absorbed_decode(_queries(params, x, cfg), cache.latent, params.w_k_up,
                              params.w_v_up, length=cache.length,
                              chunk_start=chunk_start if tq > 1 else None)
    out = out.transpose(1, 2).reshape(b, tq, dim).to(x.dtype)
    return torch.matmul(out, params.wo)


@torch.no_grad()
def decode_step(params: MLA, x: torch.Tensor, cache: LatentKVCache, cfg: MLAConfig,
                uniform_pos: bool = True):
    """Serving decode step over a LatentKVCache: compress the new tokens'
    latent, append it, attend against the latent cache by weight
    absorption. x: (B, Tq, dim). Returns (y, cache), the cache updated in
    place. A continuous-batching caller with ragged cache.length must pass
    uniform_pos=False; under UMFA_DEBUG=1 a broken promise NaN-poisons the
    written rows."""
    return x + absorbed_attend(params, x, cache, cfg, uniform_pos), cache
