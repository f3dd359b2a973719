"""Decoder-only causal LM (GPT-style) for serving (port of
umfa_tpu/models/gpt.py).

Pre-LN transformer with interleaved RoPE and GQA. Parameters keep the JAX
layouts (wq (dim, H, D), wkv (dim, 2, Hkv, D), wo (H, D, dim), w1, w2,
embed, unembed) so `params_from_jax` carries a JAX checkpoint over as is.
Inference only: parameters do not require grad and every entry point runs
under `torch.no_grad()`. Caches are updated in place (serving/kv_cache.py).

Numerics held to the reference: LayerNorm without affine, eps 1e-6,
population variance, in fp32 and cast back; GELU with the tanh
approximation (jax.nn.gelu's default); RoPE tables from the absolute
positions, (T, D/2) for uniform positions and (B, 1, T, D/2) for ragged
ones.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from umfa_tpu_torch.engine.config import QuantizationConfig
from umfa_tpu_torch.ops.attention import flash_attention
from umfa_tpu_torch.ops.rope import apply_rope
from umfa_tpu_torch.serving.decode import decode_attention
from umfa_tpu_torch.serving.kv_cache import (
    append,
    append_quantized,
    init_cache,
    init_quantized_cache,
)
from umfa_tpu_torch.utils.device import default_device


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab: int = 256
    dim: int = 256
    num_heads: int = 4
    num_kv_heads: int = 2
    depth: int = 2
    mlp_ratio: int = 4
    max_seq: int = 512
    rope_base: float = 10000.0
    dtype: str = "float32"
    quantization: Optional[QuantizationConfig] = None
    # KV cache storage: "dtype" (the model dtype) or "int8" (row-wise
    # symmetric INT8 + per-row scales).
    kv_cache: str = "dtype"

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    def __init__(self, wq, wkv, wo, w1, w2):
        super().__init__()
        self.wq, self.wkv, self.wo = _param(wq), _param(wkv), _param(wo)
        self.w1, self.w2 = _param(w1), _param(w2)


class GPT(nn.Module):
    """Parameters in the JAX layouts; `forward(tokens)` is the full-sequence
    inference forward (tokens (B, S) → logits (B, S, vocab))."""

    def __init__(self, cfg: GPTConfig, embed, unembed, blocks):
        super().__init__()
        self.cfg = cfg
        self.embed = _param(embed)
        self.unembed = _param(unembed)
        self.blocks = nn.ModuleList(Block(**b) for b in blocks)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.quantization is not None:
            raise NotImplementedError(
                "GPT.forward with cfg.quantization needs the fused "
                "quantize-attend kernel, which is not ported yet"
            )
        _, s = tokens.shape
        x = self.embed[tokens]
        positions = torch.arange(s, device=x.device)
        for block in self.blocks:
            q, k, v = _qkv(block, x, cfg, positions)
            attn = flash_attention(q, k, v, causal=True)
            x = _block_tail(block, x, attn)
        return torch.einsum("bsd,dv->bsv", _ln(x), self.unembed)


def init_params(cfg: GPTConfig, generator: Optional[torch.Generator] = None,
                device=None) -> GPT:
    """Random weights with the reference's scales (N(0,1)·dim^-0.5, w2 by
    hidden^-0.5). Drawn in fp32 on the CPU from `generator`, so a seed gives
    the same weights on every device; the numbers differ from jax.random."""
    device = default_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    s = cfg.dim**-0.5
    hidden = cfg.dim * cfg.mlp_ratio

    def normal(shape, std):
        return (torch.randn(shape, generator=g) * std).to(device=device, dtype=cfg.tdtype)

    embed = normal((cfg.vocab, cfg.dim), s)
    unembed = normal((cfg.dim, cfg.vocab), s)
    blocks = [
        dict(
            wq=normal((cfg.dim, cfg.num_heads, cfg.head_dim), s),
            wkv=normal((cfg.dim, 2, cfg.num_kv_heads, cfg.head_dim), s),
            wo=normal((cfg.num_heads, cfg.head_dim, cfg.dim), s),
            w1=normal((cfg.dim, hidden), s),
            w2=normal((hidden, cfg.dim), hidden**-0.5),
        )
        for _ in range(cfg.depth)
    ]
    return GPT(cfg, embed, unembed, blocks)


def params_from_jax(params_np: dict, cfg: GPTConfig, device=None) -> GPT:
    """Carry JAX parameters (the nested dict after
    `jax.tree_util.tree_map(np.asarray, params)`) into the port, in the
    config's dtype."""
    device = default_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device=device, dtype=cfg.tdtype)

    blocks = [{name: t(b[name]) for name in ("wq", "wkv", "wo", "w1", "w2")}
              for b in params_np["blocks"]]
    return GPT(cfg, t(params_np["embed"]), t(params_np["unembed"]), blocks)


def _ln(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def _rope_tables(positions: torch.Tensor, head_dim: int, base: float):
    """positions (T,) → tables (T, D/2); positions (B, T) (ragged decode)
    → tables (B, 1, T, D/2) broadcasting over heads."""
    inv_freq = 1.0 / (
        base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                              device=positions.device) / head_dim)
    )
    freqs = positions.float()[..., None] * inv_freq
    if freqs.dim() == 3:
        freqs = freqs[:, None]
    return torch.cos(freqs), torch.sin(freqs)


def _qkv(block: Block, x, cfg: GPTConfig, positions):
    h = _ln(x)
    q = torch.einsum("bsd,dhe->bhse", h, block.wq)
    kv = torch.einsum("bsd,dthe->btshe", h, block.wkv)
    k, v = kv[:, 0].transpose(1, 2), kv[:, 1].transpose(1, 2).contiguous()
    cos, sin = _rope_tables(positions, cfg.head_dim, cfg.rope_base)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _block_tail(block: Block, x, attn):
    x = x + torch.einsum("bhse,hed->bsd", attn.to(x.dtype), block.wo)
    h = torch.einsum("bsd,dk->bsk", _ln(x), block.w1)
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return x + torch.einsum("bsk,kd->bsd", h, block.w2)


def init_caches(cfg: GPTConfig, batch: int, device=None) -> list:
    device = default_device(device)
    if cfg.kv_cache == "int8":
        return [init_quantized_cache(batch, cfg.num_kv_heads, cfg.max_seq,
                                     cfg.head_dim, device=device)
                for _ in range(cfg.depth)]
    return [init_cache(batch, cfg.num_kv_heads, cfg.max_seq, cfg.head_dim,
                       cfg.tdtype, device=device)
            for _ in range(cfg.depth)]


@torch.no_grad()
def forward_with_cache(
    model: GPT,
    tokens: torch.Tensor,
    caches: list,
    prefill: bool = False,
    chunk_start: Optional[int] = None,
    uniform_pos: bool = True,
) -> Tuple[torch.Tensor, list]:
    """Append `tokens` (B, T) at each sequence's cache position (in place);
    returns (logits (B, T, vocab), caches).

    `prefill=True`: the caches were empty before this call (plain causal
    kernel, no bias). `chunk_start=c`: every sequence sat at row c (window
    kernel, no bias). `uniform_pos=True` PROMISES uniform fill lengths
    across the batch: one slice write per buffer, RoPE positions from
    sequence 0's length (read once on the host). Ragged callers must pass
    uniform_pos=False; UMFA_DEBUG=1 NaN-poisons a broken promise."""
    cfg = model.cfg
    _, t = tokens.shape
    x = model.embed[tokens]
    steps = torch.arange(t, device=x.device)
    if uniform_pos:
        start = int(caches[0].length[0])
        positions = start + steps                       # (T,) shared
        pos_arg = start
    else:
        positions = caches[0].length[:, None] + steps   # (B, T)
        pos_arg = None
    for block, cache in zip(model.blocks, caches):
        q, k, v = _qkv(block, x, cfg, positions)
        if cfg.kv_cache == "int8":
            append_quantized(cache, k, v, pos=pos_arg)
        else:
            append(cache, k, v, pos=pos_arg)
        attn = decode_attention(q, cache, prefill=prefill, chunk_start=chunk_start)
        x = _block_tail(block, x, attn)
    return torch.einsum("bsd,dv->bsv", _ln(x), model.unembed), caches


@torch.no_grad()
def generate(model: GPT, prompt: torch.Tensor, steps: int) -> torch.Tensor:
    """Greedy generation with KV caches. prompt: (B, S0) → (B, S0 + steps)."""
    caches = init_caches(model.cfg, prompt.shape[0], device=model.embed.device)
    logits, caches = forward_with_cache(model, prompt, caches, prefill=True)
    tokens = prompt
    next_tok = torch.argmax(logits[:, -1:], dim=-1)
    for _ in range(steps):
        tokens = torch.cat([tokens, next_tok], dim=1)
        logits, caches = forward_with_cache(model, next_tok, caches)
        next_tok = torch.argmax(logits[:, -1:], dim=-1)
    return tokens
