"""DeepSeek-V3.2-style model: MLA attention + MoE FFN + generation (port of
umfa_tpu/models/deepseek.py).

Pre-RMSNorm blocks of MLA attention (`models/mla_model.py`, its fused
attention the `flash_fwd` kernel, once a layer) and the MoE FFN
(`models/moe.py`), tied input and output embeddings. Serving appends to
one LatentKVCache per layer, in place, and attends in latent space by
weight absorption (`mla_absorbed_decode`): `decode_step` and `generate`
launch no kernel. `generate` prefills the prompt as one chunked decode
step, then decodes token by token, greedy or sampled from a caller's
`torch.Generator` (on the logits' device); only greedy tokens can match
the reference's, whose sampler is jax.random.

Parameters keep the JAX nesting and names (embed, lnf, layers[i].attn,
.ffn, .ln1, .ln2); the RMS gains and the router stay fp32 in a bf16 model,
as the reference keeps them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from umfa_tpu_torch.models import mla_model, moe
from umfa_tpu_torch.serving.kv_cache import init_latent_cache
from umfa_tpu_torch.utils.device import default_device


@dataclasses.dataclass(frozen=True)
class DeepSeekConfig:
    vocab: int = 256
    dim: int = 256
    num_heads: int = 4
    latent_dim: int = 32
    depth: int = 2
    num_experts: int = 8
    top_k: int = 2
    n_shared: int = 1
    moe_hidden: int = 512
    indexer_topk: Optional[int] = None
    dtype: str = "bfloat16"

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def mla(self) -> mla_model.MLAConfig:
        return mla_model.MLAConfig(dim=self.dim, num_heads=self.num_heads,
                                   latent_dim=self.latent_dim, causal=True, dtype=self.dtype,
                                   indexer_topk=self.indexer_topk)

    def moe(self) -> moe.MoEConfig:
        return moe.MoEConfig(dim=self.dim, hidden=self.moe_hidden,
                             num_experts=self.num_experts, top_k=self.top_k,
                             n_shared=self.n_shared, dtype=self.dtype)


class Layer(nn.Module):
    def __init__(self, attn: mla_model.MLA, ffn: moe.MoE, ln1, ln2):
        super().__init__()
        self.attn, self.ffn = attn, ffn
        self.ln1, self.ln2 = nn.Parameter(ln1), nn.Parameter(ln2)


class DeepSeek(nn.Module):
    """`forward(tokens)` is the module-level `forward` with this config:
    tokens (B, S) → (logits (B, S, vocab) fp32, total aux loss)."""

    def __init__(self, cfg: DeepSeekConfig, embed, lnf, layers):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(embed)
        self.lnf = nn.Parameter(lnf)
        self.layers = nn.ModuleList(layers)

    def forward(self, tokens: torch.Tensor):
        return forward(self, tokens, self.cfg)


def init_params(cfg: DeepSeekConfig, generator: Optional[torch.Generator] = None,
                device=None) -> DeepSeek:
    """Random weights with the reference's scales (embed N(0,1)·0.02, the
    layers' as `mla_model.init_params` and `moe.init_params`, gains 1),
    drawn in fp32 on the CPU from `generator`; the numbers differ from
    jax.random."""
    device = default_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)

    def ones():
        return torch.ones((cfg.dim,), dtype=torch.float32, device=device)

    layers = [Layer(mla_model.init_params(cfg.mla(), g, device),
                    moe.init_params(cfg.moe(), g, device), ones(), ones())
              for _ in range(cfg.depth)]
    embed = (torch.randn((cfg.vocab, cfg.dim), generator=g) * 0.02).to(device=device,
                                                                      dtype=cfg.tdtype)
    return DeepSeek(cfg, embed, ones(), layers)


def params_from_jax(params_np: dict, cfg: DeepSeekConfig, device=None) -> DeepSeek:
    """Carry JAX parameters (the nested dict after `jax.tree_util.tree_map(
    np.asarray, params)`) into the port: the embedding and the MLA and
    expert weights in the config's dtype, the router and the gains fp32."""
    device = default_device(device)

    def gain(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    layers = [Layer(mla_model.params_from_jax(lp["attn"], cfg.mla(), device),
                    moe.params_from_jax(lp["ffn"], cfg.moe(), device),
                    gain(lp["ln1"]), gain(lp["ln2"]))
              for lp in params_np["layers"]]
    embed = gain(params_np["embed"]).to(cfg.tdtype)
    return DeepSeek(cfg, embed, gain(params_np["lnf"]), layers)


def _rms(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
    return (y * g).to(x.dtype)


def _logits(params: DeepSeek, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(_rms(x, params.lnf).float(), params.embed.float().T)


def forward(params: DeepSeek, tokens: torch.Tensor,
            cfg: DeepSeekConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) int → (logits (B, S, vocab) fp32, total aux loss)."""
    x = params.embed[tokens]
    mcfg, ecfg = cfg.mla(), cfg.moe()
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in params.layers:
        h = _rms(x, layer.ln1)
        x = x + mla_model.attend(layer.attn, h, mla_model.compress_kv(layer.attn, h), mcfg)
        y, aux = moe.moe_ffn(layer.ffn, _rms(x, layer.ln2), ecfg)
        x = x + y
        aux_total = aux_total + aux
    return _logits(params, x), aux_total


def init_caches(cfg: DeepSeekConfig, batch: int, max_len: int, device=None) -> list:
    device = default_device(device)
    return [init_latent_cache(batch, max_len, cfg.latent_dim, cfg.tdtype, device=device)
            for _ in range(cfg.depth)]


@torch.no_grad()
def decode_step(params: DeepSeek, tokens: torch.Tensor, caches: list, cfg: DeepSeekConfig,
                uniform_pos: bool = True) -> Tuple[torch.Tensor, list]:
    """tokens: (B, Tq) → (logits of the last position (B, vocab) fp32,
    caches), the caches updated in place. Attention decodes in latent space
    (`mla_model.absorbed_attend`); the FFN is the same MoE as `forward`.
    `uniform_pos=True` promises uniform fill lengths across the batch;
    continuous-batching callers with ragged cache.length must pass
    uniform_pos=False. UMFA_DEBUG=1 NaN-poisons a broken promise."""
    x = params.embed[tokens]
    mcfg, ecfg = cfg.mla(), cfg.moe()
    for layer, cache in zip(params.layers, caches):
        x = x + mla_model.absorbed_attend(layer.attn, _rms(x, layer.ln1), cache, mcfg,
                                          uniform_pos)
        y, _ = moe.moe_ffn(layer.ffn, _rms(x, layer.ln2), ecfg)
        x = x + y
    return _logits(params, x[:, -1]), caches


@torch.no_grad()
def generate(params: DeepSeek, prompt: torch.Tensor, cfg: DeepSeekConfig, *,
             max_new_tokens: int, max_len: Optional[int] = None, greedy: bool = True,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Prefill the prompt (one chunked decode step), then generate token by
    token against the latent caches. prompt: (B, S0) → (B, max_new_tokens)
    int64. Greedy (argmax), or sampled from softmax(logits) with
    `generator` (a generator on the prompt's device; default seed 0)."""
    b, s0 = prompt.shape
    caches = init_caches(cfg, b, max_len or (s0 + max_new_tokens), device=prompt.device)
    if not greedy and generator is None:
        generator = torch.Generator(device=prompt.device).manual_seed(0)

    def pick(logits):
        if greedy:
            return torch.argmax(logits, dim=-1)
        return torch.multinomial(torch.softmax(logits, dim=-1), 1, generator=generator)[:, 0]

    logits, caches = decode_step(params, prompt, caches, cfg)
    out = [pick(logits)]
    for _ in range(max_new_tokens - 1):
        logits, caches = decode_step(params, out[-1][:, None], caches, cfg)
        out.append(pick(logits))
    return torch.stack(out, dim=1)
