"""MLA (Multi-head Latent Attention) ops (port of umfa_tpu/ops/mla.py).

The decompression GEMMs `K = latent @ W_k`, `V = latent @ W_v`, the sparse
indexer's relu(Q·Kᵀ) scores and the weight-absorbed decode are plain
products, as in the reference (they reach no Pallas kernel there);
`mla_attention` runs the fused attention of `ops/attention.py` on the
decompressed K and V.

Where the reference asks for an fp32 result (`preferred_element_type`),
the products here take fp32 copies of the operands: a bf16 value is exact
in fp32 (and in TF32), so each product is exact and only the fp32 sum
rounds, once, where the reference rounds.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from umfa_tpu_torch.ops.attention import flash_attention
from umfa_tpu_torch.ops.flash_fwd import DEFAULT_MASK_VALUE


def _f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with fp32 operands and an fp32 result."""
    return torch.einsum(eq, a.float(), b.float())


def mla_decompress(
    latent: torch.Tensor,
    w_k: torch.Tensor,
    w_v: torch.Tensor,
    *,
    num_heads: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decompress latent KV into full K, V. latent: (B, S, L); w_k, w_v:
    (L, H*D). Returns (k, v) of shape (B, H, S, D) if num_heads is given,
    else (B, S, H*D), in latent's dtype; fp32 accumulation."""
    k = _f32("bsl,lf->bsf", latent, w_k).to(latent.dtype)
    v = _f32("bsl,lf->bsf", latent, w_v).to(latent.dtype)
    if num_heads is not None:
        b, s, f = k.shape
        d = f // num_heads
        k = k.reshape(b, s, num_heads, d).transpose(1, 2)
        v = v.reshape(b, s, num_heads, d).transpose(1, 2)
    return k, v


def sparse_indexer_scores(q: torch.Tensor, k: torch.Tensor, *,
                          scale: Optional[float] = None) -> torch.Tensor:
    """relu(Q @ Kᵀ * scale), the DeepSeek sparse-attention indexer score.
    q: (..., Sq, D), k: (..., Sk, D) → (..., Sq, Sk) fp32."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return torch.relu(_f32("...qd,...kd->...qk", q, k) * scale)


def mla_absorbed_decode(
    q: torch.Tensor,
    latent: torch.Tensor,
    w_k_up: torch.Tensor,
    w_v_up: torch.Tensor,
    *,
    length: Optional[torch.Tensor] = None,
    chunk_start: Optional[Union[int, torch.Tensor]] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention directly against the latent cache by weight
    absorption: Q·Kᵀ = (Q·W_kᵀ)·latentᵀ and P·V = (P·latent)·W_v, so the
    cache read is the (B, S, L) latent, not 2·H·D per token.

    q: (B, H, Tq, D) new-token queries; latent: (B, S_max, L); w_k_up,
    w_v_up: (L, H*D). length: (B,) cache fill after the append that wrote
    these Tq tokens (rows past it are masked). chunk_start: (B,) or scalar
    fill before that append: query i sees rows j <= chunk_start + i (Tq > 1).

    Rounding as the reference (ops/mla.py:110-148): fp32 inputs stay fp32;
    otherwise the operands are bf16, q_lat and o_lat are rounded to bf16
    once each, the scores and the softmax stay fp32, and the output is
    rounded to q's dtype."""
    b, h, tq, d = q.shape
    lat = w_k_up.shape[0]
    if scale is None:
        scale = d**-0.5
    cdt = torch.float32 if q.dtype == torch.float32 else torch.bfloat16
    wk = w_k_up.reshape(lat, h, d).to(cdt)
    wv = w_v_up.reshape(lat, h, d).to(cdt)
    lat_c = latent.to(cdt)
    q_lat = _f32("bhtd,lhd->bhtl", q.to(cdt), wk).to(cdt)
    s = _f32("bhtl,bsl->bhts", q_lat, lat_c) * scale
    s_max = latent.shape[1]
    pos = torch.arange(s_max, device=q.device)
    if length is not None:
        dead = pos[None, :] >= length.to(q.device)[:, None]          # (B, S_max)
        s = s.masked_fill(dead[:, None, None, :], DEFAULT_MASK_VALUE)
    if chunk_start is not None and tq > 1:
        start = torch.as_tensor(chunk_start, device=q.device).expand(b)
        qpos = start[:, None] + torch.arange(tq, device=q.device)   # (B, Tq)
        future = pos[None, None, :] > qpos[..., None]                # (B, Tq, S_max)
        s = s.masked_fill(future[:, None], DEFAULT_MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    o_lat = _f32("bhts,bsl->bhtl", p.to(cdt), lat_c).to(cdt)
    return _f32("bhtl,lhd->bhtd", o_lat, wv).to(q.dtype)


def mla_attention(q: torch.Tensor, latent: torch.Tensor, w_k: torch.Tensor,
                  w_v: torch.Tensor, **attention_kwargs) -> torch.Tensor:
    """Latent-KV attention: decompress K and V (q's head count), then
    `flash_attention` (ops/attention.py) with `attention_kwargs`."""
    k, v = mla_decompress(latent, w_k, w_v, num_heads=q.shape[1])
    return flash_attention(q, k.contiguous(), v.contiguous(), **attention_kwargs)
