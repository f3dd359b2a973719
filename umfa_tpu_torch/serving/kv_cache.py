"""KV caches for incremental decoding (port of umfa_tpu/serving/kv_cache.py).

A cache is a preallocated (B, Hkv, S_max, D) buffer plus per-sequence fill
lengths. The quantized variant stores INT8 rows + per-row FP32 scales,
quantized row-wise (symmetric) at append time. The MLA latent cache stores
the compressed (B, S_max, L) latent instead of K and V.

Unlike the JAX reference, `append`, `append_quantized` and `append_latent`
write the new rows INTO the cache's buffers in place and return the same
cache object with a new length tensor (the old one is not changed, so a
caller may keep it as the fill before the append); a caller that needs the
old contents must clone first.

Write positions follow `jax.lax.dynamic_update_slice`: a start that would
run past S_max is clamped to S_max - T (silently, as in the reference).
"""

from __future__ import annotations

import dataclasses
import os

import torch

from umfa_tpu_torch.utils.device import default_device


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor        # (B, Hkv, S_max, D)
    v: torch.Tensor        # (B, Hkv, S_max, D)
    length: torch.Tensor   # (B,) int32

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


@dataclasses.dataclass
class QuantizedKVCache:
    k_values: torch.Tensor   # (B, Hkv, S_max, D) int8
    k_scales: torch.Tensor   # (B, Hkv, S_max, 1) f32
    v_values: torch.Tensor
    v_scales: torch.Tensor
    length: torch.Tensor     # (B,) int32

    @property
    def max_len(self) -> int:
        return self.k_values.shape[2]


@dataclasses.dataclass
class LatentKVCache:
    """MLA latent cache: the compressed per-token latent instead of K and V.
    One (B, S_max, L) buffer replaces two (B, H, S_max, D) ones, and decode
    reads L values per token instead of 2·H·D."""

    latent: torch.Tensor   # (B, S_max, L)
    length: torch.Tensor   # (B,) int32

    @property
    def max_len(self) -> int:
        return self.latent.shape[1]


def init_cache(batch, num_kv_heads, max_len, head_dim, dtype=torch.bfloat16, *, device=None):
    device = default_device(device)
    return KVCache(
        k=torch.zeros((batch, num_kv_heads, max_len, head_dim), dtype=dtype, device=device),
        v=torch.zeros((batch, num_kv_heads, max_len, head_dim), dtype=dtype, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def init_quantized_cache(batch, num_kv_heads, max_len, head_dim, *, device=None):
    device = default_device(device)
    shape = (batch, num_kv_heads, max_len, head_dim)
    return QuantizedKVCache(
        k_values=torch.zeros(shape, dtype=torch.int8, device=device),
        k_scales=torch.ones(shape[:3] + (1,), dtype=torch.float32, device=device),
        v_values=torch.zeros(shape, dtype=torch.int8, device=device),
        v_scales=torch.ones(shape[:3] + (1,), dtype=torch.float32, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def _write_rows(buf, new, length, pos, dim=2):
    """Write `new` (B, Hkv, T, ...) into buf (B, Hkv, S_max, ...) in place,
    at each sequence's current length; `dim` is the time dim (1 for the
    latent cache's (B, S_max, L)).

    `pos` not None (an int) promises UNIFORM positions: one slice write at
    `pos`. Passing `pos` with ragged lengths writes every sequence's rows at
    `pos` and corrupts the cache; under UMFA_DEBUG=1 float buffers are
    NaN-poisoned when the promise is broken, so the corruption is loud.
    `pos=None` writes each sequence at its own length (ragged)."""
    t, s_max = new.shape[dim], buf.shape[dim]
    if pos is not None:
        if os.environ.get("UMFA_DEBUG") == "1" and buf.is_floating_point():
            uniform = torch.all(length == length[0])
            new = torch.where(uniform, new, torch.full_like(new, float("nan")))
        start = min(max(int(pos), 0), s_max - t)
        buf.narrow(dim, start, t).copy_(new.to(buf.dtype))
        return
    start = length.long().clamp(0, s_max - t)
    idx = start[:, None] + torch.arange(t, device=buf.device)  # (B, T)
    idx = idx.view(idx.shape[0], *([1] * (dim - 1)), t, *([1] * (buf.dim() - dim - 1)))
    buf.scatter_(dim, idx.expand(new.shape), new.to(buf.dtype))


def append(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor, pos=None) -> KVCache:
    """Append T new tokens per sequence (k_new/v_new: (B, Hkv, T, D)) in
    place. `pos` (an int) promises uniform positions (see _write_rows)."""
    t = k_new.shape[2]
    _write_rows(cache.k, k_new, cache.length, pos)
    _write_rows(cache.v, v_new, cache.length, pos)
    cache.length = cache.length + t
    return cache


def init_latent_cache(batch, max_len, latent_dim, dtype=torch.bfloat16, *, device=None):
    device = default_device(device)
    return LatentKVCache(
        latent=torch.zeros((batch, max_len, latent_dim), dtype=dtype, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def append_latent(cache: LatentKVCache, latent_new: torch.Tensor, pos=None) -> LatentKVCache:
    """Append T new latent rows per sequence (latent_new: (B, T, L)) in
    place. `pos` (an int) promises uniform positions (see _write_rows: one
    slice write, and the same UMFA_DEBUG=1 NaN poison of a broken promise)."""
    _write_rows(cache.latent, latent_new, cache.length, pos, dim=1)
    cache.length = cache.length + latent_new.shape[1]
    return cache


def _rowwise_quant(x: torch.Tensor):
    """(…, T, D) → int8 values + (…, T, 1) f32 scales (symmetric row-wise)."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -128, 127)
    return q.to(torch.int8), scale


def append_quantized(cache: QuantizedKVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                     pos=None) -> QuantizedKVCache:
    """Quantize new rows (row-wise symmetric INT8) and append them in
    place. `pos` (an int) promises uniform positions (see _write_rows)."""
    t = k_new.shape[2]
    kq, ks = _rowwise_quant(k_new)
    vq, vs = _rowwise_quant(v_new)
    ln = cache.length
    _write_rows(cache.k_values, kq, ln, pos)
    _write_rows(cache.k_scales, ks, ln, pos)
    _write_rows(cache.v_values, vq, ln, pos)
    _write_rows(cache.v_scales, vs, ln, pos)
    cache.length = ln + t
    return cache
