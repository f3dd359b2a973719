"""KV caches for incremental decoding (port of umfa_tpu/serving/kv_cache.py).

A cache is a preallocated (B, Hkv, S_max, D) buffer plus per-sequence fill
lengths. The quantized variant stores INT8 rows + per-row FP32 scales,
quantized row-wise (symmetric) at append time.

Unlike the JAX reference, `append` and `append_quantized` write the new rows
INTO the cache's buffers in place and return the same cache object with its
length advanced; a caller that needs the old contents must clone first.

Write positions follow `jax.lax.dynamic_update_slice`: a start that would
run past S_max is clamped to S_max - T (silently, as in the reference).
The latent (MLA) cache is not ported yet.
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


def _write_rows(buf, new, length, pos):
    """Write `new` (B, Hkv, T, ...) into buf (B, Hkv, S_max, ...) in place,
    at each sequence's current length.

    `pos` not None (an int) promises UNIFORM positions: one slice write at
    `pos`. Passing `pos` with ragged lengths writes every sequence's rows at
    `pos` and corrupts the cache; under UMFA_DEBUG=1 float buffers are
    NaN-poisoned when the promise is broken, so the corruption is loud.
    `pos=None` writes each sequence at its own length (ragged)."""
    t, s_max = new.shape[2], buf.shape[2]
    if pos is not None:
        if os.environ.get("UMFA_DEBUG") == "1" and buf.is_floating_point():
            uniform = torch.all(length == length[0])
            new = torch.where(uniform, new, torch.full_like(new, float("nan")))
        start = min(max(int(pos), 0), s_max - t)
        buf[:, :, start:start + t] = new.to(buf.dtype)
        return
    start = length.long().clamp(0, s_max - t)
    idx = start[:, None] + torch.arange(t, device=buf.device)  # (B, T)
    idx = idx[:, None, :, None].expand(buf.shape[0], buf.shape[1], t, buf.shape[3])
    buf.scatter_(2, idx, new.to(buf.dtype))


def append(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor, pos=None) -> KVCache:
    """Append T new tokens per sequence (k_new/v_new: (B, Hkv, T, D)) in
    place. `pos` (an int) promises uniform positions (see _write_rows)."""
    t = k_new.shape[2]
    _write_rows(cache.k, k_new, cache.length, pos)
    _write_rows(cache.v, v_new, cache.length, pos)
    cache.length = cache.length + t
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
