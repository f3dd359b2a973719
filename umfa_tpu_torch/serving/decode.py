"""Incremental decode attention over KV caches (port of
umfa_tpu/serving/decode.py).

Routes, as in the reference:
  * `prefill=True` / `chunk_start=c`: every sequence sat at cache row c
    before this append, so query i sees rows j <= c + i: causal for c = 0,
    else window (-1, c), through the fused kernel with no bias;
  * generic Tq > 16: a (B, 1, Tq, S_max) length-and-causal bias through the
    fused kernel, with the queries chunked when that bias would exceed
    `_BIAS_BUDGET_BYTES`;
  * Tq <= 16 (token-by-token decode at ragged lengths): with
    UMFA_ENABLE_DECODE_KERNEL=1 (read on every call), an INT8 cache and
    S_max divisible by the reference's block rule, the flash-decode kernel
    of `serving/decode_kernel.py`; otherwise `_gemv_decode`, plain matmuls
    (the reference's default, left to XLA there).
The dense cache uses `ops/flash_fwd.py`, the INT8 cache
`ops/quant_attention.py` on the cached INT8 rows (Q quantized row-wise).
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional, Union

import torch

from umfa_tpu_torch.engine.config import Precision, QuantMode, QuantStrategy
from umfa_tpu_torch.ops.attention import flash_attention
from umfa_tpu_torch.ops.quant import QuantizedTensor, quantize
from umfa_tpu_torch.ops.quant_attention import quantized_attention_forward
from umfa_tpu_torch.serving.decode_kernel import quantized_flash_decode
from umfa_tpu_torch.serving.kv_cache import KVCache, QuantizedKVCache

# Generic-Tq>16 intra-chunk bias budget: above it the call chunks Tq (with a
# one-time warning) instead of materializing the full (B, 1, Tq, S_max) f32
# bias. Module-level so tests can lower it.
_BIAS_BUDGET_BYTES = 64 * 2**20
_warned_bias_cliff = False


def _length_bias(length: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths → (B, 1, 1, max_len) additive bias masking the unfilled
    tail of the cache."""
    pos = torch.arange(max_len, device=length.device)[None, :]
    masked = pos >= length[:, None]
    bias = torch.where(masked, -1e30, 0.0).to(torch.float32)
    return bias[:, None, None, :]


def _quantized_operands(q: torch.Tensor, cache: QuantizedKVCache):
    b, _, _, d = q.shape
    shape_k = (b, cache.k_values.shape[1], cache.max_len, d)
    qt_q = quantize(q, Precision.INT8, QuantMode.ROW)

    def qt(values, scales):
        return QuantizedTensor(
            values=values, scales=scales, zero_points=None, row_sums=None,
            precision=Precision.INT8, mode=QuantMode.ROW,
            strategy=QuantStrategy.SYMMETRIC, block_size=64,
            orig_shape=shape_k, orig_dtype=q.dtype,
        )

    return qt_q, qt(cache.k_values, cache.k_scales), qt(cache.v_values, cache.v_scales)


def decode_attention(
    q: torch.Tensor,
    cache: Union[KVCache, QuantizedKVCache],
    *,
    scale: Optional[float] = None,
    prefill: bool = False,
    chunk_start: Optional[int] = None,
) -> torch.Tensor:
    """Attend new queries q (B, Hq, Tq, D) against a cache the Tq new
    tokens were already appended to: query t sees the cached tokens plus
    itself and earlier new tokens.

    `chunk_start` promises that every sequence sat at that cache row before
    the append (host-known, uniform positions): no bias is built.
    `prefill=True` is chunk_start=0."""
    batch, _, tq, _ = q.shape
    quantized = isinstance(cache, QuantizedKVCache)
    if prefill and chunk_start is None:
        chunk_start = 0
    if chunk_start is not None:
        causal = chunk_start == 0
        window = None if causal else (-1, int(chunk_start))
        if quantized:
            out, _ = quantized_attention_forward(
                *_quantized_operands(q, cache), causal=causal, window=window,
                scale=scale,
            )
            return out.to(q.dtype)
        return flash_attention(
            q, cache.k, cache.v, causal=causal, window=window, scale=scale
        ).to(q.dtype)
    bias = _length_bias(cache.length, cache.max_len)
    if tq > 16 and batch * tq * cache.max_len * 4 > _BIAS_BUDGET_BYTES:
        global _warned_bias_cliff
        if not _warned_bias_cliff:
            _warned_bias_cliff = True
            warnings.warn(
                f"decode_attention generic Tq={tq} path would materialize a "
                f"{batch * tq * cache.max_len * 4 / 2**20:.0f} MiB intra-"
                "chunk bias; chunking queries to stay under "
                f"{_BIAS_BUDGET_BYTES // 2**20} MiB — pass chunk_start= to "
                "avoid the bias entirely when positions are uniform",
                stacklevel=2,
            )
        tq_chunk = max(16, _BIAS_BUDGET_BYTES // (batch * cache.max_len * 4))
        outs = []
        for i0 in range(0, tq, tq_chunk):
            tc = min(tq_chunk, tq - i0)
            # Queries [i0, i0 + tc) sit at positions length - tq + i0 + t;
            # the recursive call's "new tokens" end tq - i0 - tc rows earlier.
            sub = dataclasses.replace(cache, length=cache.length - (tq - i0 - tc))
            outs.append(decode_attention(q[:, :, i0:i0 + tc], sub, scale=scale))
        return torch.cat(outs, dim=2)
    if tq > 1:
        # Query row i sits at position length - tq + i: it must not see
        # cache rows beyond it.
        pos = torch.arange(cache.max_len, device=q.device)[None, None, :]
        qpos = (cache.length[:, None] - tq
                + torch.arange(tq, device=q.device))[:, :, None]
        causal_mask = pos > qpos  # (B, Tq, S_max)
        bias = torch.where(causal_mask[:, None], -1e30, bias)
        bias = bias.expand(batch, 1, tq, cache.max_len)

    if tq <= 16:
        # The reference's route rule (umfa_tpu/serving/decode.py:163-186):
        # the flash-decode kernel is opt-in, and its block_k must divide
        # S_max (the largest power-of-two divisor <= 2048, not below 256).
        bk = 2048
        while bk >= 512 and cache.max_len % bk:
            bk //= 2
        if (quantized and cache.max_len % bk == 0
                and os.environ.get("UMFA_ENABLE_DECODE_KERNEL") == "1"):
            out = quantized_flash_decode(
                q, cache.k_values, cache.k_scales, cache.v_values, cache.v_scales, bias,
                scale=scale, block_k=min(bk, cache.max_len),
            )
            return out.to(q.dtype)
        return _gemv_decode(q, cache, bias, scale)

    if quantized:
        out, _ = quantized_attention_forward(*_quantized_operands(q, cache), bias, scale=scale)
        return out.to(q.dtype)
    return flash_attention(q, cache.k, cache.v, bias, scale=scale)


def _gemv_decode(q, cache, bias, scale):
    """Small-Tq decode with plain matmuls: scores materialize at
    (B, Hkv, g·Tq, S_max). GQA folds the group into the query rows; K/V stay
    in their storage dtype up to the matmul (bf16 operands, FP32
    accumulation; fp32 stays fp32). INT8 caches apply the K scales after
    the dot and fold the V scales into P."""
    b, hq, tq, d = q.shape
    if scale is None:
        scale = d**-0.5
    quantized = isinstance(cache, QuantizedKVCache)
    k = cache.k_values if quantized else cache.k
    v = cache.v_values if quantized else cache.v
    hkv = k.shape[1]
    g = hq // hkv
    qg = q.reshape(b, hkv, g * tq, d)
    cdt = torch.float32 if q.dtype == torch.float32 else torch.bfloat16
    # Operands rounded to cdt, products and sums in fp32 (exact products of
    # bf16 values, as the reference's bf16 matmul with fp32 accumulation).
    s = torch.matmul(qg.to(cdt).float(), k.to(cdt).float().transpose(-1, -2))
    if quantized:
        s = s * cache.k_scales[..., 0].float()[:, :, None, :]
    # Bias rows depend on (b, t): tile over the g query groups (row-major
    # (g, t) flatten).
    bias = bias.float()
    if g > 1 and bias.shape[2] > 1:
        bias = bias.repeat(1, 1, g, 1)
    s = s * scale + bias
    p = torch.softmax(s, dim=-1)
    if quantized:
        p = p * cache.v_scales[..., 0].float()[:, :, None, :]
    out = torch.matmul(p.to(cdt).float(), v.to(cdt).float())
    return out.reshape(b, hq, tq, d).to(q.dtype)
