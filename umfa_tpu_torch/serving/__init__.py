"""Serving subsystem (port of umfa_tpu/serving): KV caches (dense and
INT8), incremental decode attention with the opt-in flash-decode kernel,
and the continuous-batching scheduler (`serving.scheduler`). The latent
(MLA) cache is not ported yet."""

from umfa_tpu_torch.serving.decode import decode_attention
from umfa_tpu_torch.serving.kv_cache import (
    KVCache,
    QuantizedKVCache,
    init_cache,
    init_quantized_cache,
)

__all__ = [
    "KVCache",
    "QuantizedKVCache",
    "init_cache",
    "init_quantized_cache",
    "decode_attention",
]
