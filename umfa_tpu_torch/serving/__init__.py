"""Serving subsystem (port of umfa_tpu/serving): KV caches (dense, INT8
and the MLA latent cache), incremental decode attention with the opt-in
flash-decode kernel, and the continuous-batching scheduler
(`serving.scheduler`)."""

from umfa_tpu_torch.serving.decode import decode_attention
from umfa_tpu_torch.serving.kv_cache import (
    KVCache,
    LatentKVCache,
    QuantizedKVCache,
    append_latent,
    init_cache,
    init_latent_cache,
    init_quantized_cache,
)

__all__ = [
    "KVCache",
    "LatentKVCache",
    "QuantizedKVCache",
    "append_latent",
    "init_cache",
    "init_latent_cache",
    "init_quantized_cache",
    "decode_attention",
]
