"""PyTorch / CUDA port of umfa_tpu for NVIDIA Hopper (H100).

The JAX package `umfa_tpu` stays the reference; this package mirrors its
layout module by module and imports nothing of it (nor JAX). Kernels are
hand-written CUDA C++ under `csrc/`, built with nvcc at first use
(`_kernels.py`); every kernel wrapper runs its plain PyTorch version when the
tensors it is given lie on the CPU.

Ported so far: the serving path of the GPT model (`models/gpt.py`) with the
dense and the INT8 KV cache, through `ops/flash_fwd.py` and
`ops/quant_attention.py`; the dense training path: the public
`attention()` (`api.py`) and `flash_attention` (`ops/attention.py`) with
gradients through `ops/flash_bwd.py`, and `GPT.forward` under autograd; the
quantized training path: `attention()` under an INT8/INT4 quantization
mode and `quantized_flash_attention` (`ops/quant_attention.py`) with STE
gradients, through `ops/quant_fused_attn.py`, `ops/quant_bwd.py` and
`ops/quant_fused.py`, and `GPT.forward` with `cfg.quantization`;
continuous-batching decode: the scheduler (`serving/scheduler.py`) and,
with UMFA_ENABLE_DECODE_KERNEL=1 and the INT8 cache, the flash-decode
kernel of `serving/decode_kernel.py` at Tq <= 16; ring attention
(`parallel/`): `ring_flash_attention_pallas` forward and backward through
the ring kernels, and `ring_flash_attention`, over a `LocalRing` of
virtual ranks on one card or a `DistRing` of processes; and the
tensor-core probe `utils/mma_probe.py`; block-sparse masks
(`ops/block_mask.py`: a BlockMask or a mask_mod through `attention()` and
`flash_attention`, forward and backward walking the map's tiles);
`rope_attention` (`ops/rope.py`: rotate-half RoPE inside the forward
kernel); the FLUX-shaped DiT (`models/dit.py`, dense or quantized,
forward and training); MLA (`ops/mla.py`, the latent cache, and
`models/mla_model.py`), the MoE FFN (`models/moe.py`) and the
DeepSeek-style model (`models/deepseek.py`: forward through `flash_fwd`,
latent-cache decode and generation), and the quantized-weight GEMMs of
`ops/gemm.py`.

    import umfa_tpu_torch
    out = umfa_tpu_torch.attention(q, k, v, is_causal=True)
    out.sum().backward()
    with umfa_tpu_torch.use_quantization("int8"):
        umfa_tpu_torch.attention(q, k, v, is_causal=True).sum().backward()
    from umfa_tpu_torch.parallel import LocalRing, ring_flash_attention_pallas
    ring_flash_attention_pallas(q, k, v, ring=LocalRing(4), causal=True).sum().backward()
    docs = umfa_tpu_torch.segment_block_mask(segment_ids, causal=True, device="cuda")
    umfa_tpu_torch.attention(q, k, v, docs).sum().backward()
    umfa_tpu_torch.rope_attention(q, k, v, interleaved=False, causal=True).sum().backward()
    from umfa_tpu_torch.models import deepseek
    cfg = deepseek.DeepSeekConfig()
    model = deepseek.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = deepseek.generate(model, prompt, cfg, max_new_tokens=32)
"""

from umfa_tpu_torch.api import (
    attention,
    attention_with_lse,
    clear_quantization_mode,
    get_quantization_mode,
    set_quantization_mode,
    use_quantization,
)
from umfa_tpu_torch.engine.config import (
    BlockSizeConfig,
    Precision,
    QuantizationConfig,
    QuantMode,
    QuantStrategy,
)
from umfa_tpu_torch.engine.stats import get_dispatch_stats, reset_dispatch_stats
from umfa_tpu_torch.ops.attention import flash_attention
from umfa_tpu_torch.ops.block_mask import (
    BlockMask,
    causal_block_mask,
    make_block_mask,
    segment_block_mask,
    sliding_window_block_mask,
)
from umfa_tpu_torch.ops.gemm import quantize_weight, quantized_matmul
from umfa_tpu_torch.ops.hadamard import hadamard_rotate
from umfa_tpu_torch.ops.mla import mla_absorbed_decode, mla_decompress, sparse_indexer_scores
from umfa_tpu_torch.ops.quant import QuantizedTensor, dequantize, quantize
from umfa_tpu_torch.ops.quant_attention import quantized_flash_attention
from umfa_tpu_torch.ops.rope import apply_rope, rope_attention

__all__ = [
    "attention",
    "attention_with_lse",
    "flash_attention",
    "quantized_flash_attention",
    "hadamard_rotate",
    "set_quantization_mode",
    "get_quantization_mode",
    "clear_quantization_mode",
    "use_quantization",
    "QuantizationConfig",
    "BlockSizeConfig",
    "Precision",
    "QuantMode",
    "QuantStrategy",
    "get_dispatch_stats",
    "reset_dispatch_stats",
    "quantize",
    "dequantize",
    "QuantizedTensor",
    "BlockMask",
    "make_block_mask",
    "causal_block_mask",
    "sliding_window_block_mask",
    "segment_block_mask",
    "apply_rope",
    "rope_attention",
    "quantize_weight",
    "quantized_matmul",
    "mla_absorbed_decode",
    "mla_decompress",
    "sparse_indexer_scores",
]
