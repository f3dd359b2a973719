"""Attention descriptors and the capability probe (port of
umfa_tpu/engine/descriptor.py).

  * `AttentionDescriptor`: a frozen, hashable dataclass of the static
    attention configuration (shape, sparsity pattern, softmax scale,
    precisions, quantization, tile requests); calling it runs the port's
    `attention()` with that configuration. The reference uses it as the jit
    cache key; the port's kernels are compiled per library, not per call,
    so here it is the configuration alone.
  * `MultiHeadShape`: (batch, heads, sequence, head_dim).
  * `get_quantized_capabilities()`: what the port runs, under the
    reference's keys.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import torch

from umfa_tpu_torch.engine.config import Precision, QuantizationConfig
from umfa_tpu_torch.ops.flash_fwd import BlockSizes


class SparsityPattern(enum.Enum):
    """Reference: AttentionDescriptor.sparsityPattern (none, causal, and a
    sliding window)."""

    NONE = "none"
    CAUSAL = "causal"
    SLIDING_WINDOW = "sliding_window"


@dataclasses.dataclass(frozen=True)
class MultiHeadShape:
    """(batchSize, numHeads, sequenceLength, headDimension)."""

    batch_size: int
    num_heads: int
    seq_len: int
    head_dim: int

    @property
    def bhsd(self) -> Tuple[int, int, int, int]:
        return (self.batch_size, self.num_heads, self.seq_len, self.head_dim)


@dataclasses.dataclass(frozen=True)
class AttentionDescriptor:
    """Static attention configuration. Hashable: equal descriptors hash
    alike. `block_sizes` are the port's tile requests (ops/flash_fwd.py
    `BlockSizes`): the kernels pick their own tiles, and a mask_mod passed
    to the call is compiled into a BlockMask with these tiles, as the
    reference's `attention(block_sizes=...)` compiles it."""

    shape: MultiHeadShape
    kv_seq_len: Optional[int] = None
    num_kv_heads: Optional[int] = None
    sparsity: SparsityPattern = SparsityPattern.NONE
    window: Optional[Tuple[int, int]] = None
    softmax_scale: Optional[float] = None
    input_precision: Precision = Precision.BF16
    low_precision_intermediates: bool = False  # FP32 intermediates mandatory
    quantization: Optional[QuantizationConfig] = None
    block_sizes: BlockSizes = BlockSizes()

    def __post_init__(self):
        if self.low_precision_intermediates:
            raise ValueError("FP32 intermediates are mandatory (reference README.md:83-85)")
        if self.sparsity == SparsityPattern.SLIDING_WINDOW and self.window is None:
            raise ValueError("sliding_window sparsity requires window=(l, r)")

    @property
    def causal(self) -> bool:
        return self.sparsity == SparsityPattern.CAUSAL

    @property
    def tdtype(self) -> torch.dtype:
        return {
            Precision.FP16: torch.float16,
            Precision.BF16: torch.bfloat16,
            Precision.FP32: torch.float32,
        }[self.input_precision]

    def __call__(self, q, k, v, bias=None, **overrides):
        """Run the port's `attention()` with this descriptor's configuration;
        keyword `overrides` replace its arguments. A mask_mod `bias` is
        compiled on q's device with this descriptor's block sizes."""
        from umfa_tpu_torch.api import attention
        from umfa_tpu_torch.ops.block_mask import make_block_mask

        if callable(bias):
            bias = make_block_mask(bias, q.shape[-2], k.shape[-2], head_dim=q.shape[-1],
                                   block_sizes=self.block_sizes, device=q.device)
        kwargs = dict(is_causal=self.causal, window=self.window, scale=self.softmax_scale,
                      quantization=self.quantization)
        kwargs.update(overrides)
        return attention(q, k, v, bias, **kwargs)


def get_quantized_capabilities() -> dict:
    """The reference's capability probe, each value true of the port: the
    quantized forward and STE backward run per head and with BLOCK scales
    (rows 5, 7, 8, 9), INT8 and INT4, ASYMMETRIC zero points, the Hadamard
    rotation, GQA, a sliding window, ring attention (parallel/), bf16
    inputs natively; grids take 128 heads and more, and the kernels head
    dims and quantization blocks up to 256."""
    return {
        "multi_head_forward": True,
        "multi_head_backward": True,
        "blockwise_forward": True,
        "blockwise_backward": True,
        "int8": True,
        "int4": True,
        "asymmetric": True,
        "hadamard": True,
        "gqa": True,
        "sliding_window": True,
        "ring_attention": True,
        "max_heads": 128,
        "max_block_size": 256,
        "native_bfloat": True,
    }
