"""Configuration objects and env flags (copy of umfa_tpu/engine/config.py,
without UMFA_INTERPRET).

A copy, not an import: importing anything under `umfa_tpu` runs that
package's `__init__`, which imports JAX.
"""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import Optional


class Precision(enum.Enum):
    """Operand precision."""

    FP16 = "fp16"
    BF16 = "bf16"
    FP32 = "fp32"
    INT8 = "int8"
    INT4 = "int4"

    @property
    def is_integer(self) -> bool:
        return self in (Precision.INT8, Precision.INT4)

    @property
    def bits(self) -> int:
        return {"fp16": 16, "bf16": 16, "fp32": 32, "int8": 8, "int4": 4}[self.value]


class QuantMode(enum.Enum):
    """Scale granularity."""

    TENSOR = "tensor"
    ROW = "row"
    BLOCK = "block"
    HYBRID = "hybrid"  # auto-select per tensor statistics


class QuantStrategy(enum.Enum):
    """Zero-point strategy."""

    SYMMETRIC = "symmetric"
    ASYMMETRIC = "asymmetric"


@dataclasses.dataclass(frozen=True)
class BlockSizeConfig:
    """Quantization block sizes along the sequence dimension."""

    q: int = 128
    k: int = 64
    v: int = 64


@dataclasses.dataclass(frozen=True)
class QuantizationConfig:
    """Per-operand quantization configuration."""

    q_precision: Precision = Precision.INT8
    k_precision: Precision = Precision.INT8
    v_precision: Precision = Precision.INT8
    mode: QuantMode = QuantMode.ROW
    strategy: QuantStrategy = QuantStrategy.SYMMETRIC
    block_sizes: BlockSizeConfig = BlockSizeConfig()
    hadamard: bool = False  # FWHT pre-rotation for outlier smoothing
    # Mean smoothing with exact compensation: K channel-mean
    # (softmax-invariant), Q mean (correction row added to scores), V
    # channel-mean (added back after normalization).
    smooth: bool = True
    # None = precision-dependent default: off for INT8, on for INT4 where
    # the Q rounding error is 16x coarser.
    smooth_q: Optional[bool] = None

    def effective_smooth_q(self) -> bool:
        if not self.smooth:
            return False
        if self.smooth_q is not None:
            return self.smooth_q
        return Precision.INT4 in (self.q_precision, self.k_precision)

    # Fully-integer P·V: P quantized to int8 (scale 1/127) and V
    # re-quantized per kernel KV tile. Symmetric only.
    pv_int8: bool = False
    output_precision: Precision = Precision.BF16

    @staticmethod
    def from_mode_string(precision: str, mode: str = "row") -> "QuantizationConfig":
        if precision.lower() in ("int8-qdense", "kv-int8", "kv_int8"):
            # Dense-Q recipe: K/V INT8, Q left at bf16.
            return QuantizationConfig(
                q_precision=Precision.BF16, mode=QuantMode(mode.lower())
            )
        p = Precision(precision.lower())
        if p == Precision.INT4:
            # Default INT4 recipe: Q/K INT4 with Hadamard smoothing, V INT8
            # (INT4 V error lands directly on the output).
            return QuantizationConfig(
                q_precision=p, k_precision=p, v_precision=Precision.INT8,
                mode=QuantMode(mode.lower()), hadamard=True,
            )
        return QuantizationConfig(
            q_precision=p, k_precision=p, v_precision=p, mode=QuantMode(mode.lower())
        )


def env_flag(name: str, default: bool = False) -> bool:
    """UMFA_* env flags: unset → default; "", "0", "false", "no" → False."""
    val = os.environ.get(name)
    if val is None:
        return default
    return val.strip().lower() not in ("", "0", "false", "no")


# Debug and routing flags of the reference (umfa_tpu/engine/config.py:
# 143-146), read once at import as there. UMFA_INTERPRET has no counterpart:
# the port has no interpret mode, and no flag sends CUDA tensors to a plain
# version; UMFA_DISABLE_FUSED and UMFA_NAN_CHECK select api.py's opt-in
# naive routes, counted as `naive_fallback`.
DEBUG = env_flag("UMFA_DEBUG")
NAN_CHECK = env_flag("UMFA_NAN_CHECK")
DISABLE_FUSED = env_flag("UMFA_DISABLE_FUSED")  # route attention() to the naive path


def ring_bwd_route() -> str:
    """UMFA_RING_BWD, read on every call as the reference reads it
    (umfa_tpu/parallel/ring_pallas.py:1117): "pallas" (the default) runs
    the ring backward kernels, any other value the ring of the dense
    backward (its A/B route, not a fallback)."""
    return os.environ.get("UMFA_RING_BWD", "pallas")
