"""Public SDPA-shaped API and dispatch routing (port of umfa_tpu/api.py).

`attention(q, k, v, mask, ...)` promotes 2-D/3-D inputs to (B, H, S, D),
elides an all-True bool mask, canonicalizes the mask to an additive bias,
and routes the call, recording the route in the dispatch stats
(engine/stats.py):
  * `fused_autograd` / `fused_fwd` (return_lse): the differentiable flash
    attention of ops/attention.py, through the port's kernels;
  * `quantized_autograd`: a quantization mode with an integer Q precision,
    the STE route `quantized_flash_attention` of ops/quant_attention.py;
  * `naive_fallback`: the reference's explicit, opt-in plain routes, which
    are attention dropout (dropout_p > 0, with a `torch.Generator` where the
    reference takes a JAX key: the random bits differ), UMFA_DISABLE_FUSED=1
    and the UMFA_NAN_CHECK=1 recompute of an output holding NaN.
A BlockMask, or a mask_mod callable compiled by `make_block_mask` on q's
device (auto-tiled, ops/block_mask.py), goes to the fused route, or under
an integer quantization mode to `quantized_flash_attention(block_mask=...)`
with no other bias (umfa_tpu/api.py:201-216); either walks its tiles
(int8-qdense keeps the dense route, as in the reference). The naive routes
(dropout, UMFA_DISABLE_FUSED) take no block mask and raise
NotImplementedError on one. The reference's window auto-tiling is TPU
tile scheduling and has no counterpart: the kernels' band walk skips the
same tiles.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

from umfa_tpu_torch.engine import config as cfg
from umfa_tpu_torch.engine.config import Precision, QuantMode, QuantizationConfig
from umfa_tpu_torch.engine.stats import record_dispatch
from umfa_tpu_torch.ops import masks as masks_lib
from umfa_tpu_torch.ops.attention import flash_attention, reference_attention
from umfa_tpu_torch.ops.block_mask import BlockMask, make_block_mask
from umfa_tpu_torch.ops.flash_fwd import DEFAULT_MASK_VALUE, fold_mask, visible_mask
from umfa_tpu_torch.ops.quant_attention import quantized_flash_attention

_state = threading.local()
_global_quant_config: Optional[QuantizationConfig] = None
_quant_lock = threading.Lock()


def _config_from(precision, mode) -> QuantizationConfig:
    if isinstance(precision, Precision):
        precision = precision.value
    if isinstance(mode, QuantMode):
        mode = mode.value
    return QuantizationConfig.from_mode_string(precision, mode)


def set_quantization_mode(
    precision: str | Precision | None = "int8",
    mode: str | QuantMode = "row",
    config: Optional[QuantizationConfig] = None,
) -> None:
    """Process-global quantization mode steering the dispatcher;
    set_quantization_mode(None) clears it."""
    global _global_quant_config
    with _quant_lock:
        if precision is None:
            _global_quant_config = None
        else:
            _global_quant_config = config if config is not None else _config_from(precision, mode)


def get_quantization_mode() -> Optional[QuantizationConfig]:
    local = getattr(_state, "quant_config", None)
    return local if local is not None else _global_quant_config


def clear_quantization_mode() -> None:
    set_quantization_mode(None)


@contextlib.contextmanager
def use_quantization(
    precision: str | Precision = "int8",
    mode: str | QuantMode = "row",
    config: Optional[QuantizationConfig] = None,
):
    """Thread-local quantization mode for the duration of the block."""
    prev = getattr(_state, "quant_config", None)
    _state.quant_config = config if config is not None else _config_from(precision, mode)
    try:
        yield
    finally:
        _state.quant_config = prev


def _ensure_4d(x):
    """2-D/3-D → (B, H, S, D) by leading size-1 dims; numpy arrays are taken
    as tensors on the CPU."""
    x = torch.as_tensor(x)
    added = 0
    while x.dim() < 4:
        x = x[None]
        added += 1
    return x, added


def _debug(msg: str) -> None:
    if cfg.DEBUG:
        print(f"[umfa_tpu_torch] {msg}")


def attention(
    q,
    k,
    v,
    mask=None,
    *,
    is_causal: bool = False,
    scale: Optional[float] = None,
    window: Optional[tuple] = None,
    dropout_p: float = 0.0,
    dropout_generator: Optional[torch.Generator] = None,
    quantization: Optional[QuantizationConfig] = None,
    out_dtype: Optional[torch.dtype] = None,
    return_lse: bool = False,
    bias_grad: bool = False,
):
    """SDPA-shaped fused attention. q: (B, Hq, Sq, D), k, v: (B, Hkv, Sk, D)
    (or 3-D/2-D, promoted), Hq % Hkv == 0 for GQA. `mask`: a bool or integer
    mask (nonzero = attend) or an additive float bias, any shape that
    broadcasts to (B, Hq, Sq, Sk); or a BlockMask, or a mask_mod
    `(q_idx, k_idx) -> bool` (FlexAttention-style, ops/block_mask.py).
    `window` = (left, right), -1 = unbounded. Returns out, or (out, lse)
    with return_lse=True; differentiable in q, k, v and, with
    bias_grad=True, in a float mask (else its gradient is 0)."""
    q4, added = _ensure_4d(q)
    k4, _ = _ensure_4d(k)
    v4, _ = _ensure_4d(v)
    batch, num_heads, seq_q, head_dim = q4.shape
    seq_k = k4.shape[2]

    block_mask = None
    if isinstance(mask, BlockMask):
        block_mask, mask = mask, None
    elif callable(mask):
        block_mask = make_block_mask(mask, seq_q, seq_k, head_dim=head_dim, device=q4.device)
        mask = None
    if mask is not None:
        mask = torch.as_tensor(mask)
        if masks_lib.is_all_true(mask):
            record_dispatch("mask_all_true_skipped")
            mask = None
    bias = masks_lib.canonicalize_mask(mask, batch, num_heads, seq_q, seq_k)
    quant = quantization if quantization is not None else get_quantization_mode()
    integer_quant = quant is not None and quant.q_precision.is_integer
    if block_mask is not None and (dropout_p > 0.0 or cfg.DISABLE_FUSED):
        raise NotImplementedError(
            "a block mask takes the fused and quantized routes only: the naive "
            "routes (dropout, UMFA_DISABLE_FUSED) take no block mask"
        )

    if dropout_p > 0.0:
        # Attention dropout is not fused (nor in the reference): the naive
        # route with explicit random bits.
        if dropout_generator is None:
            raise ValueError("dropout_p > 0 requires dropout_generator")
        record_dispatch("naive_fallback")
        out = _dropout_attention(q4, k4, v4, bias, is_causal, window, scale, dropout_p,
                                 dropout_generator)
        return _squeeze(out, added)

    _debug(
        f"attention B={batch} H={num_heads} Sq={seq_q} Sk={seq_k} D={head_dim} "
        f"causal={is_causal} window={window} quant={quant is not None} "
        f"block_mask={block_mask is not None} bias={bias is not None}"
    )
    lse = None
    if cfg.DISABLE_FUSED:
        record_dispatch("naive_fallback")
        out = reference_attention(q4, k4, v4, bias, causal=is_causal, window=window, scale=scale)
    elif integer_quant:
        # A dense Q (int8-qdense) keeps the dense route, as in the reference.
        record_dispatch("quantized_autograd")
        # The block mask brings its own bias and walk; a tile-aligned one
        # has no bias at all, so the walk must go with it.
        out, lse = quantized_flash_attention(q4, k4, v4, bias, config=quant, causal=is_causal,
                                             window=window, scale=scale, block_mask=block_mask,
                                             out_dtype=out_dtype, return_lse=True,
                                             bias_grad=bias_grad)
    else:
        record_dispatch("fused_fwd" if return_lse else "fused_autograd")
        out, lse = flash_attention(q4, k4, v4, bias, causal=is_causal, window=window,
                                   scale=scale, block_mask=block_mask, out_dtype=out_dtype,
                                   return_lse=True, bias_grad=bias_grad)
    if block_mask is not None:
        bias = block_mask.bias
    if cfg.NAN_CHECK:
        out = _nan_check_or_recompute(out, q4, k4, v4, bias, is_causal, window, scale,
                                      None if block_mask is None else block_mask.walk())
    if return_lse and lse is not None:
        return _squeeze(out, added), _squeeze(lse, added)
    return _squeeze(out, added)


def _squeeze(x: torch.Tensor, added: int) -> torch.Tensor:
    for _ in range(added):
        x = x[0]
    return x


def _dropout_attention(q, k, v, bias, causal, window, scale, p, generator):
    """Naive attention with probability dropout (the reference's dropout
    route, api.py:257-285): -1e30 index masking, softmax in fp32, keep each
    probability with chance 1 - p and scale it by 1 / (1 - p)."""
    hq, hkv = q.shape[1], k.shape[1]
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias
    vis = visible_mask(q.shape[2], k.shape[2], *fold_mask(causal, window), s.device)
    s = s.masked_fill(~vis, DEFAULT_MASK_VALUE)
    probs = torch.softmax(s, dim=-1)
    keep = torch.rand(probs.shape, generator=generator, device=generator.device) >= p
    probs = torch.where(keep.to(probs.device), probs / (1.0 - p), 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


def attention_with_lse(q, k, v, mask=None, **kwargs):
    """attention(..., return_lse=True): (out, lse)."""
    return attention(q, k, v, mask, return_lse=True, **kwargs)


def _nan_check_or_recompute(out, q4, k4, v4, bias, is_causal, window, scale, walk):
    """UMFA_NAN_CHECK=1: scan the output for NaN and, if there is any,
    recompute it through the naive reference path (a block mask's walk
    included)."""
    if bool(torch.isnan(out).any()):
        record_dispatch("naive_fallback")
        _debug("NaN detected — recomputing via the naive reference path")
        return reference_attention(q4, k4, v4, bias, causal=is_causal, window=window,
                                   scale=scale, walk=walk).to(out.dtype)
    return out
