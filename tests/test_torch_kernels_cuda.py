"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip where no CUDA device is present. This file imports
no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
        tests/test_torch_kernels_cuda.py

Tolerances (kernel vs plain version on the same inputs, both on the card):
fp32 relerr 2e-5 / LSE 1e-5 (full fp32 on both sides: no TF32); bf16 and
fp16 relerr 1e-2 / LSE 1e-3 (both round P to bf16, relative to different
running maxima, and sum in another order); INT8 relerr 1e-3 / LSE 1e-4
(same int8 inputs and bf16 rounding points, only the summation order
differs). Fully-masked rows must be exact: out 0, LSE -1e30.
"""

import pytest
import torch

from umfa_tpu_torch import _kernels
from umfa_tpu_torch.engine.config import QuantMode
from umfa_tpu_torch.ops.flash_fwd import (
    flash_attention_forward,
    flash_attention_forward_plain,
)
from umfa_tpu_torch.ops.quant import quantize
from umfa_tpu_torch.ops.quant_attention import (
    quantized_attention_forward,
    quantized_attention_forward_plain,
)
from umfa_tpu_torch.utils.testing import rel_err

pytestmark = pytest.mark.cuda

TOLS = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (1e-2, 1e-3),
        torch.float16: (1e-2, 1e-3)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, hq, hkv, sq, sk, d, dtype, dev, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((b, hq, sq, d), generator=g)
    k = torch.randn((b, hkv, sk, d), generator=g)
    v = torch.randn((b, hkv, sk, d), generator=g)
    return (x.to(dev, dtype) for x in (q, k, v))


def _check(out, lse, want, want_lse, rtol, ltol):
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert rel_err(out, want) <= rtol
    vis = want_lse > -1e29
    if vis.any():
        assert (lse[vis] - want_lse[vis]).abs().max().item() <= ltol
    # LSE -1e30: no visible key (out exactly 0) or every visible key masked
    # by a -1e30 bias (uniform average, LSE -1e30 + log(n) == -1e30).
    assert (lse[~vis] == -1e30).all()
    empty = ~vis & (want == 0).all(dim=-1)
    assert (out[empty] == 0).all()


FLASH_CASES = [
    # (b, hq, hkv, sq, sk, d, causal, window, bias_shape)
    (2, 4, 2, 200, 200, 64, True, None, None),
    (1, 2, 2, 130, 257, 64, True, None, None),          # Sq != Sk, KV tail
    (2, 4, 4, 70, 300, 32, False, (-1, 100), None),     # chunk_start window
    (1, 4, 2, 300, 300, 128, False, (50, 0), None),     # sliding window
    (2, 2, 1, 96, 160, 80, False, (20, 10), "bq"),      # D not a power of 2
    (2, 4, 2, 24, 256, 64, False, None, "b1qk"),        # decode bias route
    (1, 4, 2, 64, 128, 64, True, None, "hqk"),
    (2, 2, 2, 100, 60, 64, False, (0, -1), None),       # rows >= 60 fully masked
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_fwd_kernel_matches_plain(dev, dtype, case):
    b, hq, hkv, sq, sk, d, causal, window, bias_shape = case
    q, k, v = _qkv(b, hq, hkv, sq, sk, d, dtype, dev)
    bias = None
    if bias_shape is not None:
        shape = {"bq": (b, 1, 1, sk), "b1qk": (b, 1, sq, sk),
                 "hqk": (1, hq, sq, sk)}[bias_shape]
        g = torch.Generator().manual_seed(1)
        bias = torch.randn(shape, generator=g).to(dev)
        bias = torch.where(bias > 1.5, torch.full_like(bias, -1e30), bias)
    n0 = _kernels.launches["flash_fwd"]
    out, lse = flash_attention_forward(q, k, v, bias, causal=causal, window=window)
    torch.cuda.synchronize()
    assert _kernels.launches["flash_fwd"] == n0 + 1
    want, want_lse = flash_attention_forward_plain(q, k, v, bias, causal=causal, window=window)
    assert out.dtype == dtype and lse.dtype == torch.float32
    _check(out.float(), lse, want.float(), want_lse, *TOLS[dtype])


def test_flash_fwd_kernel_bf16_in_fp32_out(dev):
    q, k, v = _qkv(2, 4, 2, 150, 150, 64, torch.bfloat16, dev)
    out, lse = flash_attention_forward(q, k, v, causal=True, out_dtype=torch.float32)
    want, want_lse = flash_attention_forward_plain(q, k, v, causal=True, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    _check(out, lse, want, want_lse, 1e-2, 1e-3)


def test_flash_fwd_kernel_refuses_what_it_does_not_take(dev):
    q, k, v = _qkv(1, 2, 2, 64, 64, 64, torch.float32, dev)
    with pytest.raises(ValueError):
        flash_attention_forward(q.transpose(2, 3), k, v)
    with pytest.raises(ValueError):
        flash_attention_forward(q, k.cpu(), v)
    q2, k2, v2 = _qkv(1, 2, 2, 64, 64, 192, torch.float32, dev)
    with pytest.raises(ValueError):
        flash_attention_forward(q2, k2, v2)


QUANT_CASES = [
    # (b, hq, hkv, sq, sk, d, causal, window, bias, q_mode, kv_mode)
    (2, 4, 2, 200, 200, 64, True, None, False, QuantMode.ROW, QuantMode.ROW),
    (1, 4, 2, 16, 300, 64, False, (-1, 284), False, QuantMode.ROW, QuantMode.ROW),
    (2, 4, 2, 24, 256, 64, False, None, True, QuantMode.ROW, QuantMode.ROW),
    (1, 2, 1, 130, 257, 128, True, None, False, QuantMode.TENSOR, QuantMode.BLOCK),
    (2, 2, 2, 100, 60, 32, False, (0, -1), False, QuantMode.ROW, QuantMode.TENSOR),
    (1, 4, 4, 120, 120, 48, False, (30, 5), True, QuantMode.BLOCK, QuantMode.ROW),
]


@pytest.mark.parametrize("case", QUANT_CASES)
def test_quant_attn_fwd_kernel_matches_plain(dev, case):
    b, hq, hkv, sq, sk, d, causal, window, use_bias, qm, kvm = case
    q, k, v = _qkv(b, hq, hkv, sq, sk, d, torch.float32, dev)
    qt_q, qt_k, qt_v = quantize(q, mode=qm), quantize(k, mode=kvm), quantize(v, mode=kvm)
    bias = None
    if use_bias:
        bias = torch.randn((b, 1, sq, sk), generator=torch.Generator().manual_seed(2)).to(dev)
        bias = torch.where(bias > 1.5, torch.full_like(bias, -1e30), bias)
    n0 = _kernels.launches["quant_attn_fwd"]
    out, lse = quantized_attention_forward(qt_q, qt_k, qt_v, bias, causal=causal, window=window)
    torch.cuda.synchronize()
    assert _kernels.launches["quant_attn_fwd"] == n0 + 1
    want, want_lse = quantized_attention_forward_plain(
        qt_q, qt_k, qt_v, bias, causal=causal, window=window)
    assert out.dtype == torch.float32
    _check(out, lse, want, want_lse, 1e-3, 1e-4)
