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

Backward kernels (dQ, dK/dV, dbias) against `flash_attention_backward_plain`
and `flash_attention_bias_grad_plain` on the same inputs: fp32 and fp16
(computed as fp32) relerr 1e-4, the backward bound of
tests/test_flash_backward.py:32; bf16 (bf16 gradients emitted, dS and P
rounded to bf16 at the same points, fp32 sums in another order) relerr
2e-2, TOL["bf16"]. Rows with no visible key have gradients of exactly 0.
The fp32 dQ, dK/dV and dbias (3xTF32 on the tensor cores) are also held to
5e-6, a twentieth of their gate, where one TF32 pass would sit near 1e-3.
"""

import dataclasses
import math

import pytest
import torch

from umfa_tpu_torch import _kernels
from umfa_tpu_torch.engine.config import Precision, QuantMode, QuantStrategy
from umfa_tpu_torch.ops.attention import flash_attention
from umfa_tpu_torch.ops.flash_bwd import (
    flash_attention_backward,
    flash_attention_backward_plain,
    flash_attention_bias_grad,
    flash_attention_bias_grad_plain,
)
from umfa_tpu_torch.ops.flash_fwd import (
    flash_attention_forward,
    flash_attention_forward_plain,
    walked_keys,
)
from umfa_tpu_torch.ops.quant import quantize
from umfa_tpu_torch.ops.rope import rope_angles, rope_attention
from umfa_tpu_torch.ops.quant_attention import (
    quantized_attention_forward,
    quantized_attention_forward_plain,
)
from umfa_tpu_torch.utils.testing import lse_check, rel_err

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


def _check(out, lse, want, want_lse, rtol, ltol, arbiter=None):
    """arbiter: (q, k, bias, keep) of the call; then a row whose LSE is
    past ltol from the plain version's must be within ltol of the float64
    one (`lse_check`: the fp32 plain version rounds a short row's bf16(P)
    one ulp off)."""
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert rel_err(out, want) <= rtol
    vis = want_lse > -1e29
    if arbiter is not None:
        q, k, bias, keep = arbiter
        res = lse_check(lse, want_lse, q, k, bias, ltol, keep=keep)
        assert res["lse_ok"], res
    elif vis.any():
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
    (1, 4, 1, 130, 257, 48, True, None, "bq"),          # D 48, GQA 4, KV tail
    (2, 4, 2, 70, 300, 128, False, (-1, 100), "b1qk"),  # D 128, chunk window, bias
    (1, 4, 2, 130, 257, 256, True, None, None),         # D 256, KV tail
    (2, 2, 1, 70, 300, 256, False, (40, 8), "hqk"),     # D 256, window, bias, GQA 2
    (1, 4, 4, 100, 60, 128, False, (0, -1), None),      # D 128, rows >= 60 fully masked
    (1, 2, 2, 100, 60, 256, False, (0, -1), "bq"),      # D 256, masked rows and a bias
    (1, 4, 2, 130, 257, 192, True, None, None),         # D 192 (padded to 256), KV tail
    (2, 2, 1, 70, 300, 192, False, (40, 8), "hqk"),     # D 192, window, bias, GQA 2
    (1, 4, 1, 100, 60, 192, False, (0, -1), "bq"),      # D 192, GQA 4, masked rows, a bias
]


# bf16 runs the tensor-core body in bf16, fp32 and fp16 in 3xTF32 (at D 256
# on 8 warps, 128 query rows and 16-key tiles); each counts as one
# `flash_fwd` launch.
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


# A bias that hides every key of a row's first 512 and keeps later ones
# (a top-k bias like the MLA indexer's, with the first 512 keys never kept;
# and one that keeps only the last 64 keys): the K-only pre-pass covers
# every visible tile under a bias, so P is rounded against each row's final
# max, as the plain version rounds it. A row past the LSE gate must be
# within it of the float64 LSE (`lse_check`, as the walk tests below): in a
# row that sees one or two kept keys the fp32 plain version can round a
# bf16(P) one ulp off (1.7e-3 in LSE), where the kernel holds the float64
# value. Before the repair such rows missed by running maxima, not ulps.
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kind,causal", [("topk_past_512", True), ("topk_past_512", False),
                                         ("last_64", False)])
def test_flash_fwd_bias_that_keeps_keys_past_the_first_512(dev, dtype, d, kind, causal):
    b, h, s = 2, 4, 2048
    q, k, v = _qkv(b, h, h, s, s, d, dtype, dev, seed=3)
    keep = torch.zeros((b, s, s), dtype=torch.bool)
    if kind == "topk_past_512":
        scores = torch.rand((b, s, s), generator=torch.Generator().manual_seed(5))
        scores[..., :512] = -1.0
        keep = scores >= torch.topk(scores, 64, dim=-1).values[..., -1:]
    else:
        keep[..., -64:] = True
    bias = torch.where(keep, 0.0, -1e30)[:, None].to(dev)
    out, lse = flash_attention_forward(q, k, v, bias, causal=causal)
    want, want_lse = flash_attention_forward_plain(q, k, v, bias, causal=causal)
    visible = torch.ones((s, s), dtype=torch.bool, device=dev).tril() if causal else None
    _check(out.float(), lse, want.float(), want_lse, *TOLS[dtype],
           arbiter=(q, k, bias, visible))


@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_fwd_kernel_bf16_in_fp32_out(dev, d):
    q, k, v = _qkv(2, 4, 2, 150, 150, d, torch.bfloat16, dev)
    out, lse = flash_attention_forward(q, k, v, causal=True, out_dtype=torch.float32)
    want, want_lse = flash_attention_forward_plain(q, k, v, causal=True, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    _check(out, lse, want, want_lse, 1e-2, 1e-3)


# The fp32 forward (3xTF32 on the tensor cores) as accurate as fp32 FMAs in
# another order: 5e-6 against the plain version at causal S 1024 with
# q ~ N(0, 3), a quarter of the gate, as the fp32 backward is held
# (test_flash_bwd_fp32_keeps_highest_accuracy).
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_fwd_fp32_keeps_highest_accuracy(dev, d):
    q, k, v = _qkv(2, 4, 4, 1024, 1024, d, torch.float32, dev)
    q = q * 3.0
    out, lse = flash_attention_forward(q, k, v, causal=True)
    want, want_lse = flash_attention_forward_plain(q, k, v, causal=True)
    _check(out, lse, want, want_lse, 5e-6, 1e-5)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64), (torch.float32, 128),
                                     (torch.float32, 256), (torch.bfloat16, 64)])
def test_flash_fwd_kernel_is_deterministic(dev, dtype, d):
    q, k, v = _qkv(2, 4, 2, 300, 300, d, dtype, dev)
    first = flash_attention_forward(q, k, v, causal=True)
    second = flash_attention_forward(q, k, v, causal=True)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


def test_flash_fwd_kernel_refuses_what_it_does_not_take(dev):
    q, k, v = _qkv(1, 2, 2, 64, 64, 64, torch.float32, dev)
    with pytest.raises(ValueError):
        flash_attention_forward(q.transpose(2, 3), k, v)
    with pytest.raises(ValueError):
        flash_attention_forward(q, k.cpu(), v)
    for dtype in (torch.float32, torch.bfloat16):
        q2, k2, v2 = _qkv(1, 2, 2, 64, 64, 320, dtype, dev)
        with pytest.raises(ValueError):
            flash_attention_forward(q2, k2, v2)


# The ROPE instantiation of the forward body (rotate-half RoPE inside the
# kernel: Q as it is staged, each K tile in shared memory) against the plain
# version on the same tables, at the dense forward's gates; it counts as one
# `flash_fwd` launch and one `flash_fwd/rope`.
ROPE_CASES = [
    # (b, hq, hkv, sq, sk, d, causal, window, bias_shape)
    (2, 4, 2, 200, 200, 64, True, None, None),          # causal, GQA 2, S not a tile multiple
    (1, 4, 4, 300, 300, 128, False, None, None),        # non-causal
    (1, 2, 2, 130, 257, 64, True, None, None),          # Sq != Sk, KV tail
    (1, 4, 2, 300, 300, 128, False, (50, 0), None),     # sliding window
    (2, 2, 1, 96, 160, 80, False, (20, 10), "bq"),      # D 80, window, bias, GQA 2
    (1, 4, 2, 64, 128, 64, True, None, "hqk"),          # per-head bias, Sq != Sk
    (1, 4, 1, 700, 700, 64, True, None, None),          # rows past the 512-key pre-pass, GQA 4
    (1, 4, 2, 130, 257, 256, True, None, None),         # D 256, KV tail
    (2, 2, 1, 70, 300, 256, False, (40, 8), "hqk"),     # D 256, window, bias
    (1, 2, 2, 300, 200, 192, False, None, None),        # D 192 (padded to 256), Sq > Sk
    (1, 4, 2, 150, 150, 36, True, None, None),          # D/2 18: the tables a pair at a time
]


def _rope_bias(shape, dev):
    bias = torch.randn(shape, generator=torch.Generator().manual_seed(1)).to(dev)
    return torch.where(bias > 1.5, torch.full_like(bias, -1e30), bias)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ROPE_CASES)
def test_flash_fwd_rope_kernel_matches_plain(dev, dtype, case):
    b, hq, hkv, sq, sk, d, causal, window, bias_shape = case
    q, k, v = _qkv(b, hq, hkv, sq, sk, d, dtype, dev, seed=4)
    bias = None if bias_shape is None else _rope_bias(
        {"bq": (b, 1, 1, sk), "hqk": (1, hq, sq, sk)}[bias_shape], dev)
    cos, sin = rope_angles(max(sq, sk) + 3, d, device=dev)  # rows past S unread
    kw = dict(causal=causal, window=window, rope_cos=cos, rope_sin=sin)
    n0, r0 = _kernels.launches["flash_fwd"], _kernels.launches["flash_fwd/rope"]
    out, lse = flash_attention_forward(q, k, v, bias, **kw)
    torch.cuda.synchronize()
    assert (_kernels.launches["flash_fwd"], _kernels.launches["flash_fwd/rope"]) == (n0 + 1, r0 + 1)
    want, want_lse = flash_attention_forward_plain(q, k, v, bias, **kw)
    assert out.dtype == dtype
    _check(out.float(), lse, want.float(), want_lse, *TOLS[dtype])


# As test_flash_fwd_fp32_keeps_highest_accuracy: the fp32 ROPE instantiation
# (3xTF32) at 5e-6 against the plain version, causal S 1024, q ~ N(0, 3).
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_fwd_rope_fp32_keeps_highest_accuracy(dev, d):
    q, k, v = _qkv(2, 4, 4, 1024, 1024, d, torch.float32, dev)
    q = q * 3.0
    cos, sin = rope_angles(1024, d, device=dev)
    out, lse = flash_attention_forward(q, k, v, causal=True, rope_cos=cos, rope_sin=sin)
    want, want_lse = flash_attention_forward_plain(q, k, v, causal=True, rope_cos=cos,
                                                   rope_sin=sin)
    _check(out, lse, want, want_lse, 5e-6, 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_rope_kernel_takes_unaligned_tables(dev, dtype):
    # Tables 4 bytes past a 16-byte boundary: read a pair at a time.
    q, k, v = _qkv(1, 4, 2, 200, 200, 64, dtype, dev, seed=6)
    cos, sin = rope_angles(200, 64, device=dev)
    off = [torch.empty(cos.numel() + 1, device=dev) for _ in range(2)]
    for buf, t in zip(off, (cos, sin)):
        buf[1:] = t.flatten()
    ucos, usin = (buf[1:].view(200, 32) for buf in off)
    assert ucos.data_ptr() % 16 and usin.data_ptr() % 16
    out, lse = flash_attention_forward(q, k, v, causal=True, rope_cos=ucos, rope_sin=usin)
    want, want_lse = flash_attention_forward_plain(q, k, v, causal=True, rope_cos=cos,
                                                   rope_sin=sin)
    _check(out.float(), lse, want.float(), want_lse, *TOLS[dtype])


def test_flash_fwd_rope_kernel_refuses_tables_off_the_card(dev):
    q, k, v = _qkv(1, 2, 2, 64, 64, 64, torch.bfloat16, dev)
    cos, sin = rope_angles(64, 64, device="cpu")
    with pytest.raises(ValueError, match="RoPE tables"):
        flash_attention_forward(q, k, v, rope_cos=cos, rope_sin=sin)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_attention_on_the_card_matches_the_cpu(dev, dtype):
    # The in-kernel route's forward and backward (rows 1-3) against the same
    # call on the CPU (plain versions); bf16 at the backward's bf16 gate.
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(s, generator=g).to(dtype)
               for s in ((2, 4, 300, 64), (2, 2, 300, 64), (2, 2, 300, 64)))
    w = torch.randn((2, 4, 300, 64), generator=g)
    res = {}
    for where in ("cuda", "cpu"):
        t = [x.to(where).requires_grad_(True) for x in (q, k, v)]
        r0 = _kernels.launches["flash_fwd/rope"]
        out = rope_attention(*t, interleaved=False, causal=True)
        (out.float() * w.to(where)).sum().backward()
        assert _kernels.launches["flash_fwd/rope"] == r0 + (where == "cuda")
        res[where] = [out.detach().cpu()] + [x.grad.cpu() for x in t]
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b, name in zip(res["cuda"], res["cpu"], ("out", "dq", "dk", "dv")):
        assert rel_err(a, b) <= tol, name


QUANT_CASES = [
    # (b, hq, hkv, sq, sk, d, causal, window, bias, q_mode, kv_mode)
    (2, 4, 2, 200, 200, 64, True, None, False, QuantMode.ROW, QuantMode.ROW),
    (1, 4, 2, 16, 300, 64, False, (-1, 284), False, QuantMode.ROW, QuantMode.ROW),
    (2, 4, 2, 24, 256, 64, False, None, True, QuantMode.ROW, QuantMode.ROW),
    (1, 2, 1, 130, 257, 128, True, None, False, QuantMode.TENSOR, QuantMode.BLOCK),
    (2, 2, 2, 100, 60, 32, False, (0, -1), False, QuantMode.ROW, QuantMode.TENSOR),
    (1, 4, 4, 120, 120, 48, False, (30, 5), True, QuantMode.BLOCK, QuantMode.ROW),
    (1, 4, 1, 300, 257, 256, False, (0, -1), False, QuantMode.ROW, QuantMode.ROW),  # GQA 4, tail, masked rows
    (2, 2, 1, 70, 300, 256, False, (40, 8), True, QuantMode.ROW, QuantMode.ROW),   # -1e30 bias entries
    (1, 4, 2, 130, 257, 192, True, None, False, QuantMode.ROW, QuantMode.BLOCK),   # D 192 padded to 256
    (2, 4, 2, 100, 150, 36, True, None, True, QuantMode.ROW, QuantMode.ROW),       # 4-byte copies
    (2, 4, 2, 16, 300, 128, False, (-1, 284), False, QuantMode.ROW, QuantMode.ROW),  # Tq 16 chunk
    (1, 4, 2, 130, 257, 63, True, None, True, QuantMode.ROW, QuantMode.ROW),  # D 63: zero-padded codes
    (2, 2, 1, 70, 300, 250, False, (40, 8), False, QuantMode.ROW, QuantMode.ROW),  # D 250, padded to 256
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


# Row 5's INT4 operands (unpacked while staged), the Q-mean corr row and
# ASYMMETRIC zero points, at D 64, 128 and 256 and a D that is not a
# multiple of 4 (66 under INT4: unpacked and zero-padded by the wrapper;
# 63 under INT8), against the plain version at the INT8 gates.
QUANT_VARIANT_CASES = [
    # (b, hq, hkv, sq, sk, d, causal, window, bias, precisions, asym, mode, corr)
    (2, 4, 2, 200, 200, 64, True, None, False, "int4_qk", False, QuantMode.ROW, True),
    (1, 4, 2, 130, 257, 128, True, None, True, "int4", False, QuantMode.ROW, True),
    (1, 4, 1, 300, 257, 256, False, (0, -1), False, "int4_qk", False, QuantMode.ROW, True),
    (1, 4, 2, 130, 257, 66, True, None, False, "int4_qk", False, QuantMode.ROW, True),
    (2, 4, 2, 200, 200, 64, True, None, True, "int8", True, QuantMode.ROW, False),
    (1, 4, 2, 130, 257, 128, False, (40, 8), False, "int8", True, QuantMode.TENSOR, True),
    (1, 4, 2, 130, 257, 256, True, None, True, "int4_qk", True, QuantMode.ROW, True),
    (1, 4, 2, 100, 150, 63, True, None, False, "int8", True, QuantMode.BLOCK, True),
    (2, 4, 2, 16, 300, 64, False, (-1, 284), False, "int4", True, QuantMode.ROW, False),
    # INT4 at D 40 (unpacked in the kernel, columns 40-63 zero) and D 36
    # (not a multiple of 8: unpacked by the wrapper).
    (1, 4, 2, 130, 257, 40, True, None, False, "int4", False, QuantMode.ROW, True),
    (1, 4, 2, 130, 257, 36, True, None, False, "int4_qk", True, QuantMode.ROW, False),
]
_PRECS = {"int8": (Precision.INT8,) * 3, "int4": (Precision.INT4,) * 3,
          "int4_qk": (Precision.INT4, Precision.INT4, Precision.INT8)}


@pytest.mark.parametrize("case", QUANT_VARIANT_CASES)
def test_quant_attn_fwd_kernel_int4_corr_asym_match_plain(dev, case):
    b, hq, hkv, sq, sk, d, causal, window, use_bias, precs, asym, mode, use_corr = case
    q, k, v = _qkv(b, hq, hkv, sq, sk, d, torch.float32, dev)
    strategy = QuantStrategy.ASYMMETRIC if asym else QuantStrategy.SYMMETRIC
    qts = [quantize(x + off, p, mode, strategy)
           for x, p, off in zip((q, k, v), _PRECS[precs], (0.0, 0.4, 0.2))]
    g = torch.Generator().manual_seed(3)
    corr = torch.randn((b, hq, 1, sk), generator=g).to(dev) if use_corr else None
    bias = torch.randn((b, 1, sq, sk), generator=g).to(dev) if use_bias else None
    n0 = _kernels.launches["quant_attn_fwd"]
    out, lse = quantized_attention_forward(*qts, bias, corr, causal=causal, window=window)
    torch.cuda.synchronize()
    assert _kernels.launches["quant_attn_fwd"] == n0 + 1
    want, want_lse = quantized_attention_forward_plain(*qts, bias, corr, causal=causal,
                                                       window=window)
    _check(out, lse, want, want_lse, 1e-3, 1e-4)


BWD_TOLS = {torch.float32: 1e-4, torch.float16: 1e-4, torch.bfloat16: 2e-2}
BWD_CASES = [
    # (b, hq, hkv, sq, sk, d, causal, window, bias_shape, dlse)
    (2, 4, 2, 200, 200, 64, True, None, None, False),
    (1, 2, 2, 130, 257, 32, True, None, None, True),       # Sq != Sk, KV tail, D 32
    (1, 4, 2, 300, 300, 128, False, (50, 0), None, False),  # sliding window, D 128
    (2, 2, 1, 96, 160, 80, False, (20, 10), "b11k", True),  # D not a power of 2
    (2, 4, 2, 77, 100, 64, False, None, "bhqk", False),
    (1, 4, 4, 64, 128, 64, True, None, "11qk", True),
    (2, 2, 2, 100, 60, 64, False, (0, -1), None, False),     # rows >= 60 fully masked
]


def _bias(shape_kind, b, hq, sq, sk, dev, seed=1):
    shape = {"b11k": (b, 1, 1, sk), "bhqk": (b, hq, sq, sk), "11qk": (1, 1, sq, sk)}[shape_kind]
    bias = torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(dev)
    return torch.where(bias > 1.5, torch.full_like(bias, -1e30), bias)


def _bwd_inputs(case, dtype, dev, q_sd=1.0):
    b, hq, hkv, sq, sk, d, causal, window, bias_shape, dlse = case
    q, k, v = _qkv(b, hq, hkv, sq, sk, d, dtype, dev)
    if q_sd != 1.0:
        q = q * q_sd
    bias = None if bias_shape is None else _bias(bias_shape, b, hq, sq, sk, dev)
    out, lse = flash_attention_forward_plain(q, k, v, bias, causal=causal, window=window)
    g = torch.Generator().manual_seed(2)
    do = torch.randn(out.shape, generator=g).to(dev, out.dtype)
    g_lse = torch.randn(lse.shape, generator=g).to(dev) if dlse else None
    return (q, k, v, out, lse, do, bias, g_lse), dict(causal=causal, window=window)


def _check_bwd(args, kw, gdt, tol):
    """Both backward kernels once each, against the plain version."""
    n_dq, n_dkv = _kernels.launches["flash_bwd_dq"], _kernels.launches["flash_bwd_dkv"]
    got = flash_attention_backward(*args, grad_dtype=gdt, **kw)
    torch.cuda.synchronize()
    assert _kernels.launches["flash_bwd_dq"] == n_dq + 1
    assert _kernels.launches["flash_bwd_dkv"] == n_dkv + 1
    want = flash_attention_backward_plain(*args, grad_dtype=gdt, **kw)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == w.dtype == (gdt or torch.float32), name
        assert torch.isfinite(g.float()).all(), name
        assert rel_err(g, w) <= tol, name
    empty = args[4] <= -1e29  # rows with no visible key
    if empty.any():
        assert (got[0][empty] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_bwd_kernels_match_plain(dev, dtype, case):
    args, kw = _bwd_inputs(case, dtype, dev)
    _check_bwd(args, kw, torch.bfloat16 if dtype == torch.bfloat16 else None, BWD_TOLS[dtype])


# bf16 inputs at head dims over 128, which only the tensor-core kernels take
# (their 256 template; D 192 zero-padded to it): bf16 gradients, 2e-2.
BWD_WIDE_CASES = [
    (1, 4, 2, 130, 257, 192, True, None, None, True),        # D 192, Sq != Sk, KV tail, dlse
    (2, 4, 1, 200, 200, 256, True, None, None, False),       # GQA 4
    (1, 2, 2, 100, 60, 256, False, (0, -1), None, False),    # rows >= 60 fully masked
    (2, 2, 1, 96, 160, 256, False, (20, 10), "b11k", True),  # window, bias, GQA 2, dlse
]


@pytest.mark.parametrize("case", BWD_WIDE_CASES)
def test_flash_bwd_kernels_bf16_wide_heads_match_plain(dev, case):
    args, kw = _bwd_inputs(case, torch.bfloat16, dev)
    _check_bwd(args, kw, torch.bfloat16, BWD_TOLS[torch.bfloat16])


# fp16 inputs (computed as fp32) at the same head dims: the 3xTF32 bodies'
# D 256 tiles, fp32 gradients, 1e-4.
@pytest.mark.parametrize("case", BWD_WIDE_CASES)
def test_flash_bwd_kernels_fp16_wide_heads_match_plain(dev, case):
    args, kw = _bwd_inputs(case, torch.float16, dev)
    _check_bwd(args, kw, None, BWD_TOLS[torch.float16])


def _check_dbias(case, dtype, dev):
    """The dbias kernel once, against the plain version: fp32 out, 1e-4."""
    (q, k, v, out, lse, do, bias, _), kw = _bwd_inputs(case, dtype, dev)
    if bias.shape[2] == 1:
        bias = bias.expand(*bias.shape[:2], q.shape[2], bias.shape[3])
    n0 = _kernels.launches["flash_dbias"]
    got = flash_attention_bias_grad(q, k, v, out, lse, do, bias, **kw)
    torch.cuda.synchronize()
    assert _kernels.launches["flash_dbias"] == n0 + 1
    want = flash_attention_bias_grad_plain(q, k, v, out, lse, do, bias, **kw)
    assert got.shape == want.shape == bias.shape and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [c for c in BWD_CASES if c[8] is not None] + [
    (2, 4, 2, 150, 150, 64, True, (40, 0), "bhqk", False)])
def test_flash_dbias_kernel_matches_plain(dev, dtype, case):
    _check_dbias(case, dtype, dev)


# The tensor-core dbias kernel (bf16 inputs) at the fp32-out gate, 1e-4:
# both sides sum exact bf16 products in fp32 and round nowhere after.
DBIAS_TC_CASES = [
    (2, 4, 2, 200, 200, 64, True, None, "11qk", False),       # summed over batch and heads
    (2, 4, 2, 150, 170, 128, False, None, "bhqk", False),     # per (batch, head)
    (2, 4, 2, 300, 300, 64, False, (40, 0), "11qk", False),   # window: hidden tiles are zeros
    (1, 4, 1, 130, 257, 256, True, None, "bhqk", False),      # D 256, GQA 4, KV tail
    (2, 2, 2, 77, 100, 80, False, (20, 10), "11qk", False),   # D 80: two column chunks
]


@pytest.mark.parametrize("case", DBIAS_TC_CASES)
def test_flash_dbias_tc_bf16_matches_plain(dev, case):
    _check_dbias(case, torch.bfloat16, dev)


# fp32 and fp16 inputs (computed as fp32) on the same kernel's 3xTF32 body,
# at the same cases (D 80: three column chunks; D 256: eight) and at D 192,
# at the fp32 gate, 1e-4.
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("case", DBIAS_TC_CASES + [
    (1, 4, 2, 130, 257, 192, True, None, "11qk", False)])  # D 192, KV tail, summed
def test_flash_dbias_tc_fp32_matches_plain(dev, dtype, case):
    _check_dbias(case, dtype, dev)


def test_flash_dbias_tc_row_masked_by_bias_alone(dev):
    # Rows 5 and 40 see keys by the index rule, but a -1e30 bias hides
    # every one: LSE -1e30, P = exp(S + bias + 1e30) = 1 on them, and their
    # dbias is not zero (the reference's arithmetic).
    q, k, v = _qkv(2, 4, 2, 96, 96, 64, torch.bfloat16, dev)
    bias = torch.randn((1, 4, 96, 96), generator=torch.Generator().manual_seed(5)).to(dev)
    bias[:, :, (5, 40)] = -1e30
    out, lse = flash_attention_forward_plain(q, k, v, bias)
    assert (lse[:, :, (5, 40)] == -1e30).all()
    do = torch.randn(out.shape, generator=torch.Generator().manual_seed(6)).to(dev, out.dtype)
    got = flash_attention_bias_grad(q, k, v, out, lse, do, bias)
    want = flash_attention_bias_grad_plain(q, k, v, out, lse, do, bias)
    assert (want[:, :, (5, 40)] != 0).any()
    assert torch.isfinite(got).all()
    assert rel_err(got, want) <= 1e-4


def test_flash_attention_autograd_on_the_card_matches_the_cpu(dev):
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(s, generator=g) for s in ((2, 4, 96, 64), (2, 2, 96, 64), (2, 2, 96, 64)))
    bias = torch.randn((1, 4, 96, 96), generator=g)
    grads = {}
    for where in ("cuda", "cpu"):
        t = [x.to(where).requires_grad_(True) for x in (q, k, v, bias)]
        out = flash_attention(*t[:3], t[3], causal=True, bias_grad=True)
        out.square().sum().backward()
        grads[where] = [x.grad.cpu() for x in t]
    for a, b, name in zip(grads["cuda"], grads["cpu"], ("dq", "dk", "dv", "dbias")):
        assert rel_err(a, b) <= 1e-4, name


# bf16 inputs with fp32 gradients: dQ and dK/dV both run on the tensor
# cores (dq_tc_kernel and dkv_tc_kernel with the dense load stages). Gate
# 5e-4: both sides round Q·scale, P and dS to bf16 at the same points and
# differ where an fp32 summation order moves an element across a rounding
# boundary; at D 80 and 128 (scale not a power of two) a dK taken from the
# rounded scaled Q instead of the raw Q sits at ~1.7e-3, which the bf16-out
# gate of 2e-2 cannot see.
@pytest.mark.parametrize("case", [
    (2, 4, 2, 200, 200, 80, True, None, None, True),
    (1, 4, 2, 130, 257, 128, True, None, None, False),       # Sq != Sk, KV tail
    (2, 2, 1, 96, 160, 80, False, (20, 10), "b11k", True),  # window, bias, GQA 2
    (1, 4, 4, 100, 60, 128, False, (0, -1), None, False),    # rows >= 60 fully masked
    (1, 4, 2, 130, 257, 256, True, None, None, True),        # D 256, KV tail, dlse
    (1, 4, 1, 100, 60, 256, False, (0, -1), None, False),    # D 256, GQA 4, masked rows
])
def test_flash_bwd_dkv_tc_bf16_in_fp32_out(dev, case):
    args, kw = _bwd_inputs(case, torch.bfloat16, dev)
    _check_bwd(args, kw, None, 5e-4)


# fp32 inputs: dQ and dK/dV on the tensor cores in 3xTF32 (dq_tc_kernel and
# dkv_tc_kernel with fp32 load stages), at head dims that are not multiples
# of 16 (zero-padded to the 64 template), a KV tail, GQA 4, fully masked
# rows and a long causal row with larger scores, and at D 192 and 256 (the
# wide fp32 tiles: dK/dV 32-key blocks, dQ 16-key tiles); gate 1e-4
# (BWD_TOLS).
BWD_FP32_CASES = [
    # (case as in BWD_CASES, q_sd)
    ((2, 4, 2, 200, 200, 36, True, None, None, True), 1.0),       # D 36, dlse
    ((1, 4, 1, 130, 257, 48, True, None, None, False), 1.0),      # D 48, KV tail, GQA 4
    ((2, 4, 1, 100, 60, 64, False, (0, -1), None, False), 1.0),   # GQA 4, rows >= 60 masked
    ((1, 2, 2, 77, 100, 36, False, (20, 10), "bhqk", True), 1.0),  # D 36, window, bias
    ((1, 4, 2, 1024, 1024, 64, True, None, None, False), 3.0),    # causal S 1024, q ~ N(0, 3)
    ((1, 4, 2, 1024, 1024, 128, True, None, None, True), 3.0),    # the same at D 128, dlse
    ((1, 4, 2, 130, 257, 192, True, None, None, True), 1.0),      # D 192, KV tail, dlse
    ((2, 4, 1, 200, 200, 256, True, None, None, False), 1.0),     # D 256, GQA 4
    ((1, 2, 2, 100, 60, 256, False, (0, -1), None, False), 1.0),  # D 256, rows >= 60 masked
    ((2, 2, 1, 96, 160, 256, False, (20, 10), "b11k", True), 1.0),  # window, bias, GQA 2, dlse
    ((1, 4, 1, 100, 60, 192, False, (0, -1), "bhqk", True), 1.0),  # D 192, GQA 4, masked, bias
    ((1, 4, 2, 1024, 1024, 256, True, None, None, True), 3.0),    # causal S 1024 at D 256
]


@pytest.mark.parametrize("case,q_sd", BWD_FP32_CASES)
def test_flash_bwd_fp32_tc_kernels_match_plain(dev, case, q_sd):
    args, kw = _bwd_inputs(case, torch.float32, dev, q_sd=q_sd)
    _check_bwd(args, kw, None, BWD_TOLS[torch.float32])


# The 3xTF32 products keep the fp32 backward about as accurate as fp32 FMAs
# in another order: 5e-6 against the plain version at causal S 1024 with
# q ~ N(0, 3), a twentieth of the gate (chip_smoke.py reports both sides'
# distance from a float64 evaluation at this shape). One TF32 pass sits
# near 1e-3 there (the CPU model, tests/test_torch_flash_bwd_split.py).
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_bwd_fp32_keeps_highest_accuracy(dev, d):
    args, kw = _bwd_inputs((2, 4, 4, 1024, 1024, d, True, None, None, False), torch.float32, dev,
                           q_sd=3.0)
    _check_bwd(args, kw, None, 5e-6)


# The fp32 dbias (3xTF32) at the same shape and gate, 5e-6, with a bias
# summed over batch and heads (32 (b, h) a tile) and one per (b, h): dS =
# P∘(dP − δ) cancels in dP − δ, so a truncated mma chain in S or dP shows
# as flipped low bits over the whole row, where the summed bias adds 32 of
# them up.
@pytest.mark.parametrize("kind", ["11qk", "bhqk"])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_dbias_fp32_keeps_highest_accuracy(dev, d, kind):
    (q, k, v, out, lse, do, bias, _), kw = _bwd_inputs(
        (2, 4, 4, 1024, 1024, d, True, None, kind, False), torch.float32, dev, q_sd=3.0)
    n0 = _kernels.launches["flash_dbias"]
    got = flash_attention_bias_grad(q, k, v, out, lse, do, bias, **kw)
    torch.cuda.synchronize()
    assert _kernels.launches["flash_dbias"] == n0 + 1
    want = flash_attention_bias_grad_plain(q, k, v, out, lse, do, bias, **kw)
    assert torch.isfinite(got).all()
    assert rel_err(got, want) <= 5e-6


def test_quant_attn_fwd_kernel_word_copies_for_unaligned_operands(dev):
    # int8 operands 4 bytes past a 16-byte boundary: 4-byte copies at D 64.
    q, k, v = _qkv(1, 4, 2, 130, 200, 64, torch.float32, dev)
    qt = [quantize(x) for x in (q, k, v)]
    for t in qt:
        buf = torch.empty(t.values.numel() + 16, dtype=torch.int8, device=dev)
        t.values = buf[4:4 + t.values.numel()].view(t.values.shape).copy_(t.values)
        assert t.values.data_ptr() % 16 == 4
    n0 = _kernels.launches["quant_attn_fwd"]
    out, lse = quantized_attention_forward(*qt, causal=True)
    torch.cuda.synchronize()
    assert _kernels.launches["quant_attn_fwd"] == n0 + 1
    _check(out, lse, *quantized_attention_forward_plain(*qt, causal=True), 1e-3, 1e-4)


@pytest.mark.parametrize("d", [260, 320])
def test_quant_attn_fwd_kernel_refuses_head_dim_over_256(dev, d):
    q, k, v = _qkv(1, 2, 1, 64, 64, d, torch.float32, dev)
    qt = [quantize(x) for x in (q, k, v)]
    n0 = _kernels.launches["quant_attn_fwd"]
    with pytest.raises(ValueError, match="head_dim <= 256"):
        quantized_attention_forward(*qt, causal=True)
    assert _kernels.launches["quant_attn_fwd"] == n0


def test_flash_bwd_kernels_refuse_what_they_do_not_take(dev):
    args, kw = _bwd_inputs((1, 2, 2, 64, 64, 264, False, None, None, False), torch.float32, dev)
    n0 = _kernels.launches["flash_bwd_dq"]
    with pytest.raises(ValueError, match="head_dim <= 256"):
        flash_attention_backward(*args, **kw)
    assert _kernels.launches["flash_bwd_dq"] == n0
    args, kw = _bwd_inputs((1, 2, 2, 64, 64, 64, False, None, None, False), torch.float32, dev)
    with pytest.raises(ValueError):
        flash_attention_backward(args[0], args[1].cpu(), *args[2:], **kw)


def test_flash_bwd_kernels_refuse_head_dims_over_their_limits(dev):
    # head_dim <= 256 for dQ, dK/dV and dbias, in bf16 and fp32; under it
    # (D 192, fp32) each kernel runs and meets its plain version.
    for dtype in (torch.bfloat16, torch.float32):
        (q, k, v, out, lse, do, bias, _), kw = _bwd_inputs(
            (1, 2, 2, 64, 64, 320, False, None, "bhqk", False), dtype, dev)
        with pytest.raises(ValueError, match="head_dim <= 256"):
            flash_attention_backward(q, k, v, out, lse, do, bias, **kw)
        with pytest.raises(ValueError, match="head_dim <= 256"):
            flash_attention_bias_grad(q, k, v, out, lse, do, bias, **kw)
    (q, k, v, out, lse, do, bias, _), kw = _bwd_inputs(
        (1, 2, 2, 64, 64, 192, False, None, "bhqk", False), torch.float32, dev)
    n0 = _kernels.launches["flash_dbias"]
    got = flash_attention_bias_grad(q, k, v, out, lse, do, bias, **kw)
    torch.cuda.synchronize()
    assert _kernels.launches["flash_dbias"] == n0 + 1
    assert rel_err(got, flash_attention_bias_grad_plain(q, k, v, out, lse, do, bias, **kw)) <= 1e-4
    n0 = _kernels.launches["flash_bwd_dkv"]
    flash_attention_backward(q, k, v, out, lse, do, bias, **kw)  # dQ, dK/dV take D 192
    torch.cuda.synchronize()
    assert _kernels.launches["flash_bwd_dkv"] == n0 + 1


# ---- Quantized training kernels (quant_rows, fused_qattn, quant_bwd) ----
#
# Gates, kernel against plain version on the same inputs (both on the card):
#   * quant_rows: codes and scales exactly equal without the rotation (the
#     same fp32 subtraction, exact divisions and rintf); with it codes at most
#     one apart, >= 99.9 % equal, scales relerr <= 1e-6 (both round a
#     float64 x·H to fp32 once, summed in other orders);
#   * fused_qattn: out relerr 1e-3, LSE abs 1e-4 (row 5's INT8 gates: both
#     sum the scores, the cc row and the means in double and round once, so
#     they exponentiate the same fp32 scores and round P to bf16 at the same
#     points; only l and P·V are summed in another order), residual codes
#     at most one apart and >= 99.9 % equal, qm/vm relerr 1e-6, rows with no
#     visible key exactly 0 with LSE -1e30;
#   * quant_bwd: fp32-emitted relerr 1e-4, bf16-emitted 2e-2 (BWD_TOLS),
#     rows with no visible key exactly 0.

from umfa_tpu_torch.engine.config import QuantizationConfig  # noqa: E402
from umfa_tpu_torch.ops.quant import unpack_int4  # noqa: E402
from umfa_tpu_torch.ops.quant_attention import (  # noqa: E402
    _corr_from_quantized,
    quantized_flash_attention,
)
from umfa_tpu_torch.ops.quant_bwd import (  # noqa: E402
    quantized_attention_backward,
    quantized_attention_backward_plain,
)
from umfa_tpu_torch.ops.quant_fused import (  # noqa: E402
    quantize_rows_fused,
    quantize_rows_fused_plain,
)
from umfa_tpu_torch.ops.quant_fused_attn import (  # noqa: E402
    fused_quantize_attend,
    fused_quantize_attend_plain,
)

RECIPES = {
    "int8": dict(q_precision=Precision.INT8, k_precision=Precision.INT8,
                 v_precision=Precision.INT8, smooth=True, smooth_q=False),
    "int4": dict(q_precision=Precision.INT4, k_precision=Precision.INT4,
                 v_precision=Precision.INT8, smooth=True, smooth_q=True, hadamard=True),
    "int8_nosmooth": dict(q_precision=Precision.INT8, k_precision=Precision.INT8,
                          v_precision=Precision.INT8, smooth=False),
    "int8_smooth_q": dict(q_precision=Precision.INT8, k_precision=Precision.INT8,
                          v_precision=Precision.INT8, smooth=True, smooth_q=True),
    "qdense": dict(q_precision=Precision.BF16, k_precision=Precision.INT8,
                   v_precision=Precision.INT8, smooth=True),
}
# BLOCK and ASYMMETRIC (row 7's pre-pass: every operand quantized by
# fused_rows_kernel and fused_group_quant_kernel, Q then read as bf16).
_BLOCK = dict(mode=QuantMode.BLOCK)
_ASYM = dict(strategy=QuantStrategy.ASYMMETRIC)
RECIPES.update({
    "int8_block": dict(RECIPES["int8"], **_BLOCK),
    "int4_block": dict(RECIPES["int4"], **_BLOCK),
    "int8_asym": dict(RECIPES["int8"], **_ASYM),
    "int4_asym": dict(RECIPES["int4"], **_ASYM),
    "int8_asym_block_smooth_q": dict(RECIPES["int8_smooth_q"], **_ASYM, **_BLOCK),
    "qdense_asym": dict(RECIPES["qdense"], **_ASYM),
    "int8_nosmooth_asym_block": dict(RECIPES["int8_nosmooth"], **_ASYM, **_BLOCK),
})


def _codes(qt):
    return (unpack_int4(qt.values) if qt.precision == Precision.INT4 else qt.values).int()


def _codes_close(a, b):
    diff = (_codes(a) - _codes(b)).abs()
    return diff.max().item() <= 1 and (diff == 0).float().mean().item() >= 0.999


def _quant_rows_cases(ds, dtypes):
    """(precision, hadamard, dtype, d) the quantizer takes: INT4 needs an
    even head_dim, the rotation a power of two."""
    for d in ds:
        for dtype in dtypes:
            for hadamard in (False, True):
                for precision in (Precision.INT8, Precision.INT4):
                    if (precision == Precision.INT4 and d % 2) or (hadamard and d & (d - 1)):
                        continue
                    yield pytest.param(precision, hadamard, dtype, d,
                                       id=f"{d}-{str(dtype)[6:]}-{hadamard}-{precision.value}")


def _check_quant_rows(x, mean, precision, hadamard):
    n0 = _kernels.launches["quant_rows"]
    got = quantize_rows_fused(x, mean, precision=precision, hadamard=hadamard)
    torch.cuda.synchronize()
    assert _kernels.launches["quant_rows"] == n0 + 1
    want = quantize_rows_fused_plain(x, mean, precision=precision, hadamard=hadamard)
    assert got.values.shape == want.values.shape and got.scales.shape == want.scales.shape
    if hadamard:
        assert _codes_close(got, want)
        assert rel_err(got.scales, want.scales) <= 1e-6
    else:
        assert torch.equal(got.values, want.values) and torch.equal(got.scales, want.scales)


def _rows_input(shape, dtype, dev, offset=0, seed=4):
    """Seeded rows (+0.3, so the mean matters), as a view `offset` elements
    into its storage."""
    g = torch.Generator().manual_seed(seed)
    flat = (torch.randn((math.prod(shape) + offset,), generator=g) + 0.3).to(dev, dtype)
    return flat[offset:].view(shape)


# Every D from 1 to 256 the kernel's load widths and lane groups differ at:
# 16-byte loads (D % 8 == 0 in bf16, % 4 in fp32: 32, 48, 64, 72, 128, 256)
# and element loads (1, 255), one lane a row (1) up to 32 (255, 256); fp16
# is read as fp32.
@pytest.mark.parametrize("precision,hadamard,dtype,d", list(_quant_rows_cases(
    (1, 32, 48, 64, 72, 128, 255, 256), (torch.float32, torch.bfloat16, torch.float16))))
def test_quant_rows_kernel_matches_plain(dev, precision, hadamard, dtype, d):
    x = _rows_input((2, 3, 333, d), dtype, dev)
    mean = x.float().mean(dim=2, keepdim=True)
    _check_quant_rows(x, mean, precision, hadamard)


@pytest.mark.parametrize("precision,hadamard,dtype,d", list(_quant_rows_cases(
    (1, 64, 72, 255, 256), (torch.float32, torch.bfloat16))))
def test_quant_rows_kernel_without_mean(dev, precision, hadamard, dtype, d):
    _check_quant_rows(_rows_input((2, 3, 333, d), dtype, dev), None, precision, hadamard)


# Storage offsets (in elements) that break the rows' 16-byte alignment: the
# narrower-load variants (8-, 4- and 2-byte and element loads), with and
# without the mean, which is passed one float off its own alignment too.
@pytest.mark.parametrize("dtype,offset", [(torch.float32, 1), (torch.float32, 2),
                                          (torch.float32, 3), (torch.bfloat16, 1),
                                          (torch.bfloat16, 2), (torch.bfloat16, 4)])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_quant_rows_kernel_unaligned(dev, dtype, offset, d):
    x = _rows_input((2, 3, 333, d), dtype, dev, offset=offset)
    assert x.data_ptr() % 16
    mean = torch.empty((2 * 3 * d + 1,), device=dev)[1:].view(2, 3, 1, d)
    mean.copy_(x.float().mean(dim=2, keepdim=True))
    for precision in (Precision.INT8, Precision.INT4):
        for hadamard in (False, True):
            _check_quant_rows(x, mean, precision, hadamard)
            _check_quant_rows(x, None, precision, hadamard)


FUSED_KERNEL_CASES = [
    # (b, hq, hkv, sq, sk, d, recipe, kwargs)
    (2, 4, 2, 320, 320, 64, "int8", dict(causal=True)),
    (2, 4, 2, 320, 320, 64, "int4", dict(causal=True)),
    (1, 4, 2, 777, 777, 32, "int8", {}),                    # odd length, D 32
    (1, 4, 4, 300, 300, 128, "int4", dict(window=(128, 0))),  # D 128: fp32 row sum
    (2, 2, 1, 200, 200, 64, "int8_nosmooth", dict(bias="11qk")),
    (1, 4, 2, 256, 256, 64, "qdense", dict(causal=True)),
    (1, 4, 2, 512, 128, 64, "int8", dict(window=(64, -1))),  # rows past 192 see no key
    (1, 4, 2, 300, 300, 128, "int8_smooth_q", dict(causal=True, bias="11qk")),  # the cc row, D 128
    (1, 8, 2, 333, 333, 48, "int8", dict(causal=True)),       # D 48 padded to 64, GQA 4
    (1, 4, 2, 200, 257, 64, "int8", {}),                      # a KV tail: Sk 257
    (1, 4, 2, 256, 256, 128, "int8_nosmooth", dict(causal=True)),
    # D 256: bf16 Q tile, 32-key tiles (and D 200 padded to it)
    (1, 4, 2, 300, 300, 256, "int8", dict(causal=True)),
    (1, 4, 2, 200, 200, 256, "int4", dict(window=(128, 0))),
    (1, 4, 2, 300, 300, 256, "int8_smooth_q", dict(causal=True, bias="11qk")),
    (1, 4, 2, 256, 256, 256, "qdense", dict(causal=True)),
    (1, 8, 2, 333, 257, 200, "int8", {}),
]


# K̃/Ṽ rows the attention cannot copy in 16-byte pieces: an odd D (element
# loads) and D % 8 == 4 (4-byte copies), the latter with the cc row.
FUSED_COPY_CASES = [
    (1, 4, 2, 200, 200, 33, "int8", dict(causal=True)),
    (1, 4, 2, 150, 150, 36, "int8_smooth_q", {}),
]


def _fused_inputs(case, dtype, dev):
    b, hq, hkv, sq, sk, d, recipe, kw = case
    q, k, v = _qkv(b, hq, hkv, sq, sk, d, dtype, dev, seed=5)
    kw = dict(kw)
    if kw.pop("bias", None):
        g = torch.Generator().manual_seed(6)
        kw["bias"] = torch.randn((1, 1, sq, sk), generator=g).to(dev)
    return (q, k + 0.5, v + 0.3), dict(kw, **RECIPES[recipe])


def _check_fused(got, want, check_out=True, walked=False):
    out, lse = got[0].float(), got[1]
    w_out, w_lse = want[0].float(), want[1]
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    if check_out:
        assert rel_err(out, w_out) <= 1e-3
        vis = w_lse > -1e29
        if vis.any():
            assert (lse[vis] - w_lse[vis]).abs().max().item() <= 1e-4
        assert (lse[~vis] == -1e30).all()
        if walked:
            # A row that sees no key inside its walked tiles averages their
            # keys (plus vm), at the same gate; one that walks none is 0.
            empty = ~vis & (w_out == 0).all(dim=-1)
            blind = ~vis & ~empty
            assert (out[empty] == 0).all()
            if blind.any():
                assert rel_err(out[blind], w_out[blind]) <= 1e-3
        else:
            assert (out[~vis] == 0).all()
    for a, b_ in zip(got[2:5], want[2:5]):
        assert (a is None) == (b_ is None)
        if a is not None:
            assert _codes_close(a, b_) and rel_err(a.scales, b_.scales) <= 1e-5
            assert (a.mode, a.strategy, a.block_size) == (b_.mode, b_.strategy, b_.block_size)
            assert (a.zero_points is None) == (b_.zero_points is None)
            if a.zero_points is not None:
                diff = (a.zero_points - b_.zero_points).abs()
                assert diff.max().item() <= 1 and (diff == 0).float().mean().item() >= 0.999
    for a, b_ in zip(got[5:], want[5:]):
        assert (a is None) == (b_ is None)
        if a is not None:
            assert rel_err(a, b_) <= 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FUSED_KERNEL_CASES + FUSED_COPY_CASES)
def test_fused_qattn_kernel_matches_plain(dev, dtype, case):
    (q, k, v), kw = _fused_inputs(case, dtype, dev)
    n0 = _kernels.launches["fused_qattn"]
    got = fused_quantize_attend(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _kernels.launches["fused_qattn"] == n0 + 1
    want = fused_quantize_attend_plain(q, k, v, **kw)
    assert got[0].dtype == dtype
    _check_fused(got, want)
    bare = fused_quantize_attend(q, k, v, emit_residuals=False, **kw)
    assert bare[2:] == (None,) * 5 and torch.equal(bare[0], got[0])


@pytest.mark.parametrize("recipe", ["int8", "int4"])
def test_fused_qattn_kernel_keeps_the_score_bits(dev, recipe):
    # Causal S 1024 with q ~ N(0, 3): short causal rows where fp32 score
    # sums in another order flipped bf16(P) elements (LSE ~1e-3 off). The
    # kernel's scores are the plain version's exact double sums rounded
    # once, so the LSE stays ten times under the 1e-4 gate.
    _check_score_bits(dev, recipe, 64)


# The same at D 256: 256 products a score, still exact in double.
@pytest.mark.parametrize("recipe", ["int8", "int4"])
def test_fused_qattn_kernel_keeps_the_score_bits_at_d256(dev, recipe):
    _check_score_bits(dev, recipe, 256)


def _check_score_bits(dev, recipe, d):
    g = torch.Generator().manual_seed(11)
    q = (3 * torch.randn((2, 4, 1024, d), generator=g)).to(dev, torch.bfloat16)
    k, v = (torch.randn((2, 2, 1024, d), generator=g).to(dev, torch.bfloat16) for _ in "kv")
    kw = dict(causal=True, **RECIPES[recipe])
    n0 = _kernels.launches["fused_qattn"]
    got = fused_quantize_attend(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _kernels.launches["fused_qattn"] == n0 + 1
    want = fused_quantize_attend_plain(q, k, v, **kw)
    vis = want[1] > -1e29
    assert vis.all()
    assert (got[1] - want[1]).abs().max().item() <= 1e-5
    _check_fused(got, want)


# Row 7's BLOCK and ASYMMETRIC recipes at D 64, 128 and 256 and an odd D
# (INT8 only there: INT4 and the rotation need an even, a power-of-two D),
# held to the gates of the symmetric ROW cases (`_check_fused`), with the
# zero points at most one apart. S 200 and 333 leave the last group of 64
# (K, V) and 128 (Q) rows short: the reference's zero-padded rows count.
FUSED_VARIANT_CASES = [
    (b, hq, hkv, sq, sq, d, recipe, kw)
    for d in (64, 128, 256, 33)
    for recipe, (b, hq, hkv, sq), kw in (
        ("int8_block", (2, 4, 2, 333), dict(causal=True)),
        ("int4_block", (1, 4, 2, 200), dict(window=(128, 0))),
        ("int8_asym", (2, 4, 2, 200), dict(causal=True)),
        ("int4_asym", (1, 4, 2, 333), dict(causal=True, bias="11qk")),
        ("int8_asym_block_smooth_q", (1, 8, 2, 200), {}),
        ("qdense_asym", (1, 4, 2, 256), dict(causal=True)),
        ("int8_nosmooth_asym_block", (1, 4, 4, 333), dict(window=(64, -1))),
    )
    if d % 2 == 0 or "int4" not in recipe
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FUSED_VARIANT_CASES)
def test_fused_qattn_kernel_block_and_asym_match_plain(dev, dtype, case):
    (q, k, v), kw = _fused_inputs(case, dtype, dev)
    n0 = _kernels.launches["fused_qattn"]
    got = fused_quantize_attend(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _kernels.launches["fused_qattn"] == n0 + 1
    want = fused_quantize_attend_plain(q, k, v, **kw)
    _check_fused(got, want)
    bare = fused_quantize_attend(q, k, v, emit_residuals=False, **kw)
    assert bare[2:] == (None,) * 5 and torch.equal(bare[0], got[0])


# The score bits of the FP64 QKᵀ under BLOCK and ASYMMETRIC (code − zp
# spans up to 256 steps; csrc/fused_qattn.cu's header): LSE within 1e-5.
@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("recipe", ["int8_block", "int8_asym", "int4_asym"])
def test_fused_qattn_block_and_asym_keep_the_score_bits(dev, recipe, d):
    _check_score_bits(dev, recipe, d)


# Rows 8-9 on BLOCK residuals (a group's scale on every row of it).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(2, 4, 2, 333, 333, 64, "int8_block", dict(causal=True)),
                                  (1, 4, 2, 200, 200, 128, "int4_block", dict(causal=True))])
def test_quant_bwd_kernels_on_block_residuals(dev, dtype, case):
    test_quant_bwd_kernels_match_plain(dev, dtype, case)


def _qbwd_inputs(case, dtype, dev):
    (q, k, v), kw = _fused_inputs(case, dtype, dev)
    out, lse, qt_q, qt_k, qt_v, qm, vm = fused_quantize_attend_plain(q, k, v, **kw)
    g = torch.Generator().manual_seed(7)
    do = torch.randn(out.shape, generator=g).to(dev, out.dtype)
    dlse = torch.randn(lse.shape, generator=g).to(dev)
    corr = None if qm is None else _corr_from_quantized(qm, qt_k)
    mask = dict(causal=kw.get("causal", False), window=kw.get("window"))
    return (qt_q, qt_k, qt_v, out, lse, do, qm, vm, corr, kw.get("bias"), dlse), mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [c for c in FUSED_KERNEL_CASES if c[6] != "qdense"])
def test_quant_bwd_kernels_match_plain(dev, dtype, case):
    args, mask = _qbwd_inputs(case, dtype, dev)
    gdt = torch.bfloat16 if dtype == torch.bfloat16 else None
    n_dq, n_dkv = _kernels.launches["quant_bwd_dq"], _kernels.launches["quant_bwd_dkv"]
    got = quantized_attention_backward(*args, grad_dtype=gdt, **mask)
    torch.cuda.synchronize()
    assert _kernels.launches["quant_bwd_dq"] == n_dq + 1
    assert _kernels.launches["quant_bwd_dkv"] == n_dkv + 1
    want = quantized_attention_backward_plain(*args, grad_dtype=gdt, **mask)
    for g_, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g_.dtype == w.dtype == (gdt or torch.float32), name
        assert torch.isfinite(g_.float()).all(), name
        assert rel_err(g_, w) <= BWD_TOLS[dtype], name
    empty = args[4] <= -1e29
    if empty.any():
        assert (got[0][empty] == 0).all()


# The tensor-core dQ and dK/dV kernels at D 32/64/128/256 under both
# recipes (int4: Q and K codes packed, the Q mean qm and its score row corr;
# int8: the V mean vm), with 64 rows of LSE -1e30 (gradients exactly 0), a
# nonzero dlse and fp32 or bf16 dO. Sq 257 and 130 leave tiles ragged; Sq
# 257 (not a multiple of 4) takes the dK/dV kernel's plain loads instead of
# cp.async, Sk 257 the dQ kernel's. D 256 runs the dK/dV body with two warps
# per key group (each owning half of dK's and dV's columns).
# Gates: bf16 2e-2 (BWD_TOLS); fp32 dV 1e-4 and dQ, dK 3e-4. bf16(dS) is
# rounded from dS = P∘(dP − δ), whose cancellation turns the last-bit
# differences of two fp32 summation orders into elements rounded the other
# way, relerr of the order of 1e-4 (on one of these cases the CUDA-core dQ
# kernel this one replaced missed 1e-4 against the plain version, as does
# the tensor-core dK on another).
QBWD_DKV_FP32 = {"dq": 3e-4, "dk": 3e-4, "dv": 1e-4}
QBWD_DKV_CASES = [  # (sq, sk, d, recipe, kwargs)
    (200, 200, 32, "int8", dict(causal=True)),
    (200, 200, 64, "int4", dict(causal=True)),
    (130, 257, 128, "int8", dict(causal=True)),
    (257, 130, 64, "int8", dict(window=(40, 8))),
    (256, 256, 128, "int4", dict(window=(128, 0))),
    (96, 320, 32, "int4", {}),
    (200, 200, 256, "int8", dict(causal=True)),
    (130, 257, 256, "int4", dict(window=(40, 8))),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", QBWD_DKV_CASES)
def test_quant_bwd_dkv_kernel_masked_rows_and_means(dev, dtype, case):
    sq, sk, d, recipe, kw = case
    args, mask = _qbwd_inputs((1, 4, 2, sq, sk, d, recipe, kw), dtype, dev)
    lse = args[4].clone()
    lse[:, :, :64] = -1e30
    args = args[:4] + (lse,) + args[5:]
    gdt = torch.bfloat16 if dtype == torch.bfloat16 else None
    n_dq, n_dkv = _kernels.launches["quant_bwd_dq"], _kernels.launches["quant_bwd_dkv"]
    got = quantized_attention_backward(*args, grad_dtype=gdt, **mask)
    torch.cuda.synchronize()
    assert _kernels.launches["quant_bwd_dq"] == n_dq + 1
    assert _kernels.launches["quant_bwd_dkv"] == n_dkv + 1
    want = quantized_attention_backward_plain(*args, grad_dtype=gdt, **mask)
    for g_, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g_.dtype == w.dtype == (gdt or torch.float32), name
        assert torch.isfinite(g_.float()).all(), name
        tol = QBWD_DKV_FP32[name] if dtype == torch.float32 else BWD_TOLS[dtype]
        assert rel_err(g_, w) <= tol, name
    assert (got[0][:, :, :64] == 0).all()


def test_quant_bwd_kernels_refuse_head_dim_over_256(dev):
    args, mask = _qbwd_inputs((1, 2, 1, 64, 64, 320, "int8", dict(causal=True)),
                              torch.float32, dev)
    with pytest.raises(ValueError, match="head_dim <= 256"):
        quantized_attention_backward(*args, **mask)


def test_quantized_training_on_the_card_matches_the_cpu(dev):
    g = torch.Generator().manual_seed(8)
    q, k, v = (torch.randn(s, generator=g) for s in ((2, 4, 160, 64), (2, 2, 160, 64),
                                                    (2, 2, 160, 64)))
    bias = torch.randn((1, 4, 160, 160), generator=g)
    for recipe in ("int8", "int4"):
        cfg = QuantizationConfig.from_mode_string(recipe)
        grads = {}
        for where in ("cuda", "cpu"):
            t = [x.to(where, copy=True).requires_grad_(True) for x in (q, k, v, bias)]
            out = quantized_flash_attention(*t[:3], t[3], config=cfg, causal=True, bias_grad=True)
            out.square().sum().backward()
            grads[where] = [x.grad.cpu() for x in t]
        for a, b_, name in zip(grads["cuda"], grads["cpu"], ("dq", "dk", "dv", "dbias")):
            assert rel_err(a, b_) <= 1e-2, (recipe, name)


# The recipes this slice opened, through quantized_flash_attention on the
# card against the CPU, forward and backward: fused BLOCK and ASYMMETRIC
# (the ASYMMETRIC backward is the fp32 dense backward on the dequantized
# operands), and on the two-pass route the int4 recipe (INT4 Q/K, the
# Q-mean row), ASYMMETRIC and BLOCK; each with its launches.
QVARIANT_ROUTES = [  # (recipe, mode, asymmetric, two-pass, launches of one call)
    ("int8", "block", False, False, {"fused_qattn": 1, "quant_bwd_dq": 1}),
    ("int8", "row", True, False, {"fused_qattn": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}),
    ("int4", "row", False, True, {"quant_rows": 3, "quant_attn_fwd": 1, "quant_bwd_dq": 1}),
    ("int8", "row", True, True, {"quant_attn_fwd": 1, "flash_bwd_dq": 1, "quant_rows": 0}),
    ("int8", "block", False, True, {"quant_attn_fwd": 1, "quant_bwd_dkv": 1, "fused_qattn": 0}),
]


@pytest.mark.parametrize("route", QVARIANT_ROUTES, ids=lambda r: f"{r[0]}-{r[1]}-{r[2]}-{r[3]}")
def test_quantized_variants_on_the_card_match_the_cpu(dev, monkeypatch, route):
    recipe, mode, asym, two_pass, launches = route
    if two_pass:
        monkeypatch.setenv("UMFA_DISABLE_FUSED_QUANT", "1")
    cfg = QuantizationConfig.from_mode_string(recipe, mode)
    if asym:
        cfg = dataclasses.replace(cfg, strategy=QuantStrategy.ASYMMETRIC)
    g = torch.Generator().manual_seed(10)
    q, k, v = (torch.randn(s, generator=g) for s in ((2, 4, 200, 64), (2, 2, 200, 64),
                                                    (2, 2, 200, 64)))
    got = {}
    for where in ("cuda", "cpu"):
        t = [x.to(where, copy=True).requires_grad_(True) for x in (q, k, v)]
        before = dict(_kernels.launches)
        out = quantized_flash_attention(*t, config=cfg, causal=True)
        out.square().sum().backward()
        if where == "cuda":
            torch.cuda.synchronize()
            ran = {key: _kernels.launches[key] - before.get(key, 0) for key in launches}
            assert ran == launches, ran
        got[where] = [out.detach().cpu()] + [x.grad.cpu() for x in t]
    for a, b_, name in zip(got["cuda"], got["cpu"], ("out", "dq", "dk", "dv")):
        assert rel_err(a, b_) <= 1e-2, name


def test_quantized_attention_two_pass_at_head_dim_256_on_the_card(dev, monkeypatch):
    # Both routes take head_dim 256: the fused route (fused_qattn, then the
    # quantized backward), then the two-pass one (quant_rows,
    # quant_attn_fwd, then the quantized backward), each against the CPU.
    g = torch.Generator().manual_seed(9)
    q, k, v = (torch.randn(s, generator=g) for s in ((1, 4, 130, 256), (1, 2, 130, 256),
                                                    (1, 2, 130, 256)))
    cfg = QuantizationConfig.from_mode_string("int8")
    for route, kernel in (("fused", "fused_qattn"), ("two_pass", "quant_attn_fwd")):
        if route == "two_pass":
            monkeypatch.setenv("UMFA_DISABLE_FUSED_QUANT", "1")
        got = {}
        for where in ("cuda", "cpu"):
            t = [x.to(where, copy=True).requires_grad_(True) for x in (q, k, v)]
            n0 = _kernels.launches[kernel]
            out = quantized_flash_attention(*t, config=cfg, causal=True)
            assert _kernels.launches[kernel] == n0 + (where == "cuda"), route
            out.square().sum().backward()
            got[where] = [out.detach().cpu()] + [x.grad.cpu() for x in t]
        for a, b_, name in zip(got["cuda"], got["cpu"], ("out", "dq", "dk", "dv")):
            assert rel_err(a, b_) <= 1e-2, (route, name)


# Row 10: flash-decode over the INT8 cache (csrc/flash_decode.cu, one
# launch: the splits of a row group are the blocks of a cluster and merge
# inside it), against its plain tile walk. fp32 relerr 2e-5 (same
# arithmetic, other summation order); bf16 relerr 1e-2 (the kernel rounds
# bf16(p·vs) against the running maximum of its own walk, the plain walk
# against the tile walk's).

import os  # noqa: E402

from umfa_tpu_torch.serving import decode_kernel as dk  # noqa: E402
from umfa_tpu_torch.serving.decode import decode_attention  # noqa: E402
from umfa_tpu_torch.serving.kv_cache import QuantizedKVCache  # noqa: E402

DECODE_TOLS = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
DECODE_CASES = [  # (hq, hkv, tq, d, s_max, block_k)
    (hq, hkv, tq, d, s_max, bk)
    for hq, hkv in ((16, 8), (8, 8))
    for tq in (1, 4, 16)
    for d in (64, 128)
    for s_max, bk in ((4096, 2048), (768, 256))
]


def _decode_inputs(hq, hkv, tq, d, s_max, dtype, dev, seed=0, lengths=None):
    """A 4-slot INT8 cache at lengths S_max, 1, 0 and S_max/3 + 5 (or the
    given ones), and the decode route's length-and-causal bias (query t at
    length - Tq + t)."""
    g = torch.Generator().manual_seed(seed)
    lengths = torch.tensor(lengths or [s_max, 1, 0, s_max // 3 + 5])
    b = len(lengths)
    k = torch.randint(-128, 128, (b, hkv, s_max, d), generator=g, dtype=torch.int8)
    v = torch.randint(-128, 128, (b, hkv, s_max, d), generator=g, dtype=torch.int8)
    ks = torch.rand((b, hkv, s_max, 1), generator=g) * 0.05 + 1e-3
    vs = torch.rand((b, hkv, s_max, 1), generator=g) * 0.05 + 1e-3
    pos = torch.arange(s_max)
    qpos = lengths[:, None] - tq + torch.arange(tq)
    masked = (pos > qpos[:, :, None]) | (pos >= lengths[:, None, None])
    bias = torch.where(masked, -1e30, 0.0)[:, None]
    q = torch.randn((b, hq, tq, d), generator=g)
    return (q.to(dev, dtype), *(x.to(dev) for x in (k, ks, v, vs, bias)), lengths.to(dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_flash_decode_kernel_matches_plain(dev, dtype, case):
    hq, hkv, tq, d, s_max, bk = case
    q, k, ks, v, vs, bias, _ = _decode_inputs(hq, hkv, tq, d, s_max, dtype, dev)
    n0 = _kernels.launches["flash_decode"]
    out = dk.quantized_flash_decode(q, k, ks, v, vs, bias, block_k=bk)
    torch.cuda.synchronize()
    assert _kernels.launches["flash_decode"] == n0 + 1  # one launch, the merge inside it
    assert "flash_decode_merge" not in _kernels.launches
    want = dk.quantized_flash_decode_plain(q, k, ks, v, vs, bias, block_k=bk)
    assert out.dtype == torch.float32 and out.shape == (4, hq, tq, d)
    assert torch.isfinite(out).all()
    assert rel_err(out, want) <= DECODE_TOLS[dtype]


# The cluster's edges: S_max 64 (the first split's 16 rows a block, five
# of the eight splits empty), Hkv 1 at Tq 16 (256 query rows: eight row
# groups of 32, each its own cluster; 16 at D 256), and slots of length 0
# (every split sees only the -1e30 bias: V averaged uniformly over all of
# them) beside full ones.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    (16, 8, 1, 64, 64, 64, None), (16, 8, 16, 64, 64, 64, None),
    (16, 1, 16, 64, 768, 256, None), (16, 1, 16, 128, 768, 256, None),
    (16, 1, 16, 256, 768, 256, None), (16, 1, 1, 64, 4096, 2048, None),
    (16, 8, 1, 64, 4096, 2048, [0, 4096, 0, 4096]), (8, 8, 4, 128, 768, 256, [768, 0, 0, 768]),
], ids=["s64_tq1", "s64_tq16", "mqa_tq16_d64", "mqa_tq16_d128", "mqa_tq16_d256", "mqa_tq1",
        "empty_slots_s4096", "empty_slots_d128"])
def test_flash_decode_kernel_cluster_edges(dev, dtype, case):
    hq, hkv, tq, d, s_max, bk, lengths = case
    q, k, ks, v, vs, bias, _ = _decode_inputs(hq, hkv, tq, d, s_max, dtype, dev, seed=2,
                                              lengths=lengths)
    n0 = _kernels.launches["flash_decode"]
    out = dk.quantized_flash_decode(q, k, ks, v, vs, bias, block_k=bk)
    torch.cuda.synchronize()
    assert _kernels.launches["flash_decode"] == n0 + 1
    want = dk.quantized_flash_decode_plain(q, k, ks, v, vs, bias, block_k=bk)
    assert torch.isfinite(out).all() and rel_err(out, want) <= DECODE_TOLS[dtype]
    for slot in [i for i, n in enumerate(lengths or []) if n == 0]:
        # Every cache row at -1e30: out is the mean of cdt(vs)·v over S_max rows.
        cdt = torch.float32 if dtype == torch.float32 else torch.bfloat16
        mean = (vs[slot].to(cdt).float() * v[slot].float()).mean(dim=1)  # (Hkv, D)
        got = out[slot].reshape(hkv, hq // hkv * tq, d)
        assert rel_err(got, mean[:, None].expand_as(got)) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tq", [1, 16])
def test_flash_decode_kernel_is_deterministic(dev, dtype, tq):
    # The splits merge in a fixed order, with no atomics: the same bits twice.
    q, k, ks, v, vs, bias, _ = _decode_inputs(16, 8, tq, 64, 4096, dtype, dev, seed=3)
    first = dk.quantized_flash_decode(q, k, ks, v, vs, bias)
    again = dk.quantized_flash_decode(q, k, ks, v, vs, bias)
    assert torch.equal(first, again)


def test_flash_decode_kernel_broadcast_bias_and_odd_length(dev):
    # A (B, 1, 1, S) bias broadcast over Tq 4, S_max 1000 (splits of 128
    # rows, the last of 104; stages of 64 rows and a partial one), D 32 and 80.
    for d in (32, 80):
        q, k, ks, v, vs, bias, _ = _decode_inputs(4, 2, 4, d, 1000, torch.float32, dev, seed=1)
        bias = bias[:, :, -1:]
        out = dk.quantized_flash_decode(q, k, ks, v, vs, bias, block_k=1000)
        want = dk.quantized_flash_decode_plain(q, k, ks, v, vs, bias, block_k=1000)
        assert torch.isfinite(out).all() and rel_err(out, want) <= 2e-5


def test_decode_attention_switch_launches_the_kernel(dev):
    q, k, ks, v, vs, _, lengths = _decode_inputs(16, 8, 1, 64, 768, torch.bfloat16, dev)
    cache = QuantizedKVCache(k, ks, v, vs, lengths.int())
    n0 = _kernels.launches["flash_decode"]
    os.environ["UMFA_ENABLE_DECODE_KERNEL"] = "1"
    try:
        out = decode_attention(q, cache)
    finally:
        del os.environ["UMFA_ENABLE_DECODE_KERNEL"]
    gemv = decode_attention(q, cache)
    torch.cuda.synchronize()
    assert _kernels.launches["flash_decode"] == n0 + 1
    assert out.dtype == torch.bfloat16 and rel_err(out, gemv) <= 1e-2


def test_flash_decode_kernel_refuses_what_it_does_not_take(dev):
    q, k, ks, v, vs, bias, _ = _decode_inputs(4, 2, 1, 64, 768, torch.float32, dev)
    with pytest.raises(ValueError):  # a non-int8 cache
        dk.quantized_flash_decode(q, k.float(), ks, v.float(), vs, bias)
    with pytest.raises(ValueError):  # CPU tensors beside CUDA ones
        dk.quantized_flash_decode(q, k.cpu(), ks, v, vs, bias)
    q17, _, _, _, _, bias17, _ = _decode_inputs(4, 2, 17, 64, 768, torch.float32, dev)
    with pytest.raises(ValueError):  # more than 16 new queries
        dk.quantized_flash_decode(q17, k, ks, v, vs, bias17)
    q2, k2, ks2, v2, vs2, bias2, _ = _decode_inputs(4, 2, 1, 320, 768, torch.float32, dev)
    with pytest.raises(ValueError, match="head_dim <= 256"):
        dk.quantized_flash_decode(q2, k2, ks2, v2, vs2, bias2)


# Head dims the 64 and 128 templates do not cover, or whose cache rows are
# not 16-byte aligned: 192 and 256 (the 256 template, two P·V columns a
# thread), 72 (4-byte copies), 33 (byte loads); at the gates above.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [192, 256, 72, 33])
def test_flash_decode_kernel_takes_any_head_dim(dev, dtype, d):
    for hq, tq in ((16, 1), (8, 16)):
        q, k, ks, v, vs, bias, _ = _decode_inputs(hq, 8, tq, d, 768, dtype, dev)
        n0 = _kernels.launches["flash_decode"]
        out = dk.quantized_flash_decode(q, k, ks, v, vs, bias, block_k=256)
        torch.cuda.synchronize()
        assert _kernels.launches["flash_decode"] == n0 + 1
        want = dk.quantized_flash_decode_plain(q, k, ks, v, vs, bias, block_k=256)
        assert torch.isfinite(out).all() and rel_err(out, want) <= DECODE_TOLS[dtype]


# ---- ring attention (csrc/ring_attn.cu) and the tensor-core probe ----------
#
# The whole ring with its kernels (`ring_fwd_step`, `ring_bwd_dkv`,
# `ring_bwd_dq`) against the same ring with their plain versions, both on
# the card over LocalRing: forward fp32 relerr 2e-5 / LSE 1e-5, bf16 1e-2 /
# 1e-3 (both round P against the same block_k max and o after every step;
# fp32 sums in another order); backward fp32 1e-4, bf16 2e-2 (the fp32
# gradients of bf16 operands, rounded at the same points).

from umfa_tpu_torch.parallel import LocalRing  # noqa: E402
from umfa_tpu_torch.parallel import ring_pallas as rp  # noqa: E402
from umfa_tpu_torch.utils import mma_probe as mp  # noqa: E402

RING_FWD_TOLS = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (1e-2, 1e-3)}
RING_BWD_TOLS = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
RING_LAYOUTS = {"causal": (True, False), "zigzag": (True, True), "full": (False, False)}
RING_CASES = [  # (hq, hkv, n, d, layout); S 1024, batch 2
    (hq, hkv, n, d, layout)
    for hq, hkv in ((16, 8), (8, 8))
    for n in (4, 2)
    for d in (64, 128)
    for layout in RING_LAYOUTS
]


def _ring_inputs(hq, hkv, d, dtype, dev, seq=1024, seed=0):
    g = torch.Generator().manual_seed(seed)
    shapes = ((2, hq, seq, d), (2, hkv, seq, d), (2, hkv, seq, d), (2, hq, seq, d), (2, hq, seq))
    q, k, v, do, dlse = (torch.randn(s, generator=g) for s in shapes)
    return [x.to(dev, dtype) for x in (q, k, v, do)] + [dlse.to(dev)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", RING_CASES)
def test_ring_kernels_match_plain(dev, dtype, case):
    hq, hkv, n, d, layout = case
    causal, zigzag = RING_LAYOUTS[layout]
    q, k, v, do, dlse = _ring_inputs(hq, hkv, d, dtype, dev)
    cfg = rp._config(1024 // n, causal, zigzag, d**-0.5, None)
    before = dict(_kernels.launches)
    out, lse = rp._ring_fwd(q, k, v, LocalRing(n), cfg)
    grads = rp._ring_bwd(q, k, v, out, lse, do, dlse, LocalRing(n), cfg)
    torch.cuda.synchronize()
    steps = n * (n + 1) // 2 if layout == "causal" else n * n
    for name in ("ring_fwd_step", "ring_bwd_dkv", "ring_bwd_dq"):
        assert _kernels.launches[name] == before.get(name, 0) + steps
    want, want_lse = rp._ring_fwd(q, k, v, LocalRing(n), cfg, plain=True)
    rtol, ltol = RING_FWD_TOLS[dtype]
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert rel_err(out, want) <= rtol
    assert (lse - want_lse).abs().max().item() <= ltol
    want_grads = rp._ring_bwd(q, k, v, out, lse, do, dlse, LocalRing(n), cfg, plain=True)
    for got, ref in zip(grads, want_grads):
        assert torch.isfinite(got).all() and rel_err(got, ref) <= RING_BWD_TOLS[dtype]


def test_ring_backward_routes_agree(dev, monkeypatch):
    q, k, v, do, dlse = _ring_inputs(16, 8, 64, torch.float32, dev)
    leaves = [[x.clone().requires_grad_(True) for x in (q, k, v)] for _ in range(2)]
    for i, route in enumerate(("pallas", "jnp")):
        monkeypatch.setenv("UMFA_RING_BWD", route)
        out, lse = rp.ring_flash_attention_pallas(*leaves[i], ring=LocalRing(4), causal=True,
                                                  return_lse=True)
        ((out * do).sum() + (lse * dlse).sum()).backward()
    for a, b in zip(*leaves):
        assert rel_err(a.grad, b.grad) <= 2e-5


SLEEP_CYCLES = 20_000_000  # ~10 ms at the H100's clock


class _SlowCopies(LocalRing):
    """Every hop waits on the side stream behind a sleep kernel."""

    def send(self, bufs, cur, nxt, senders, tag):
        with torch.cuda.stream(self._side):
            torch.cuda._sleep(SLEEP_CYCLES)
        super().send(bufs, cur, nxt, senders, tag)


class _Unordered(LocalRing):
    """Hops on the side stream with no events: the double buffer's hazards."""

    def send(self, bufs, cur, nxt, senders, tag):
        for r in self.ranks:
            if r in senders:
                with torch.cuda.stream(self._side):
                    bufs[self.right(r)][nxt].copy_(bufs[r][cur])

    def wait(self, i, slot):
        pass


def test_ring_events_order_the_double_buffer(dev, monkeypatch):
    q, k, v, _, _ = _ring_inputs(8, 8, 64, torch.float32, dev, seq=512)
    cfg = rp._config(128, False, False, 64**-0.5, None)
    want, _ = rp._ring_fwd(q, k, v, LocalRing(4), cfg, plain=True)
    # Copies that land late: each step must wait for the arrival in its slot.
    out, _ = rp._ring_fwd(q, k, v, _SlowCopies(4), cfg)
    assert rel_err(out, want) <= 2e-5
    # Kernels that read late: a copy into a slot must wait for its last read.
    fast_step = rp.ring_fwd_step

    def slow_step(*args):
        torch.cuda._sleep(SLEEP_CYCLES)
        fast_step(*args)

    monkeypatch.setattr(rp, "ring_fwd_step", slow_step)
    out, _ = rp._ring_fwd(q, k, v, LocalRing(4), cfg)
    assert rel_err(out, want) <= 2e-5
    # Without the events the same schedule overwrites slots before they are read.
    out, _ = rp._ring_fwd(q, k, v, _Unordered(4), cfg)
    torch.cuda.synchronize()
    assert rel_err(out, want) > 1e-3


@pytest.mark.parametrize("n_steps,causal", [(4, True), (3, False)])
def test_ring_selfloop_checks_on_the_card(dev, n_steps, causal):
    before = dict(_kernels.launches)
    rel, out, _ = rp.ring_pallas_selfloop_check(n_steps=n_steps, causal=causal)
    assert out.is_cuda and rel < 5e-3
    assert _kernels.launches["ring_fwd_step"] == before.get("ring_fwd_step", 0) + 1
    before = dict(_kernels.launches)
    assert rp.ring_pallas_selfloop_bwd_check(n_steps=n_steps, causal=causal) < 2e-2
    for name in ("ring_bwd_dkv", "ring_bwd_dq"):
        assert _kernels.launches[name] == before.get(name, 0) + 1


# The backward kernels (the tensor-core bodies of csrc/bwd_tc.cuh in ring
# mode) called on one step at bf16 D 256, S_loc 1024, Hq16 Hkv8: the
# diagonal step (written into the buffers) and the off-diagonal steps of
# rank 2 of 4 (folded into buffers that hold earlier steps), against their
# plain versions at the bf16 backward gate, 2e-2.
@pytest.mark.parametrize("zigzag", [False, True])
def test_ring_bwd_kernels_take_bf16_head_dim_256(dev, zigzag):
    s_loc, d, n, my = 1024, 256, 4, 2
    g = torch.Generator().manual_seed(3)
    q, do = (torch.randn((2, 16, s_loc, d), generator=g).to(dev, torch.bfloat16) for _ in range(2))
    delta = torch.randn((2, 16, s_loc), generator=g).to(dev)
    for src in ((2, 1, 3) if zigzag else (2, 1)):
        k, v = (torch.randn((2, 8, s_loc, d), generator=g).to(dev, torch.bfloat16)
                for _ in range(2))
        c = rp._Step(n, my, src, src == my, True, zigzag, d**-0.5, 512)
        s = torch.matmul(rp._fold(q.float() * c.scale, 8), k.float().transpose(-1, -2))
        lse = s.reshape(2, 16, s_loc, s_loc).logsumexp(-1)  # finite on every row
        bufs = [torch.randn((2, 8, s_loc, d), generator=g).to(dev) for _ in range(2)]
        bufs.append(torch.randn((2, 16, s_loc, d), generator=g).to(dev))
        got = [x.clone() for x in bufs]
        before = dict(_kernels.launches)
        rp.ring_bwd_dkv(q, do, lse, delta, k, v, got[0], got[1], c)
        rp.ring_bwd_dq(q, do, lse, delta, k, v, got[2], c)
        torch.cuda.synchronize()
        for name in ("ring_bwd_dkv", "ring_bwd_dq"):
            assert _kernels.launches[name] == before.get(name, 0) + 1
        want = [x.clone() for x in bufs]
        rp._dkv_plain(q, do, lse, delta, k, v, want[0], want[1], c)
        rp._dq_plain(q, do, lse, delta, k, v, want[2], c)
        for x, y in zip(got, want):
            assert torch.isfinite(x).all() and rel_err(x, y) <= RING_BWD_TOLS[torch.bfloat16]


# The fp32 ring backward (3xTF32) as accurate as the dense one: 5e-6
# against its plain version at causal S 1024, q ~ N(0, 3), as
# test_flash_bwd_fp32_keeps_highest_accuracy holds the dense backward.
@pytest.mark.parametrize("d", [64, 128, 256])
def test_ring_bwd_fp32_keeps_highest_accuracy(dev, d):
    q, k, v, do, dlse = _ring_inputs(4, 4, d, torch.float32, dev)
    q = q * 3.0
    cfg = rp._config(256, True, False, d**-0.5, None)
    out, lse = rp._ring_fwd(q, k, v, LocalRing(4), cfg, plain=True)
    got = rp._ring_bwd(q, k, v, out, lse, do, dlse, LocalRing(4), cfg)
    want = rp._ring_bwd(q, k, v, out, lse, do, dlse, LocalRing(4), cfg, plain=True)
    for x, y in zip(got, want):
        assert rel_err(x, y) <= 5e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_bwd_kernels_are_deterministic(dev, dtype):
    q, k, v, do, dlse = _ring_inputs(16, 8, 64, dtype, dev)
    cfg = rp._config(256, True, True, 0.125, None)
    out, lse = rp._ring_fwd(q, k, v, LocalRing(4), cfg)
    first = rp._ring_bwd(q, k, v, out, lse, do, dlse, LocalRing(4), cfg)
    second = rp._ring_bwd(q, k, v, out, lse, do, dlse, LocalRing(4), cfg)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


# The ring forward (the tensor-core body of csrc/fwd_tc.cuh in ring mode) as
# accurate in fp32 as the ring backward: 5e-6 against its plain version at
# causal S 1024, q ~ N(0, 3), LSE 1e-5.
@pytest.mark.parametrize("zigzag", [False, True])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_ring_fwd_fp32_keeps_highest_accuracy(dev, d, zigzag):
    q, k, v, _, _ = _ring_inputs(4, 4, d, torch.float32, dev)
    q = q * 3.0
    cfg = rp._config(256, True, zigzag, d**-0.5, None)
    out, lse = rp._ring_fwd(q, k, v, LocalRing(4), cfg)
    want, want_lse = rp._ring_fwd(q, k, v, LocalRing(4), cfg, plain=True)
    assert rel_err(out, want) <= 5e-6
    assert (lse - want_lse).abs().max().item() <= 1e-5


# bf16 D 256 through the public entry point, forward and backward, against
# the ring of plain versions (the parent's forward refused D > 128).
@pytest.mark.parametrize("zigzag", [False, True])
def test_ring_takes_bf16_head_dim_256(dev, zigzag):
    q, k, v, do, dlse = _ring_inputs(16, 8, 256, torch.bfloat16, dev)
    cfg = rp._config(256, True, zigzag, 256**-0.5, None)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = dict(_kernels.launches)
    out, lse = rp.ring_flash_attention_pallas(*leaves, ring=LocalRing(4), causal=True,
                                              zigzag=zigzag, return_lse=True)
    ((out.float() * do.float()).sum() + (lse * dlse).sum()).backward()
    torch.cuda.synchronize()
    steps = 16 if zigzag else 10
    for name in ("ring_fwd_step", "ring_bwd_dkv", "ring_bwd_dq"):
        assert _kernels.launches[name] == before.get(name, 0) + steps
    want, want_lse = rp._ring_fwd(q, k, v, LocalRing(4), cfg, plain=True)
    rtol, ltol = RING_FWD_TOLS[torch.bfloat16]
    assert rel_err(out, want) <= rtol and (lse - want_lse).abs().max().item() <= ltol
    want_grads = rp._ring_bwd(q, k, v, out.detach(), lse.detach(), do, dlse, LocalRing(4), cfg,
                              plain=True)
    for x, y in zip(leaves, want_grads):
        assert torch.isfinite(x.grad).all()
        assert rel_err(x.grad, y) <= RING_BWD_TOLS[torch.bfloat16]


# fp32 D 256 through the public entry point, forward and backward, against
# the ring of plain versions at the fp32 gates (the 3xTF32 bodies' wide fp32
# tiles).
@pytest.mark.parametrize("zigzag", [False, True])
def test_ring_takes_fp32_head_dim_256(dev, zigzag):
    q, k, v, do, dlse = _ring_inputs(16, 8, 256, torch.float32, dev)
    cfg = rp._config(256, True, zigzag, 256**-0.5, None)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = dict(_kernels.launches)
    out, lse = rp.ring_flash_attention_pallas(*leaves, ring=LocalRing(4), causal=True,
                                              zigzag=zigzag, return_lse=True)
    ((out * do).sum() + (lse * dlse).sum()).backward()
    torch.cuda.synchronize()
    steps = 16 if zigzag else 10
    for name in ("ring_fwd_step", "ring_bwd_dkv", "ring_bwd_dq"):
        assert _kernels.launches[name] == before.get(name, 0) + steps
    want, want_lse = rp._ring_fwd(q, k, v, LocalRing(4), cfg, plain=True)
    rtol, ltol = RING_FWD_TOLS[torch.float32]
    assert rel_err(out, want) <= rtol and (lse - want_lse).abs().max().item() <= ltol
    want_grads = rp._ring_bwd(q, k, v, out.detach(), lse.detach(), do, dlse, LocalRing(4), cfg,
                              plain=True)
    for x, y in zip(leaves, want_grads):
        assert torch.isfinite(x.grad).all()
        assert rel_err(x.grad, y) <= RING_BWD_TOLS[torch.float32]


# fp16 through the public entry point: computed as fp32 on the 3xTF32
# kernels and cast back, against the ring of plain versions on the same
# values in fp32, at the dense fp16 forward's gates (atol/rtol 1e-3, LSE
# 1e-3; tests/test_torch_flash_fwd.py); gradients in fp16 at 1e-3.
@pytest.mark.parametrize("zigzag", [False, True])
def test_ring_takes_fp16(dev, zigzag):
    q, k, v, do, dlse = _ring_inputs(16, 8, 64, torch.float16, dev)
    cfg = rp._config(256, True, zigzag, 64**-0.5, None)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = dict(_kernels.launches)
    out, lse = rp.ring_flash_attention_pallas(*leaves, ring=LocalRing(4), causal=True,
                                              zigzag=zigzag, return_lse=True)
    ((out.float() * do.float()).sum() + (lse * dlse).sum()).backward()
    torch.cuda.synchronize()
    for name in ("ring_fwd_step", "ring_bwd_dkv", "ring_bwd_dq"):
        assert _kernels.launches[name] == before.get(name, 0) + (16 if zigzag else 10)
    q32, k32, v32 = (x.float() for x in (q, k, v))
    want, want_lse = rp._ring_fwd(q32, k32, v32, LocalRing(4), cfg, plain=True)
    assert out.dtype == torch.float16 and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), want.half().float(), atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)
    want_grads = rp._ring_bwd(q32, k32, v32, want, want_lse, do.float(), dlse, LocalRing(4), cfg,
                              plain=True)
    for x, y in zip(leaves, want_grads):
        assert x.grad.dtype == torch.float16 and torch.isfinite(x.grad).all()
        assert rel_err(x.grad, y) <= 1e-3


# A local chunk of 96 rows (S 384 over 4 ranks), contiguous and zigzag (halves
# of 48): the three ring kernels take the ragged tiles, at the file's gates.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["causal", "zigzag"])
def test_ring_kernels_take_a_local_chunk_of_96(dev, dtype, layout):
    causal, zigzag = RING_LAYOUTS[layout]
    q, k, v, do, dlse = _ring_inputs(16, 8, 64, dtype, dev, seq=384)
    cfg = rp._config(96, causal, zigzag, 0.125, None)
    before = dict(_kernels.launches)
    out, lse = rp._ring_fwd(q, k, v, LocalRing(4), cfg)
    grads = rp._ring_bwd(q, k, v, out, lse, do, dlse, LocalRing(4), cfg)
    torch.cuda.synchronize()
    for name in ("ring_fwd_step", "ring_bwd_dkv", "ring_bwd_dq"):
        assert _kernels.launches[name] == before.get(name, 0) + (10 if layout == "causal" else 16)
    want, want_lse = rp._ring_fwd(q, k, v, LocalRing(4), cfg, plain=True)
    rtol, ltol = RING_FWD_TOLS[dtype]
    assert torch.isfinite(out).all() and rel_err(out, want) <= rtol
    assert (lse - want_lse).abs().max().item() <= ltol
    want_grads = rp._ring_bwd(q, k, v, out, lse, do, dlse, LocalRing(4), cfg, plain=True)
    for got, ref in zip(grads, want_grads):
        assert torch.isfinite(got).all() and rel_err(got, ref) <= RING_BWD_TOLS[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("zigzag", [False, True])
def test_ring_fwd_kernel_is_deterministic(dev, dtype, zigzag):
    q, k, v, _, _ = _ring_inputs(16, 8, 64, dtype, dev)
    cfg = rp._config(256, True, zigzag, 0.125, None)
    first = rp._ring_fwd(q, k, v, LocalRing(4), cfg)
    second = rp._ring_fwd(q, k, v, LocalRing(4), cfg)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


def test_ring_kernels_refuse_what_they_do_not_take(dev):
    # The forward: head_dim up to 256, fp32 and bf16.
    with pytest.raises(ValueError, match="head_dim <= 256"):
        q, k, v, _, _ = _ring_inputs(2, 2, 264, torch.float32, dev, seq=512)
        rp.ring_flash_attention_pallas(q, k, v, ring=LocalRing(4))
    with pytest.raises(ValueError, match="head_dim <= 256"):
        q, k, v, _, _ = _ring_inputs(2, 2, 320, torch.bfloat16, dev, seq=512)
        rp.ring_flash_attention_pallas(q, k, v, ring=LocalRing(4))
    # A local chunk the reference's tile asserts refuse: zigzag halves of 48
    # and 49 rows (S_loc 97, odd) do not divide into its tiles.
    q, k, v, _, _ = _ring_inputs(2, 2, 64, torch.float32, dev, seq=388)
    with pytest.raises(ValueError, match="divisible"):
        rp.ring_flash_attention_pallas(q, k, v, ring=LocalRing(4), causal=True, zigzag=True)
    q, k, v, _, _ = _ring_inputs(2, 2, 64, torch.float32, dev, seq=256)
    c = rp._Step(4, 0, 0, True, True, False, 0.125, 64)
    o, lse = torch.empty_like(q[:, :, :64]), torch.empty(q.shape[:2] + (64,), device=dev)
    with pytest.raises(ValueError, match="block_k"):  # 48 does not divide 64
        rp.ring_fwd_step(q[:, :, :64].contiguous(), k[:, :, :64].contiguous(),
                         v[:, :, :64].contiguous(), o, lse, c._replace(block_k=48))
    with pytest.raises(ValueError, match="one CUDA device"):
        rp.ring_fwd_step(q[:, :, :64].contiguous(), k[:, :, :64].cpu(), v[:, :, :64].contiguous(),
                         o, lse, c)
    # The backward kernels: head_dim up to 256, bf16 and fp32.
    for dtype, d, limit in ((torch.bfloat16, 260, 256), (torch.float32, 264, 256)):
        q, k, v, do, _ = _ring_inputs(2, 2, d, dtype, dev, seq=128)
        lse = torch.zeros(q.shape[:3], device=dev)
        dk, dv, dq = (torch.zeros(x.shape, device=dev) for x in (k, v, q))
        before = dict(_kernels.launches)
        with pytest.raises(ValueError, match=f"head_dim <= {limit}"):
            rp.ring_bwd_dkv(q, do, lse, lse, k, v, dk, dv, c)
        with pytest.raises(ValueError, match=f"head_dim <= {limit}"):
            rp.ring_bwd_dq(q, do, lse, lse, k, v, dq, c)
        assert dict(_kernels.launches) == before


@pytest.mark.parametrize("name", sorted(mp.SHAPES))
def test_mma_probe_kernel_matches_plain(dev, name):
    # The reference's shapes, each split in K by the plan (4 or 8 slices).
    m, k, n = mp.SHAPES[name]
    assert mp.plan(m, k, n)[1] > 1
    _check_probe(dev, m, k, n)
    g = torch.Generator().manual_seed(0)
    a = torch.randn((m, k), generator=g).to(dev, torch.bfloat16)
    b = (torch.randn((k, n), generator=g) * 1e-3).to(dev, torch.bfloat16)
    before = dict(_kernels.launches)
    flat = torch.empty(a.numel() + 1, dtype=torch.bfloat16, device=dev)
    for args in ((a[:100], b, 8),                        # M not a multiple of 64
                 (a[:, :40].contiguous(), b[:40], 8),    # K not a multiple of 16
                 (a, b[:, :32].contiguous(), 8),         # N not a multiple of 64
                 (flat[1:].view(m, k), b, 8),            # a not 16-byte aligned
                 (a, b, 0)):                             # no reps
        with pytest.raises(ValueError):
            mp.mma_probe(*args)
    assert dict(_kernels.launches) == before


def _check_probe(dev, m, k, n):
    """Reps 1 and 8 against the plain loop (fp32 relerr 1e-5: bf16 products
    are exact in fp32, the two sum them in another order), reps 3 (the odd
    tail of the loop), one launch a call, and the same bits twice."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn((m, k), generator=g).to(dev, torch.bfloat16)
    b = (torch.randn((k, n), generator=g) * 1e-3).to(dev, torch.bfloat16)
    for reps in (1, 3, 8):
        n0 = _kernels.launches["mma_probe"]
        got = mp.mma_probe(a, b, reps)
        torch.cuda.synchronize()
        assert _kernels.launches["mma_probe"] == n0 + 1
        assert got.dtype == torch.float32 and got.shape == (m, n)
        assert rel_err(got, mp.mma_probe_plain(a, b, reps)) <= 1e-5
    assert torch.equal(mp.mma_probe(a, b, 8), got)


# Plans beside the reference's: 64-wide tiles with 16 steps a slice (K
# 1024, N 64: split 4), 64-wide tiles split 32 (N 192), a split of 3 (K
# 48), one slice of one step (K 16), a tile that alone fills nothing, and
# many tiles without a split.
@pytest.mark.parametrize("m,k,n", [(4096, 1024, 64), (256, 1024, 192), (64, 48, 64),
                                   (128, 16, 128), (64, 64, 128), (8192, 128, 256)])
def test_mma_probe_kernel_other_plans(dev, m, k, n):
    _check_probe(dev, m, k, n)


# ---- Block-sparse walks (rows 1-3: the SPARSE instantiations) --------------
#
# Each walked kernel against its plain version on the same BlockMask, at
# the gates above (forward fp32 2e-5 / LSE 1e-5, bf16 1e-2 / 1e-3;
# backward fp32 1e-4, bf16 2e-2); a row whose LSE is past its gate must
# be within it of the float64 LSE (`lse_check`): at D < 128 the row sum
# adds bf16(P), and in a row of two keys the fp32 plain version can round
# its second P one ulp off (1.35e-3 in LSE), where the kernels do not. Rows whose walked keys all carry the
# mask's -1e30 bias average V over those keys on both sides and are held
# to the same gates; rows that walk no key are exact.


def _doc_ids(b, s, seed, pad):
    """(B, S) int32 ids of seeded uneven documents per row, the last `pad`
    ids -1 (padding that sees no key)."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.zeros((b, s), dtype=torch.int32)
    for r in range(b):
        pos, doc = 0, 0
        while pos < s:
            n = int(torch.randint(48, max(49, s // 3), (1,), generator=g))
            ids[r, pos:pos + n] = doc
            pos, doc = pos + n, doc + 1
        if pad:
            ids[r, s - pad:] = -1
    return ids


def _walk_mask(kind, b, hq, sq, sk, dev):
    """A BlockMask on `dev` for the walked-kernel cases."""
    from umfa_tpu_torch.ops import block_mask as bm
    from umfa_tpu_torch.ops.flash_fwd import BlockSizes

    if kind == "causal":
        return bm.causal_block_mask(sq, sk, device=dev)
    if kind == "window_128_0":
        return bm.sliding_window_block_mask(sq, sk, 128, 0, device=dev)
    ids = _doc_ids(b, sk, 5, pad=sk // 7)
    if kind == "segments_padded":
        return bm.segment_block_mask(ids[:, :sq], ids, causal=True, device=dev)
    if kind == "blocks_96x160":
        return bm.segment_block_mask(ids[:, :sq], ids, causal=True, device=dev,
                                     block_sizes=BlockSizes(96, 160))
    if kind == "per_head":
        i = torch.arange(sq)[:, None]
        j = torch.arange(sk)[None, :]
        mask = torch.stack([(j <= i) & (j >= i - 64 * (h + 1)) for h in range(hq)])[None]
        return bm.make_block_mask(mask, sq, sk, device=dev)
    if kind == "left_padded":
        # Batch 0's ids -1 on its first rows, more than a 128-row tile of
        # them: its first fill (its K/V means window) is key tile 1, not 0.
        ids[0] = ids[0].flip(0)
        return bm.segment_block_mask(ids[:, :sq], ids, causal=True, device=dev,
                                     block_sizes=BlockSizes(128, 128))
    if kind == "aligned":  # documents of 512: SKIP and FULL tiles only, no bias
        ids = torch.arange(sk, dtype=torch.int32)[None].repeat(b, 1) // 512
        mask = bm.segment_block_mask(ids[:, :sq], ids, device=dev)
        assert mask.bias is None
        return mask
    raise ValueError(kind)


SPARSE_CASES = [
    # (b, hq, hkv, sq, sk, d, mask)
    (2, 4, 2, 1024, 1024, 64, "causal"),
    (2, 4, 2, 1024, 1024, 64, "window_128_0"),
    (2, 4, 2, 1024, 1024, 64, "segments_padded"),
    (1, 4, 2, 1024, 1024, 64, "per_head"),
    (2, 4, 2, 777, 1000, 64, "blocks_96x160"),
    (2, 4, 2, 1024, 1024, 64, "aligned"),
    (1, 4, 2, 777, 1000, 128, "segments_padded"),
    (1, 4, 1, 1024, 1024, 256, "segments_padded"),
    (1, 4, 2, 777, 1000, 256, "blocks_96x160"),
    # The smoke's geometry (B2 Hq16 Hkv8), where more document starts fall
    # past a row's first walked tiles.
    (2, 16, 8, 777, 1000, 64, "segments_padded"),
    (2, 16, 8, 777, 1000, 64, "blocks_96x160"),
    (2, 16, 8, 1024, 1024, 64, "per_head"),
]


def _walk_kwargs(mask):
    return dict(block_map=mask.block_map, block_q=mask.block_q, block_k=mask.block_k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SPARSE_CASES)
def test_flash_kernels_walk_a_block_mask_as_the_plain_versions(dev, dtype, case):
    b, hq, hkv, sq, sk, d, kind = case
    q, k, v = _qkv(b, hq, hkv, sq, sk, d, dtype, dev)
    mask = _walk_mask(kind, b, hq, sq, sk, dev)
    wkw = _walk_kwargs(mask)
    n0 = dict(_kernels.launches)
    out, lse = flash_attention_forward(q, k, v, mask.bias, fetch_ids=mask.fetch_kv, **wkw)
    torch.cuda.synchronize()
    assert _kernels.launches["flash_fwd"] == n0.get("flash_fwd", 0) + 1
    want, want_lse = flash_attention_forward_plain(q, k, v, mask.bias, **wkw)
    keep = walked_keys(mask.walk(), sq, sk)
    _check(out.float(), lse, want.float(), want_lse, *TOLS[dtype], (q, k, mask.bias, keep))
    again = flash_attention_forward(q, k, v, mask.bias, fetch_ids=mask.fetch_kv, **wkw)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)
    g = torch.Generator().manual_seed(2)
    do = torch.randn(out.shape, generator=g).to(dev, out.dtype)
    dlse = torch.where(want_lse > -1e29, torch.randn(lse.shape, generator=g).to(dev), 0.0)
    gdt = torch.bfloat16 if dtype == torch.bfloat16 else None
    args = (q, k, v, want.to(dtype), want_lse, do, mask.bias, dlse)
    bkw = dict(wkw, fetch_kv=mask.fetch_kv, fetch_q=mask.fetch_q)
    got = flash_attention_backward(*args, grad_dtype=gdt, **bkw)
    torch.cuda.synchronize()
    assert _kernels.launches["flash_bwd_dq"] == n0.get("flash_bwd_dq", 0) + 1
    assert _kernels.launches["flash_bwd_dkv"] == n0.get("flash_bwd_dkv", 0) + 1
    want_g = flash_attention_backward_plain(*args, grad_dtype=gdt, **wkw)
    for x, y, name in zip(got, want_g, ("dq", "dk", "dv")):
        assert torch.isfinite(x.float()).all(), name
        assert rel_err(x, y) <= BWD_TOLS[dtype], name
    again = flash_attention_backward(*args, grad_dtype=gdt, **bkw)
    assert all(torch.equal(x, y) for x, y in zip(again, got))


def test_flash_kernels_refuse_a_map_without_its_tables(dev):
    q, k, v = _qkv(1, 2, 1, 256, 256, 64, torch.bfloat16, dev)
    mask = _walk_mask("causal", 1, 2, 256, 256, dev)
    with pytest.raises(ValueError, match="fetch_kv"):
        flash_attention_forward(q, k, v, **_walk_kwargs(mask))
    out, lse = flash_attention_forward(q, k, v, fetch_ids=mask.fetch_kv, **_walk_kwargs(mask))
    with pytest.raises(ValueError, match="fetch_q"):
        flash_attention_backward(q, k, v, out, lse, out, fetch_kv=mask.fetch_kv,
                                 **_walk_kwargs(mask))
    with pytest.raises(ValueError, match="lies on"):
        flash_attention_forward(q, k, v, **_walk_kwargs(mask.to("cpu")),
                                fetch_ids=mask.fetch_kv.cpu())


def test_attention_with_a_block_mask_on_the_card_matches_the_cpu(dev):
    import umfa_tpu_torch

    q, k, v = _qkv(2, 4, 2, 512, 512, 64, torch.float32, dev)
    ids = _doc_ids(2, 512, 9, pad=70)
    mask = umfa_tpu_torch.segment_block_mask(ids, causal=True)
    outs = []
    for device, m in ((dev, mask.to(dev)), (torch.device("cpu"), mask)):
        qq, kk, vv = (x.detach().to(device).requires_grad_(True) for x in (q, k, v))
        out = umfa_tpu_torch.attention(qq, kk, vv, m)
        (out * out).sum().backward()
        outs.append([x.detach().cpu() for x in (out, qq.grad, kk.grad, vv.grad)])
    for got, want in zip(*outs):
        assert rel_err(got, want) <= 1e-4
    with pytest.raises(ValueError, match="on cpu"):  # the mask's bias and tables stay where built
        umfa_tpu_torch.attention(q, k, v, mask)


# ---- The quantized walks (rows 5, 7, 8, 9): each walked instantiation
# against its plain version at the gates of its unwalked instantiations,
# the same bits on two calls.

QSPARSE_CASES = [
    # (b, hq, hkv, sq, sk, d, mask)
    (2, 4, 2, 1024, 1024, 64, "causal"),
    (2, 4, 2, 1024, 1024, 64, "segments_padded"),
    (2, 4, 2, 1024, 1024, 64, "left_padded"),
    (1, 4, 2, 1024, 1024, 64, "per_head"),
    (2, 4, 2, 777, 1000, 64, "blocks_96x160"),
    (2, 4, 2, 1024, 1024, 64, "aligned"),
    (1, 4, 2, 777, 1000, 128, "segments_padded"),
    (1, 4, 2, 777, 1000, 256, "blocks_96x160"),
    (2, 16, 8, 777, 1000, 64, "left_padded"),
]


def _fused_walk_kwargs(mask):
    return dict(_walk_kwargs(mask), fetch_kv=mask.fetch_kv, hold_kv=mask.hold_kv,
                fill_kv=mask.fill_kv)


@pytest.mark.parametrize("recipe", ["int8", "int4", "int8_block", "int8_asym", "qdense"])
@pytest.mark.parametrize("case", QSPARSE_CASES)
def test_fused_qattn_walks_a_block_mask_as_the_plain_version(dev, recipe, case):
    b, hq, hkv, sq, sk, d, kind = case
    mask = _walk_mask(kind, b, hq, sq, sk, dev)
    (q, k, v), kw = _fused_inputs((b, hq, hkv, sq, sk, d, recipe, {}), torch.bfloat16, dev)
    kw.update(_fused_walk_kwargs(mask))
    n0 = _kernels.launches["fused_qattn"]
    got = fused_quantize_attend(q, k, v, mask.bias, **kw)
    torch.cuda.synchronize()
    assert _kernels.launches["fused_qattn"] == n0 + 1
    want = fused_quantize_attend_plain(q, k, v, mask.bias, **kw)
    _check_fused(got, want, walked=True)
    again = fused_quantize_attend(q, k, v, mask.bias, **kw)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
    if kind == "left_padded":
        assert mask.kv_mean_tile.flatten().tolist() == [1, 0]


@pytest.mark.parametrize("case", QSPARSE_CASES[:3])
def test_fused_qattn_walk_takes_fp32_inputs(dev, case):
    b, hq, hkv, sq, sk, d, kind = case
    mask = _walk_mask(kind, b, hq, sq, sk, dev)
    (q, k, v), kw = _fused_inputs((b, hq, hkv, sq, sk, d, "int8", {}), torch.float32, dev)
    kw.update(_fused_walk_kwargs(mask))
    _check_fused(fused_quantize_attend(q, k, v, mask.bias, **kw),
                 fused_quantize_attend_plain(q, k, v, mask.bias, **kw), walked=True)


@pytest.mark.parametrize("variant", ["int8", "int4_corr", "asym"])
@pytest.mark.parametrize("case", QSPARSE_CASES)
def test_quant_attn_fwd_walks_a_block_mask_as_the_plain_version(dev, variant, case):
    b, hq, hkv, sq, sk, d, kind = case
    mask = _walk_mask(kind, b, hq, sq, sk, dev)
    strategy = QuantStrategy.ASYMMETRIC if variant == "asym" else QuantStrategy.SYMMETRIC
    precs = _PRECS["int4"] if variant == "int4_corr" else (Precision.INT8,) * 3
    q, k, v = _qkv(b, hq, hkv, sq, sk, d, torch.float32, dev, seed=12)
    qts = [quantize(x, pr, QuantMode.ROW, strategy) for x, pr in zip((q, k + 0.4, v), precs)]
    corr = None
    if variant == "int4_corr":
        corr = torch.randn((b, hq, 1, sk), generator=torch.Generator().manual_seed(3)).to(dev)
    walk = _walk_kwargs(mask)
    n0 = _kernels.launches["quant_attn_fwd"]
    out, lse = quantized_attention_forward(*qts, mask.bias, corr, mask.block_map, mask.fetch_kv,
                                           block_q=mask.block_q, block_k=mask.block_k)
    torch.cuda.synchronize()
    assert _kernels.launches["quant_attn_fwd"] == n0 + 1
    want, want_lse = quantized_attention_forward_plain(*qts, mask.bias, corr, **walk)
    _check(out, lse, want, want_lse, 1e-3, 1e-4)
    again = quantized_attention_forward(*qts, mask.bias, corr, mask.block_map, mask.fetch_kv,
                                        block_q=mask.block_q, block_k=mask.block_k)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("recipe", ["int8", "int4"])
@pytest.mark.parametrize("case", QSPARSE_CASES)
def test_quant_bwd_kernels_walk_a_block_mask_as_the_plain_versions(dev, dtype, recipe, case):
    # Smoothing on (int4: qm and its corr row, walked at each head's own
    # first and last tile; int8: vm), a nonzero dlse, rows that see no key.
    b, hq, hkv, sq, sk, d, kind = case
    mask = _walk_mask(kind, b, hq, sq, sk, dev)
    (q, k, v), kw = _fused_inputs((b, hq, hkv, sq, sk, d, recipe, {}), dtype, dev)
    kw.update(_fused_walk_kwargs(mask))
    out, lse, qt_q, qt_k, qt_v, qm, vm = fused_quantize_attend_plain(q, k, v, mask.bias, **kw)
    g = torch.Generator().manual_seed(7)
    do = torch.randn(out.shape, generator=g).to(dev, out.dtype)
    dlse = torch.where(lse > -1e29, torch.randn(lse.shape, generator=g).to(dev), 0.0)
    corr = None if qm is None else _corr_from_quantized(qm, qt_k)
    args = (qt_q, qt_k, qt_v, out, lse, do, qm, vm, corr, mask.bias, dlse)
    walk = _walk_kwargs(mask)
    gdt = torch.bfloat16 if dtype == torch.bfloat16 else None
    n_dq, n_dkv = _kernels.launches["quant_bwd_dq"], _kernels.launches["quant_bwd_dkv"]
    got = quantized_attention_backward(*args, fetch_kv=mask.fetch_kv, fetch_q=mask.fetch_q,
                                       grad_dtype=gdt, **walk)
    torch.cuda.synchronize()
    assert _kernels.launches["quant_bwd_dq"] == n_dq + 1
    assert _kernels.launches["quant_bwd_dkv"] == n_dkv + 1
    want = quantized_attention_backward_plain(*args, grad_dtype=gdt, **walk)
    order_free = None
    for i, (g_, w, name) in enumerate(zip(got, want, ("dq", "dk", "dv"))):
        assert torch.isfinite(g_.float()).all(), name
        tol = QBWD_DKV_FP32[name] if dtype == torch.float32 else BWD_TOLS[dtype]
        if rel_err(g_, w) > tol:
            # Past the gate: bf16(P) and bf16(dS) elements rounded the other
            # way by the last bits of the fp32 score sums, weightier where a
            # walked row sees few keys (dV 2.2e-4 at BlockSizes(96, 160)).
            # Only that fp32-dO case is known to need it; there the gate
            # holds against the same arithmetic with the scores summed in
            # float64 (no fp32 order).
            assert dtype == torch.float32 and kind == "blocks_96x160", (name, rel_err(g_, w))
            if order_free is None:
                order_free = _quant_bwd_plain_with_f64_scores(args, mask, gdt)
            w = order_free[i]
        assert rel_err(g_, w) <= tol, name
    empty = lse <= -1e29
    assert (got[0][empty] == 0).all()
    again = quantized_attention_backward(*args, fetch_kv=mask.fetch_kv, fetch_q=mask.fetch_q,
                                         grad_dtype=gdt, **walk)
    assert all(torch.equal(x, y) for x, y in zip(again, got))


def _quant_bwd_plain_with_f64_scores(args, mask, grad_dtype):
    """quantized_attention_backward_plain's arithmetic (ops/quant_bwd.py
    `_plain_p_ds`, `_plain_dq`, `_plain_dkv`) with the two score products
    q̃·k̃ᵀ and bf16(dO)·ṽᵀ summed in float64 and rounded once to fp32: the
    plain version free of any fp32 summation order."""
    from umfa_tpu_torch.ops import quant_bwd as qb
    from umfa_tpu_torch.ops.flash_fwd import make_walk, visible_mask

    p = qb._prepare(*args, False, None, None,
                    make_walk(mask.block_map, None, None, mask.block_q, mask.block_k))
    b, hq, hkv, sq, sk, d = p.shape
    g, rows = hq // hkv, hq // hkv * sq
    q_bf, k_bf, v_bf = (qb._deq(x, sc, i4) for x, sc, i4 in (
        (p.q, p.q_scales, p.q_int4), (p.k, p.k_scales, p.k_int4), (p.v, p.v_scales, p.v_int4)))
    do_f = p.do.float()
    do_bf = do_f.to(torch.bfloat16).float()

    def scores(a, kv):  # (B, Hq, Sq, D)·(B, Hkv, Sk, D)ᵀ, the group folded into the rows
        s = torch.matmul(a.double().reshape(b, hkv, rows, d), kv.double().transpose(-1, -2))
        return s.float().reshape(b, hq, sq, sk)

    s = scores(q_bf, k_bf)
    if p.corr is not None:
        s += p.corr[:, :, None, :]
    if p.bias is not None:
        s += p.bias
    hidden = ~visible_mask(sq, sk, p.left, p.right, s.device) | ~walked_keys(p.walk, sq, sk)
    pm = (s - p.lse[..., None]).exp().masked_fill(hidden, 0.0)
    dp = scores(do_bf, v_bf)
    if p.vm is not None:
        dp += (do_f * p.vm.repeat_interleave(g, dim=1)[:, :, None, :]).sum(dim=-1, keepdim=True)
    ds = (dp - p.delta[..., None]) * pm
    ds_bf = ds.to(torch.bfloat16).float().reshape(b, hkv, rows, sk)
    dq = torch.matmul(ds_bf, k_bf).mul_(p.scale).reshape(b, hq, sq, d)
    dv = torch.matmul(pm.to(torch.bfloat16).float().reshape(b, hkv, rows, sk).transpose(-1, -2),
                      do_bf.reshape(b, hkv, rows, d))
    dk = torch.matmul(ds_bf.transpose(-1, -2), q_bf.reshape(b, hkv, rows, d))
    if p.qm is not None:
        colsum = ds.sum(dim=2) * p.scale
        dk += torch.matmul(colsum.reshape(b, hkv, g, sk).transpose(-1, -2),
                           p.qm.reshape(b, hkv, g, d))
    return tuple(x.to(grad_dtype or torch.float32) for x in (dq, dk, dv))


@pytest.mark.parametrize("route", ["fused", "per_head_two_pass", "bias_grad_two_pass",
                                   "disabled_two_pass", "asym", "qdense"])
def test_quantized_attention_with_a_block_mask_on_the_card_matches_the_cpu(dev, monkeypatch,
                                                                          route):
    import umfa_tpu_torch
    from umfa_tpu_torch.ops import block_mask as bm

    if route == "disabled_two_pass":
        monkeypatch.setenv("UMFA_DISABLE_FUSED_QUANT", "1")
    q, k, v = _qkv(2, 4, 2, 512, 512, 64, torch.float32, dev)
    if route == "per_head_two_pass":
        mask = _walk_mask("per_head", 2, 4, 512, 512, torch.device("cpu"))
    else:
        mask = bm.segment_block_mask(_doc_ids(2, 512, 9, pad=70).flip(1), causal=True,
                                     device="cpu")
    cfg = QuantizationConfig.from_mode_string("int8-qdense" if route == "qdense" else "int8")
    if route == "asym":
        cfg = dataclasses.replace(cfg, strategy=QuantStrategy.ASYMMETRIC)
    outs = []
    for device, m in ((dev, mask.to(dev)), (torch.device("cpu"), mask)):
        qq, kk, vv = (x.detach().to(device).requires_grad_(True) for x in (q, k, v))
        out, lse = quantized_flash_attention(qq, kk, vv, config=cfg, block_mask=m,
                                             return_lse=True,
                                             bias_grad=route == "bias_grad_two_pass")
        ((out * out).sum() + torch.where(lse > -1e29, lse, 0.0).sum()).backward()
        outs.append([x.detach().cpu() for x in (out, lse, qq.grad, kk.grad, vv.grad)])
    for name, got, want in zip(("out", "lse", "dq", "dk", "dv"), *outs):
        assert rel_err(got, want) <= 1e-3, name
    with pytest.raises(ValueError, match="on cpu"):  # the mask stays where it was built
        quantized_flash_attention(q, k, v, config=cfg, block_mask=mask)


def test_unwalked_instantiations_keep_their_registers():
    """Registers, spills and HMMA/IMMA/DMMA counts of every unwalked
    instantiation of the walked libraries against a parent tree's
    (`utils/sass_compare.py`; needs nvcc, not a card): set
    UMFA_SASS_PARENT to the parent's tree, e.g. `git archive <commit>
    umfa_tpu_torch | tar -x -C _proof/parent`."""
    import os
    import subprocess
    import sys

    parent = os.environ.get("UMFA_SASS_PARENT")
    if not parent:
        pytest.skip("set UMFA_SASS_PARENT to a parent tree to compare with")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run(
        [sys.executable, os.path.join(repo, "umfa_tpu_torch", "utils", "sass_compare.py"),
         "--tree", parent, "--new-bool", "--libs",
         "flash_fwd,flash_bwd,ring_attn,quant_bwd,quant_attn_fwd,fused_qattn"],
        capture_output=True, text=True, timeout=1200)
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-4000:]
    moved = [ln for ln in run.stdout.splitlines()
             if ln.startswith(("DIFF", "GONE")) and "SPARSE" not in ln
             and not _walked_instantiation(ln)]
    assert not moved, "\n".join(moved)


def _walked_instantiation(line: str) -> bool:
    """A SPARSE (walked) instantiation or a WALK means kernel, by its
    demangled name: the trailing bool is true."""
    name = line.split(" ", 2)[2] if line.count(" ") >= 2 else line
    return ", true>" in name or ", (bool)1>" in name


def test_rope_leaves_the_other_forward_instantiations_as_they_were():
    """Registers, spills and HMMA counts of every dense, SPARSE and RING
    instantiation of the forward body (flash_fwd, ring_attn) against a
    parent tree without ROPE (`utils/sass_compare.py`; needs nvcc, not a
    card; set UMFA_SASS_PARENT as above): nothing differs or goes, and the
    new kernels are the twelve ROPE instantiations of flash_fwd."""
    import os
    import subprocess
    import sys

    parent = os.environ.get("UMFA_SASS_PARENT")
    if not parent:
        pytest.skip("set UMFA_SASS_PARENT to a parent tree to compare with")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run(
        [sys.executable, os.path.join(repo, "umfa_tpu_torch", "utils", "sass_compare.py"),
         "--tree", parent, "--new-bool", "--libs", "flash_fwd,ring_attn"],
        capture_output=True, text=True, timeout=1200)
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-4000:]
    lines = run.stdout.splitlines()
    assert not [ln for ln in lines if ln.startswith(("DIFF", "GONE"))], run.stdout[-4000:]
    new = [ln for ln in lines if ln.startswith("NEW")]
    assert len(new) == 12 and all(ln.split()[1] == "flash_fwd" for ln in new), new


# ---- pv_int8: the integer P·V instantiations of rows 7 and 5 against
# their plain versions: out relerr 1e-3 and LSE 1e-3 (both code P at the
# same points, p̂ from expf in the same order, so a code differs only where
# the two expf differ in the last bit at a .5; the fp32 sums of the scaled
# integer products run in another order), and row 7's P codes at most one
# apart from the plain version's and >= 99.99 % equal.

from umfa_tpu_torch.ops.quant_fused_attn import _fused, _map_walk  # noqa: E402

PV_CASES = [
    # (b, hq, hkv, sq, sk, d, recipe, kwargs)
    (2, 4, 2, 512, 512, 64, "int8", dict(causal=True)),
    (1, 4, 2, 512, 512, 64, "int8", {}),
    # Sk 320: pv_chunk 128 of the reference's 384-key tile, 64 padded rows.
    (1, 4, 2, 192, 320, 64, "int8", {}),
    (1, 4, 2, 256, 256, 64, "int8", dict(window=(48, 16))),
    # Rows that see no key (window (64, unbounded), Sq > Sk): the mean of
    # the walked chunks' V, with and without padded rows in the last tile.
    (1, 4, 2, 512, 256, 64, "int8", dict(window=(64, -1))),
    (1, 4, 2, 400, 200, 64, "int8_nosmooth", dict(window=(64, -1))),
    (2, 8, 2, 256, 256, 128, "int8", dict(causal=True)),
    (1, 4, 2, 333, 333, 256, "int8", dict(causal=True)),
    (1, 4, 2, 256, 256, 33, "int8", dict(causal=True)),
    (1, 4, 2, 256, 256, 64, "int8_v4", dict(causal=True)),
    (1, 4, 2, 256, 256, 128, "int4", dict(causal=True)),
    (1, 4, 2, 333, 333, 64, "int8_block", dict(causal=True)),
    (1, 4, 2, 256, 256, 64, "qdense", dict(causal=True)),
    (1, 4, 4, 256, 256, 64, "int8_smooth_q", dict(bias=True)),
]
RECIPES["int8_v4"] = dict(RECIPES["int8"], v_precision=Precision.INT4)


def _check_pv(got, want, codes):
    out, lse = got[0].float(), got[1]
    w_out, w_lse = want[0].float(), want[1]
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert rel_err(out, w_out) <= 1e-3
    vis = w_lse > -1e29
    if vis.any():
        assert (lse[vis] - w_lse[vis]).abs().max().item() <= 1e-3
    assert (lse[~vis] == -1e30).all()
    if (~vis).any():  # rows that see no key: the reference's mean, or 0
        assert rel_err(out[~vis], w_out[~vis]) <= 1e-3
    for a, b_ in zip(got[2:5], want[2:5]):
        assert (a is None) == (b_ is None)
        if a is not None:
            assert _codes_close(a, b_) and rel_err(a.scales, b_.scales) <= 1e-5
            assert (a.mode, a.block_size) == (b_.mode, b_.block_size)
    gap = (codes[0].int() - codes[1].int()).abs()
    assert gap.max().item() <= 1
    assert (gap != 0).sum().item() <= 1e-4 * max(1, (codes[1] > 0).sum().item())


def _pv_call(q, k, v, bias, walk, kw, plain=False):
    codes = torch.zeros(q.shape[:3] + (k.shape[2],), dtype=torch.uint8, device=q.device)
    res = _fused(q, k, v, bias, walk, plain=plain, pv_int8=True, p_codes=codes, **kw)
    return res, codes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", PV_CASES)
def test_fused_qattn_pv_matches_plain(dev, dtype, case):
    (q, k, v), kw = _fused_inputs(case, dtype, dev)
    bias = kw.pop("bias", None)
    n0 = dict(_kernels.launches)
    got, kc = _pv_call(q, k, v, bias, None, kw)
    torch.cuda.synchronize()
    assert _kernels.launches["fused_qattn"] == n0.get("fused_qattn", 0) + 1
    assert _kernels.launches["fused_qattn/pv"] == n0.get("fused_qattn/pv", 0) + 1
    want, pc = _pv_call(q, k, v, bias, None, kw, plain=True)
    _check_pv(got, want, (kc, pc))
    again = _fused(q, k, v, bias, None, pv_int8=True, **kw)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


def test_fused_qattn_pv_holds_rows_a_bias_hides(dev):
    # A bias of -1e30 on every key of some rows: the reference's mean of
    # the V of the chunks the row's query tile walks (here all of them).
    (q, k, v), kw = _fused_inputs((1, 4, 2, 256, 256, 64, "int8", dict(causal=True)),
                                  torch.bfloat16, dev)
    bias = torch.zeros((1, 4, 256, 256), device=dev)
    bias[:, :, 5:9] = -1e30
    got, kc = _pv_call(q, k, v, bias, None, kw)
    want, pc = _pv_call(q, k, v, bias, None, kw, plain=True)
    assert (want[1] <= -1e29).sum().item() == 16 and (want[0][want[1] <= -1e29] != 0).any()
    _check_pv(got, want, (kc, pc))


@pytest.mark.parametrize("recipe", ["int8", "int4", "int8_block", "qdense"])
@pytest.mark.parametrize("case", QSPARSE_CASES)
def test_fused_qattn_pv_walks_a_block_mask_as_the_plain_version(dev, recipe, case):
    b, hq, hkv, sq, sk, d, kind = case
    mask = _walk_mask(kind, b, hq, sq, sk, dev)
    (q, k, v), kw = _fused_inputs((b, hq, hkv, sq, sk, d, recipe, {}), torch.bfloat16, dev)
    walk = _map_walk(mask.block_map, mask.fetch_kv, mask.hold_kv, mask.fill_kv, mask.block_q,
                     mask.block_k)
    n0 = _kernels.launches["fused_qattn/pv"]
    got, kc = _pv_call(q, k, v, mask.bias, walk, kw)
    torch.cuda.synchronize()
    assert _kernels.launches["fused_qattn/pv"] == n0 + 1
    want, pc = _pv_call(q, k, v, mask.bias, walk, kw, plain=True)
    _check_pv(got, want, (kc, pc))


PV5_CASES = [
    # (b, hq, hkv, sq, sk, d, precisions, V group, kwargs, corr)
    (2, 4, 2, 512, 512, 64, "int8", 256, dict(causal=True), False),
    (1, 4, 2, 333, 1000, 64, "int8", 512, dict(window=(64, 0)), False),
    (1, 4, 2, 512, 512, 128, "int4", 128, dict(causal=True), True),
    (1, 2, 1, 300, 300, 256, "int8", 128, {}, False),
    (1, 4, 2, 256, 512, 64, "int8", 512, dict(causal=True), True),
    (1, 4, 2, 256, 256, 66, "int4", 256, dict(causal=True), False),
    (1, 4, 2, 256, 256, 64, "v4", 256, dict(causal=True), False),
]
_PRECS["v4"] = (Precision.INT8, Precision.INT8, Precision.INT4)


@pytest.mark.parametrize("case", PV5_CASES)
def test_quant_attn_fwd_pv_matches_plain(dev, case):
    b, hq, hkv, sq, sk, d, precs, group, kw, with_corr = case
    q, k, v = _qkv(b, hq, hkv, sq, sk, d, torch.float32, dev, seed=21)
    precs = _PRECS[precs]
    qts = [quantize(q, precs[0]), quantize(k + 0.4, precs[1]),
           quantize(v, precs[2], QuantMode.BLOCK, QuantStrategy.SYMMETRIC, group)]
    corr = None
    if with_corr:
        corr = torch.randn((b, hq, 1, sk), generator=torch.Generator().manual_seed(3)).to(dev)
    n0 = dict(_kernels.launches)
    out, lse = quantized_attention_forward(*qts, None, corr, pv_int8=True, **kw)
    torch.cuda.synchronize()
    assert _kernels.launches["quant_attn_fwd"] == n0.get("quant_attn_fwd", 0) + 1
    assert _kernels.launches["quant_attn_fwd/pv"] == n0.get("quant_attn_fwd/pv", 0) + 1
    want, want_lse = quantized_attention_forward_plain(*qts, None, corr, pv_int8=True, **kw)
    _check(out, lse, want, want_lse, 1e-3, 1e-3)


@pytest.mark.parametrize("case", QSPARSE_CASES[:5])
def test_quant_attn_fwd_pv_walks_a_block_mask_as_the_plain_version(dev, case):
    b, hq, hkv, sq, sk, d, kind = case
    mask = _walk_mask(kind, b, hq, sq, sk, dev)
    q, k, v = _qkv(b, hq, hkv, sq, sk, d, torch.float32, dev, seed=12)
    qts = [quantize(q), quantize(k + 0.4),
           quantize(v, Precision.INT8, QuantMode.BLOCK, QuantStrategy.SYMMETRIC, mask.block_k)]
    args = (*qts, mask.bias, None, mask.block_map, mask.fetch_kv)
    out, lse = quantized_attention_forward(*args, block_q=mask.block_q, block_k=mask.block_k,
                                           pv_int8=True)
    torch.cuda.synchronize()
    want, want_lse = quantized_attention_forward_plain(*args, block_q=mask.block_q,
                                                       block_k=mask.block_k, pv_int8=True)
    _check(out, lse, want, want_lse, 1e-3, 1e-3)


@pytest.mark.parametrize("route", ["fused", "two_pass"])
def test_pv_int8_quantized_training_on_the_card_matches_the_cpu(dev, route, monkeypatch):
    # Both routes' forward (PV kernels) and the STE backward (rows 8-9 on
    # the per-chunk or per-tile V scales) against the plain path on the CPU.
    from umfa_tpu_torch.engine.config import QuantizationConfig as QC
    from umfa_tpu_torch.ops.quant_attention import quantized_flash_attention

    if route == "two_pass":
        monkeypatch.setenv("UMFA_DISABLE_FUSED_QUANT", "1")
    cfg = dataclasses.replace(QC(), pv_int8=True)
    q, k, v = _qkv(2, 4, 2, 512, 512, 64, torch.float32, torch.device("cpu"), seed=31)
    w = torch.randn(q.shape, generator=torch.Generator().manual_seed(4))
    res = []
    for device in (dev, torch.device("cpu")):
        t = [x.to(device).requires_grad_(True) for x in (q, k, v)]
        n0 = dict(_kernels.launches)
        out = quantized_flash_attention(*t, config=cfg, causal=True)
        (out * w.to(device)).sum().backward()
        if device.type == "cuda":
            torch.cuda.synchronize()
            key = "fused_qattn/pv" if route == "fused" else "quant_attn_fwd/pv"
            assert _kernels.launches[key] == n0.get(key, 0) + 1
            assert _kernels.launches["quant_bwd_dq"] == n0.get("quant_bwd_dq", 0) + 1
        res.append([x.detach().cpu() for x in (out, *(x.grad for x in t))])
    for got, want, name in zip(*res, ("out", "dq", "dk", "dv")):
        assert rel_err(got, want) <= 1e-3, name


def _launches_of(fn):
    """fn()'s result and the kernel launches it made."""
    n0 = dict(_kernels.launches)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: n - n0.get(k, 0) for k, n in _kernels.launches.items() if n - n0.get(k, 0)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("indexer", [None, 16])
def test_mla_forward_through_the_kernel_matches_the_plain_versions(dev, dtype, indexer,
                                                                   monkeypatch):
    # models/mla_model.py at a small size (dim 256, 4 heads of 64, latent
    # 32, B2 S128, causal): one flash_fwd launch, with and without the
    # indexer's (B, 1, S, S) bias; against the same forward with the
    # wrapper's plain version (fp32 2e-5, bf16 1e-2, the forward's gates).
    from umfa_tpu_torch.models import mla_model
    from umfa_tpu_torch.ops import flash_fwd as ff

    cfg = mla_model.MLAConfig(dim=256, num_heads=4, latent_dim=32, indexer_topk=indexer,
                              dtype="float32" if dtype == torch.float32 else "bfloat16")
    model = mla_model.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    x = torch.randn((2, 128, 256), generator=torch.Generator().manual_seed(1)).to(dev, dtype)
    with torch.no_grad():
        got, counts = _launches_of(lambda: mla_model.forward(model, x, cfg))
        assert counts == {"flash_fwd": 1}
        monkeypatch.setattr(ff, "_launch", ff._plain)
        want, plain_counts = _launches_of(lambda: mla_model.forward(model, x, cfg))
    assert plain_counts == {}
    assert torch.isfinite(got).all() and got.dtype == dtype
    assert rel_err(got, want) <= TOLS[dtype][0]


def test_mla_deepseek_forward_and_decode_on_the_card(dev, monkeypatch):
    # The reduced fp32 DeepSeek of tests/test_models.py:143-147: the forward
    # launches flash_fwd once a layer and matches the plain versions (logits
    # atol 1e-5); decode launches nothing and holds its forward (5e-3).
    from umfa_tpu_torch.models import deepseek
    from umfa_tpu_torch.ops import flash_fwd as ff

    cfg = deepseek.DeepSeekConfig(vocab=64, dim=128, num_heads=4, latent_dim=16, depth=2,
                                  num_experts=4, top_k=2, n_shared=1, moe_hidden=64,
                                  dtype="float32")
    model = deepseek.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    tokens = torch.randint(0, 64, (2, 12), generator=torch.Generator().manual_seed(2)).to(dev)
    with torch.no_grad():
        (logits, aux), counts = _launches_of(lambda: deepseek.forward(model, tokens, cfg))
    assert counts == {"flash_fwd": cfg.depth}
    caches = deepseek.init_caches(cfg, 2, 12, device=dev)
    (dec, _), dec_counts = _launches_of(lambda: deepseek.decode_step(model, tokens, caches, cfg))
    assert dec_counts == {}
    torch.testing.assert_close(dec, logits[:, -1], atol=5e-3, rtol=5e-3)
    monkeypatch.setattr(ff, "_launch", ff._plain)
    with torch.no_grad():
        want, _ = deepseek.forward(model, tokens, cfg)
    torch.testing.assert_close(logits, want, atol=1e-5, rtol=0)
    assert float(aux) >= cfg.depth * (1 - 1e-5)
