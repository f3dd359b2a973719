"""Port parity: the quantized-weight GEMMs (ops/gemm.py).

Weights and activations come from numpy (tests/test_gemm.py's shapes).

Tolerances: scales rtol 1e-6 and codes at most one apart (JAX's
absmax / qmax can land one ulp off the exact division, ROADMAP.md Queue 3,
"Scale rounding", and a centered column's mean may differ by an ulp, which
moves its absmax: 107 of 256 centered scales here; either can move a code
at a rounding boundary); means atol 1e-6. `quantized_matmul` is held to JAX on
JAX's own QuantizedWeight: W8A16 and W4A16 relerr 1e-6 (exact products,
fp32 sums in other orders), W8A8 relerr 1e-3 (an activation code may move
by one, as the scales above); and each mode to x @ W at tests/test_gemm.py's
gates. W8A8's integer sums equal an int64 product exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umfa_tpu.engine.config import Precision as JPrecision
from umfa_tpu.ops import gemm as jgemm
from umfa_tpu_torch.engine.config import Precision
from umfa_tpu_torch.ops import gemm
from umfa_tpu_torch.utils.testing import rel_err

PREC = {"int8": (JPrecision.INT8, Precision.INT8), "int4": (JPrecision.INT4, Precision.INT4)}
GATES = {"int8": 0.01, "int4": 0.12}


def _wx(seed, k=128, n=256, m=64, shift=0.0):
    rng = np.random.default_rng(seed)
    w = (rng.normal(0, 1, (k, n)) + shift * rng.normal(0, 1, (1, n))).astype(np.float32)
    return w, rng.normal(0, 1, (m, k)).astype(np.float32)


def _to_port(jqw, precision):
    """JAX's QuantizedWeight as the port's."""
    means = None if jqw.means is None else torch.from_numpy(np.array(jqw.means))
    return gemm.QuantizedWeight(values=torch.from_numpy(np.array(jqw.values)),
                                scales=torch.from_numpy(np.array(jqw.scales)), means=means,
                                precision=precision, orig_dtype=torch.float32)


@pytest.mark.parametrize("prec", ["int8", "int4"])
@pytest.mark.parametrize("center", [False, True])
def test_quantize_weight_matches_jax(prec, center):
    jp, tp = PREC[prec]
    w, _ = _wx(0, shift=3.0 if center else 0.0)
    jqw = jgemm.quantize_weight(jnp.asarray(w), jp, center=center)
    qw = gemm.quantize_weight(torch.from_numpy(w), tp, center=center)
    assert qw.values.dtype == torch.int8 and tuple(qw.values.shape) == jqw.values.shape
    assert qw.scales.dtype == torch.float32 and qw.orig_dtype == torch.float32
    np.testing.assert_allclose(qw.scales.numpy(), np.asarray(jqw.scales), rtol=1e-6)
    codes = gemm._codes(qw).numpy().astype(np.int32)
    jcodes = np.asarray(jgemm.unpack_int4(jqw.values.T).T if prec == "int4" else jqw.values,
                        np.int32)
    assert np.abs(codes - jcodes).max() <= 1
    if center:
        np.testing.assert_allclose(qw.means.numpy(), np.asarray(jqw.means), atol=1e-6)
    else:
        assert qw.means is None and jqw.means is None


@pytest.mark.parametrize("prec", ["int8", "int4"])
def test_dequantize_weight_matches_jax(prec):
    jp, tp = PREC[prec]
    w, _ = _wx(1, shift=2.0)
    jqw = jgemm.quantize_weight(jnp.asarray(w), jp, center=True)
    got = gemm.dequantize_weight(_to_port(jqw, tp))
    np.testing.assert_allclose(got.numpy(), np.asarray(jgemm.dequantize_weight(jqw)),
                               atol=1e-6, rtol=1e-6)
    assert gemm.dequantize_weight(_to_port(jqw, tp), torch.bfloat16).dtype == torch.bfloat16
    own = gemm.dequantize_weight(gemm.quantize_weight(torch.from_numpy(w), tp, center=True))
    assert rel_err(own, w) < {"int8": 0.01, "int4": 0.13}[prec]


@pytest.mark.parametrize("mode", ["w8a16", "w4a16", "w8a8"])
@pytest.mark.parametrize("center", [False, True])
def test_quantized_matmul_matches_jax(mode, center):
    prec = "int4" if mode == "w4a16" else "int8"
    jp, tp = PREC[prec]
    act = (JPrecision.INT8, Precision.INT8) if mode == "w8a8" else (None, None)
    w, x = _wx(2, shift=3.0 if center else 0.0)
    jqw = jgemm.quantize_weight(jnp.asarray(w), jp, center=center)
    want = np.asarray(jgemm.quantized_matmul(jnp.asarray(x), jqw, activation_precision=act[0]))
    got = gemm.quantized_matmul(torch.from_numpy(x), _to_port(jqw, tp),
                                activation_precision=act[1])
    assert got.dtype == torch.float32 and got.shape == (64, 256)
    assert rel_err(got, want) <= (1e-3 if mode == "w8a8" else 1e-6)
    # The port's own weights against x @ W (tests/test_gemm.py's gates).
    own = gemm.quantized_matmul(torch.from_numpy(x),
                                gemm.quantize_weight(torch.from_numpy(w), tp, center=center),
                                activation_precision=act[1])
    assert rel_err(own, x @ w) < (0.02 if mode == "w8a8" else GATES[prec])


def test_w4a16_error_at_the_card_shape_matches_jax():
    # chip_smoke.py's shape, x (4096, 1024) @ W (1024, 1024): both packages'
    # W4A16 error against x @ W, equal to 1e-3 and below chip_smoke.py's
    # W4A16_GATE (0.15; test_gemm.py's 0.12 is a K 128 gate, and a longer
    # column's larger absmax makes the INT4 step coarser).
    w, x = _wx(6, k=1024, n=1024, m=4096)
    want = x @ w
    jerr = rel_err(jgemm.quantized_matmul(jnp.asarray(x), jgemm.quantize_weight(
        jnp.asarray(w), JPrecision.INT4)), want)
    err = rel_err(gemm.quantized_matmul(torch.from_numpy(x), gemm.quantize_weight(
        torch.from_numpy(w), Precision.INT4)), want)
    assert abs(err - jerr) <= 1e-3 and err < 0.15 and jerr < 0.15


def test_centering_helps_shifted_int4_weights():
    # tests/test_gemm.py:43-55: columns with large means.
    rng = np.random.default_rng(3)
    w = (rng.normal(0, 0.1, (128, 128)) + rng.normal(0, 3, (1, 128))).astype(np.float32)
    x = torch.from_numpy(rng.normal(0, 1, (32, 128)).astype(np.float32))
    want = x.numpy() @ w
    tw = torch.from_numpy(w)
    plain = rel_err(gemm.quantized_matmul(x, gemm.quantize_weight(tw, Precision.INT4)), want)
    centered = rel_err(gemm.quantized_matmul(
        x, gemm.quantize_weight(tw, Precision.INT4, center=True)), want)
    assert centered < plain / 2


@pytest.mark.parametrize("k", [64, 1024, 4096])
def test_w8a8_integer_sums_are_exact(k):
    rng = np.random.default_rng(k)
    a = rng.integers(-128, 128, (16, k), dtype=np.int64)
    b = rng.integers(-128, 128, (k, 8), dtype=np.int64)
    a[0], b[:, 0] = -128, -128  # the largest sum: k · 2**14
    got = gemm.int8_matmul(torch.from_numpy(a).to(torch.int8), torch.from_numpy(b).to(torch.int8))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy().astype(np.int64), a @ b)
    want = jnp.einsum("mk,kn->mn", jnp.asarray(a, jnp.int8), jnp.asarray(b, jnp.int8),
                      preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), np.asarray(want))


def test_batched_inputs_and_bf16():
    # tests/test_gemm.py:66-73, and a bf16 x keeps its dtype.
    w, _ = _wx(4, k=64, n=64)
    x = np.random.default_rng(5).normal(0, 1, (2, 3, 16, 64)).astype(np.float32)
    qw = gemm.quantize_weight(torch.from_numpy(w), Precision.INT8)
    out = gemm.quantized_matmul(torch.from_numpy(x), qw)
    assert out.shape == (2, 3, 16, 64)
    assert rel_err(out, np.einsum("...k,kn->...n", x, w)) < 0.01
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert gemm.quantized_matmul(xb, qw).dtype == torch.bfloat16
    assert gemm.quantized_matmul(xb, qw, activation_precision=Precision.INT8).dtype == \
        torch.bfloat16
