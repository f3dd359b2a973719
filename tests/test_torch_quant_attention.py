"""Port parity: quantization and the INT8 attention forward.

The same numpy inputs go through the JAX reference (quantizers eagerly; the
Pallas kernel in interpret mode on the CPU) and the port's plain PyTorch
versions on the CPU.

Tolerances: quantized values must be bit-identical (both round half to
even after the same fp32 division, and clip alike); scales rtol 1e-6.
`quantized_attention_forward`: out relerr <= 1e-4 and LSE abs <= 1e-5 —
both sides use the same int8 operands and round P and the dequantized V
tile to bf16 at the same points (the reference walks one KV tile at these
sizes); the rest is fp32 summation order (measured ~3e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umfa_tpu.engine.config import Precision as JPrecision
from umfa_tpu.engine.config import QuantMode as JQuantMode
from umfa_tpu.engine.config import QuantStrategy as JQuantStrategy
from umfa_tpu.ops import quant as jquant
from umfa_tpu.ops.quant_attention import quantized_attention_forward as jax_qattn
from umfa_tpu_torch.engine.config import (
    Precision,
    QuantizationConfig,
    QuantMode,
    QuantStrategy,
    env_flag,
)
from umfa_tpu_torch.ops import quant
from umfa_tpu_torch.ops.quant_attention import quantized_attention_forward
from umfa_tpu_torch.utils.testing import rel_err

B, HQ, HKV, D = 2, 4, 2, 64


def _x(seed, shape, outlier_rows=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, shape).astype(np.float32)
    if outlier_rows:
        x[..., 5, :] *= 100.0  # one outlier row: max/mean row range > 16 → BLOCK
    return x


def _jenum(e, jcls):
    return jcls(e.value)


@pytest.mark.parametrize("precision", [Precision.INT8, Precision.INT4])
@pytest.mark.parametrize("strategy", [QuantStrategy.SYMMETRIC, QuantStrategy.ASYMMETRIC])
@pytest.mark.parametrize("mode", [QuantMode.ROW, QuantMode.TENSOR, QuantMode.BLOCK])
def test_quantize_matches_jax_bitwise(precision, strategy, mode):
    x = _x(0, (B, HKV, 100, D)) + 0.3  # offset: asymmetric zero points are not 0
    jt = jquant.quantize(jnp.asarray(x), _jenum(precision, JPrecision),
                         _jenum(mode, JQuantMode), _jenum(strategy, JQuantStrategy), 32)
    tt = quant.quantize(torch.from_numpy(x), precision, mode, strategy, 32)
    np.testing.assert_array_equal(tt.values.numpy(), np.asarray(jt.values))
    np.testing.assert_allclose(tt.scales.numpy(), np.asarray(jt.scales), rtol=1e-6, atol=0)
    assert tt.scales.shape == jt.scales.shape
    if strategy == QuantStrategy.ASYMMETRIC:
        np.testing.assert_array_equal(tt.zero_points.numpy(), np.asarray(jt.zero_points))
        np.testing.assert_array_equal(tt.row_sums.numpy(), np.asarray(jt.row_sums))
    else:
        assert tt.zero_points is None and tt.row_sums is None
    np.testing.assert_allclose(quant.dequantize(tt).numpy(),
                               np.asarray(jquant.dequantize(jt)), rtol=1e-6, atol=1e-6)
    assert tt.compression_ratio == pytest.approx(jt.compression_ratio)


def test_int4_pack_unpack_and_hybrid_match_jax():
    rng = np.random.default_rng(1)
    vals = rng.integers(-8, 8, (3, 5, 16)).astype(np.int8)
    packed = quant.pack_int4(torch.from_numpy(vals))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jquant.pack_int4(jnp.asarray(vals))))
    np.testing.assert_array_equal(quant.unpack_int4(packed).numpy(), vals)
    for seed, outliers in ((2, False), (3, True)):
        x = _x(seed, (1, 2, 64, D), outlier_rows=outliers)
        assert quant.choose_mode(torch.from_numpy(x)).value == jquant.choose_mode(jnp.asarray(x)).value
        np.testing.assert_array_equal(
            quant.fake_quantize(torch.from_numpy(x)).numpy(),
            np.asarray(jquant.fake_quantize(jnp.asarray(x))))
    assert quant.choose_mode(torch.from_numpy(_x(3, (1, 2, 64, D), True))) == QuantMode.BLOCK


def test_config_copy():
    cfg = QuantizationConfig.from_mode_string("int4", "block")
    assert cfg.k_precision == Precision.INT4 and cfg.v_precision == Precision.INT8
    assert cfg.hadamard and cfg.effective_smooth_q()
    assert QuantizationConfig.from_mode_string("int8-qdense").q_precision == Precision.BF16
    assert not QuantizationConfig.from_mode_string("int8").effective_smooth_q()


def test_env_flag(monkeypatch):
    monkeypatch.setenv("UMFA_TEST_FLAG", "no")
    assert not env_flag("UMFA_TEST_FLAG", True)
    monkeypatch.setenv("UMFA_TEST_FLAG", "1")
    assert env_flag("UMFA_TEST_FLAG")
    monkeypatch.delenv("UMFA_TEST_FLAG")
    assert env_flag("UMFA_TEST_FLAG", True)


def _decode_bias(sq, sk, length):
    pos = np.arange(sk)[None, :]
    qpos = (length - sq + np.arange(sq))[:, None]
    bias = np.where((pos > qpos) | (pos >= length), -1e30, 0.0).astype(np.float32)
    return np.broadcast_to(bias, (B, 1, sq, sk)).copy()


QCASES = [
    # id, sq, sk, kwargs, bias, kv mode
    ("causal_sq_ne_sk", 160, 192, dict(causal=True), False, QuantMode.ROW),
    ("window_chunk_start", 16, 192, dict(window=(-1, 176)), False, QuantMode.ROW),
    ("bias_decode_route", 24, 192, {}, True, QuantMode.ROW),
    ("tensor_scales_window", 128, 128, dict(window=(32, 0)), False, QuantMode.TENSOR),
    ("fully_masked_rows", 200, 136, dict(window=(0, -1)), False, QuantMode.ROW),
]


@pytest.mark.parametrize("case", QCASES, ids=[c[0] for c in QCASES])
def test_quantized_attention_forward_matches_jax(case):
    _, sq, sk, kw, use_bias, kv_mode = case
    q, k, v = _x(4, (B, HQ, sq, D)), _x(5, (B, HKV, sk, D)), _x(6, (B, HKV, sk, D))
    bias = _decode_bias(sq, sk, sk - 4) if use_bias else None
    jm = _jenum(kv_mode, JQuantMode)
    j_out, j_lse = jax_qattn(
        jquant.quantize(jnp.asarray(q)), jquant.quantize(jnp.asarray(k), mode=jm),
        jquant.quantize(jnp.asarray(v), mode=jm),
        None if bias is None else jnp.asarray(bias), interpret=True, **kw)
    t_out, t_lse = quantized_attention_forward(
        quant.quantize(torch.from_numpy(q)), quant.quantize(torch.from_numpy(k), mode=kv_mode),
        quant.quantize(torch.from_numpy(v), mode=kv_mode),
        None if bias is None else torch.from_numpy(bias), **kw)
    j_out, j_lse = np.asarray(j_out), np.asarray(j_lse)
    assert t_out.dtype == torch.float32
    assert rel_err(t_out, j_out) <= 1e-4
    vis = j_lse > -1e29
    np.testing.assert_allclose(t_lse.numpy()[vis], j_lse[vis], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(t_lse.numpy()[~vis], j_lse[~vis])
    if case[0] == "fully_masked_rows":
        assert (~vis).sum() == B * HQ * (sq - sk)
        np.testing.assert_array_equal(t_out.numpy()[~vis], 0.0)


def test_quantized_attention_forward_refuses_unported():
    x = torch.from_numpy(_x(7, (1, 2, 32, D)))
    qt = quant.quantize(x)
    for bad in (dict(pv_int8=True), dict(score_corr=torch.zeros(1, 2, 1, 32)),
                dict(block_map=torch.ones(1, 1, 1, 1, dtype=torch.int32))):
        with pytest.raises(NotImplementedError):
            quantized_attention_forward(qt, qt, qt, **bad)
    for qt_bad in (quant.quantize(x, Precision.INT4),
                   quant.quantize(x, strategy=QuantStrategy.ASYMMETRIC)):
        with pytest.raises(NotImplementedError):
            quantized_attention_forward(qt_bad, qt_bad, qt_bad)
    qt.scales.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="training"):
        quantized_attention_forward(qt, qt, qt)
