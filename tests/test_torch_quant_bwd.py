"""Port parity: the STE backward on quantized residuals (table rows 8 and 9).

The JAX single-launch forward (interpret mode) makes the residuals; the
same residuals, out, LSE, dO and dlse go through the JAX
`quantized_attention_backward` (interpret mode) and the port's plain
PyTorch version on the CPU.

Tolerances, with their reasons:
  * port vs JAX: relerr <= 2e-3. Both dequantize to the same bf16 operands
    and round dS and P to bf16 at the same points, but the fp32 sums run in
    another order (JAX adds per tile and scales each tile's dQ), which can
    flip the bf16 rounding of a dS element.
  * port vs the dense backward (`ops/flash_bwd.flash_attention_backward_plain`)
    on the dequantized fp32 operands: the reference's contract,
    tests/test_quantized_attention.py:402-409 — relerr 5e-3 for INT8, 2e-2
    for INT4 (bf16 operands in the quantized backward against fp32 in the
    dense one).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umfa_tpu.engine.config import Precision as JPrecision
from umfa_tpu.ops import quant_bwd as jquant_bwd
from umfa_tpu.ops import quant_fused_attn as jqfa
from umfa_tpu.ops.quant_attention import _corr_from_quantized as jcorr
from umfa_tpu_torch.engine.config import Precision, QuantMode, QuantStrategy
from umfa_tpu_torch.ops.flash_bwd import flash_attention_backward_plain
from umfa_tpu_torch.ops.quant import QuantizedTensor, dequantize, quantize
from umfa_tpu_torch.ops.quant_attention import _corr_from_quantized, quantized_attention_forward
from umfa_tpu_torch.ops.quant_bwd import quantized_attention_backward
from umfa_tpu_torch.utils.testing import rel_err


def _x(seed, shape, offset=0.0):
    return (np.random.default_rng(seed).normal(0, 1, shape) + offset).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _qt(jt) -> QuantizedTensor:
    """A JAX QuantizedTensor carried into the port."""
    return QuantizedTensor(values=_t(jt.values), scales=_t(jt.scales), zero_points=None,
                           row_sums=None, precision=Precision(jt.precision.value),
                           mode=QuantMode(jt.mode.value), strategy=QuantStrategy(jt.strategy.value),
                           block_size=jt.block_size, orig_shape=tuple(jt.orig_shape),
                           orig_dtype=torch.float32)


CASES = [
    # id, (B, Hq, Hkv, S, D), int4 recipe, kwargs, bias, dlse
    ("int8_causal_gqa", (2, 4, 2, 256, 64), False, dict(causal=True), False, False),
    ("int4_causal_dlse", (2, 4, 2, 256, 64), True, dict(causal=True), False, True),
    ("int8_window_bias_dlse", (1, 4, 4, 160, 32), False, dict(window=(40, 8)), True, True),
    ("int4_bias_gqa", (1, 4, 2, 128, 64), True, {}, True, False),
    ("int8_d128_causal_dlse", (1, 4, 2, 128, 128), False, dict(causal=True), False, True),
    ("int4_d256_window_bias", (1, 2, 1, 128, 256), True, dict(window=(40, 8)), True, False),
]


def _residuals(case):
    _, (b, hq, hkv, s, d), int4, kw, use_bias, use_dlse = case
    q, k, v = _x(1, (b, hq, s, d)), _x(2, (b, hkv, s, d), 0.5), _x(3, (b, hkv, s, d), 0.3)
    bias = _x(4, (1, hq, s, s)) if use_bias else None
    p4 = JPrecision.INT4 if int4 else JPrecision.INT8
    out, lse, qt_q, qt_k, qt_v, qm, vm = jqfa.fused_quantize_attend(
        *(jnp.asarray(x) for x in (q, k, v)), None if bias is None else jnp.asarray(bias),
        smooth=True, smooth_q=int4, hadamard=int4, q_precision=p4, k_precision=p4,
        out_dtype=jnp.float32, interpret=True, **kw)
    do = _x(5, out.shape)
    dlse = _x(6, lse.shape) if use_dlse else None
    return dict(qt=(qt_q, qt_k, qt_v), out=out, lse=lse, do=do, qm=qm, vm=vm, bias=bias,
                dlse=dlse, kw=kw, int4=int4)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_quantized_backward_matches_jax(case):
    r = _residuals(case)
    jqt = r["qt"]
    jc = None if r["qm"] is None else jcorr(r["qm"], jqt[1])
    want = jquant_bwd.quantized_attention_backward(
        *jqt, r["out"], r["lse"], jnp.asarray(r["do"]), r["qm"], r["vm"], jc,
        None if r["bias"] is None else jnp.asarray(r["bias"]),
        None if r["dlse"] is None else jnp.asarray(r["dlse"]), interpret=True, **r["kw"])
    tqt = [_qt(t) for t in jqt]
    qm, vm = _t(r["qm"]), _t(r["vm"])
    corr = None if qm is None else _corr_from_quantized(qm, tqt[1])
    if jc is not None:
        assert rel_err(corr, np.asarray(jc)) <= 1e-6
    got = quantized_attention_backward(
        *tqt, _t(r["out"]), _t(r["lse"]), _t(r["do"]), qm, vm, corr, _t(r["bias"]),
        _t(r["dlse"]), **r["kw"])
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert rel_err(g, np.asarray(w)) <= 2e-3, name
    bf = quantized_attention_backward(
        *tqt, _t(r["out"]), _t(r["lse"]), _t(r["do"]), qm, vm, corr, _t(r["bias"]),
        _t(r["dlse"]), grad_dtype=torch.bfloat16, **r["kw"])
    for g, f in zip(bf, got):
        assert g.dtype == torch.bfloat16 and rel_err(g, f) <= 4e-3  # bf16 storage of the same sums


@pytest.mark.parametrize("case", CASES[:2], ids=[c[0] for c in CASES[:2]])
def test_quantized_backward_matches_dense_on_dequantized(case):
    r = _residuals(case)
    tqt = [_qt(t) for t in r["qt"]]
    qm, vm = _t(r["qm"]), _t(r["vm"])
    corr = None if qm is None else _corr_from_quantized(qm, tqt[1])
    out, lse, do = _t(r["out"]), _t(r["lse"]), _t(r["do"])
    dlse = _t(r["dlse"])
    got = quantized_attention_backward(*tqt, out, lse, do, qm, vm, corr, None, dlse, **r["kw"])
    q_dq, k_dq, v_dq = (dequantize(t, torch.float32) for t in tqt)
    if qm is not None:
        q_dq = q_dq + qm
    if vm is not None:
        v_dq = v_dq + vm
    want = flash_attention_backward_plain(q_dq, k_dq, v_dq, out, lse, do, None, dlse, **r["kw"])
    tol = 2e-2 if r["int4"] else 5e-3
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert rel_err(g, w) < tol, name


def test_quantized_backward_takes_tensor_scales_and_masked_rows():
    # Per-(b, h) scales (the TENSOR route) and rows with no visible key.
    g = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(s, generator=g) for s in ((1, 2, 96, 32), (1, 2, 64, 32), (1, 2, 64, 32)))
    qts = [quantize(x, Precision.INT8, QuantMode.TENSOR) for x in (q, k, v)]
    out, lse = quantized_attention_forward(*qts, window=(0, -1))
    do = torch.randn(out.shape, generator=g)
    dq, dk, dv = quantized_attention_backward(*qts, out, lse, do, window=(0, -1))
    assert (lse[..., 64:] == -1e30).all() and (dq[:, :, 64:] == 0).all()
    # Per-(b, h) scales read as the same scale on every row.
    rows = [dataclasses.replace(t, scales=t.scales.expand(*t.scales.shape[:2], t.orig_shape[2], 1))
            for t in qts]
    want = quantized_attention_backward(*rows, out, lse, do, window=(0, -1))
    for name, a, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert torch.equal(a, w), name
    # ASYMMETRIC residuals take the dequantize-and-dense route, as in the
    # reference: this backward refuses them and names that route.
    asym = [quantize(x, strategy=QuantStrategy.ASYMMETRIC) for x in (q, k, v)]
    with pytest.raises(ValueError, match="flash_attention_backward"):
        quantized_attention_backward(*asym, out, lse, do)
