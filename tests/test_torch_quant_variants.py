"""Port parity: the quantized recipes beyond symmetric ROW — BLOCK and
ASYMMETRIC on the single-launch route (table row 7), INT4, the Q-mean
`score_corr` row and ASYMMETRIC on the two-pass route (row 5), their STE
gradients, and HYBRID picking BLOCK — against the JAX package.

The same numpy inputs go through the JAX functions (Pallas kernels in
interpret mode on the CPU) and the port's plain PyTorch versions on the CPU.

Tolerances, with their reasons:
  * `fused_quantize_attend`: out relerr <= 1e-3 and LSE abs <= 1e-3 (with
    the Hadamard rotation >= 99.5 % of the rows within 1e-3 and every row
    3e-2), as tests/test_torch_quant_fused.py states them: the reference
    rounds P against a running max where it walks more than one tile, and
    a rotated value an ulp apart may cross a rounding boundary. Codes at
    most one apart and >= 99.9 % equal; scales rtol 1e-6; zero points at
    most one apart and >= 99.9 % equal (a code's neighbour); the group and
    mode equal to the reference's.
  * the STE routes (`quantized_flash_attention`): out relerr <= 1e-3, LSE
    abs <= 1e-3 fused and 1e-5 two-pass (the two-pass forward walks one
    KV tile at these sizes, so P rounds at the same point), q/k/v
    gradients relerr <= 5e-3 (the reference's STE contract for INT8,
    tests/test_quantized_attention.py:402-409; measured <= 3e-5 here).
  * `quantized_attention_forward` on the reference's own residuals: out
    relerr <= 1e-4 and LSE abs <= 1e-5, as tests/test_torch_quant_attention.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umfa_tpu.engine.config import BlockSizeConfig as JBlockSizeConfig
from umfa_tpu.engine.config import Precision as JPrecision
from umfa_tpu.engine.config import QuantizationConfig as JQuantizationConfig
from umfa_tpu.engine.config import QuantMode as JQuantMode
from umfa_tpu.engine.config import QuantStrategy as JQuantStrategy
from umfa_tpu.ops import quant as jquant
from umfa_tpu.ops import quant_fused_attn as jqfa
from umfa_tpu.ops.quant_attention import quantized_attention_forward as jax_qattn
from umfa_tpu.ops.quant_attention import quantized_flash_attention as jqflash
from umfa_tpu_torch.engine.config import (
    BlockSizeConfig,
    Precision,
    QuantizationConfig,
    QuantMode,
    QuantStrategy,
)
from umfa_tpu_torch.ops import quant
from umfa_tpu_torch.ops.quant import QuantizedTensor
from umfa_tpu_torch.ops.quant_attention import (
    quantized_attention_forward,
    quantized_flash_attention,
)
from umfa_tpu_torch.ops.quant_fused_attn import effective_group, fused_quantize_attend
from umfa_tpu_torch.utils.testing import rel_err

SYM, ASYM = QuantStrategy.SYMMETRIC, QuantStrategy.ASYMMETRIC
ROW, BLOCK = QuantMode.ROW, QuantMode.BLOCK


def _x(seed, shape, offset=0.0):
    return (np.random.default_rng(seed).normal(0, 1, shape) + offset).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _codes(qt):
    vals = qt.values if isinstance(qt.values, torch.Tensor) else _t(qt.values)
    return (quant.unpack_int4(vals) if qt.precision.value == "int4" else vals).to(torch.int32)


def _close_ints(a, b):
    diff = (a.to(torch.int64) - b.to(torch.int64)).abs()
    return int(diff.max()) <= 1 and float((diff == 0).double().mean()) >= 0.999


def _j(e, jcls):
    return jcls(e.value)


# ---- row 7: fused_quantize_attend under BLOCK and ASYMMETRIC ----

INT8 = ("int8", "int8", "int8")
INT4 = ("int4", "int4", "int8")
QDENSE = ("bf16", "int8", "int8")

FUSED_CASES = [
    # id, (B, Hq, Hkv, Sq, Sk, D), dtype, precisions, strategy, mode, kwargs,
    # quant_blocks (q, k, v) or None
    ("block_int8_causal_gqa", (2, 4, 2, 256, 256, 64), "float32", INT8, SYM, BLOCK,
     dict(causal=True, smooth=True, smooth_q=False), None),
    ("block_int4_recipe_causal", (2, 4, 2, 256, 256, 64), "float32", INT4, SYM, BLOCK,
     dict(causal=True, smooth=True, smooth_q=True, hadamard=True), None),
    # S 96 under the default Q group of 128: the tile (128) holds 32 of the
    # reference's zero-padded rows, which count in the last group.
    ("block_int8_s96_padded_group", (1, 4, 2, 96, 96, 64), "float32", INT8, SYM, BLOCK,
     dict(causal=True, smooth=True, smooth_q=True), None),
    # Requests the reference's clamp changes: 512 → the 128-row tile, 48 →
    # 32, 200 → 128.
    ("block_int8_s96_clamped_groups", (1, 4, 2, 96, 96, 64), "float32", INT8, SYM, BLOCK,
     dict(causal=True, smooth=True, smooth_q=True), (512, 48, 200)),
    ("asym_int8_causal_gqa", (2, 4, 2, 256, 256, 64), "float32", INT8, ASYM, ROW,
     dict(causal=True, smooth=True, smooth_q=False), None),
    ("asym_int4_window", (1, 4, 2, 256, 256, 32), "float32", INT4, ASYM, ROW,
     dict(window=(48, 0), smooth=True, smooth_q=True, hadamard=True), None),
    ("asym_int8_bias_nosmooth", (1, 4, 4, 160, 160, 32), "float32", INT8, ASYM, ROW,
     dict(smooth=False, bias=True), None),
    ("asym_block_int8_bf16", (1, 4, 2, 160, 160, 64), "bfloat16", INT8, ASYM, BLOCK,
     dict(causal=True, smooth=True, smooth_q=True), None),
    ("asym_qdense_causal", (2, 4, 2, 256, 256, 64), "float32", QDENSE, ASYM, ROW,
     dict(causal=True, smooth=True), None),
    ("block_int4_d128", (1, 4, 2, 160, 160, 128), "float32", INT4, SYM, BLOCK,
     dict(causal=True, smooth=True, smooth_q=True, hadamard=True), None),
    ("asym_int8_d256", (1, 2, 1, 96, 96, 256), "float32", INT8, ASYM, ROW,
     dict(causal=True, smooth=True, smooth_q=True), None),
]


def _run_fused(case):
    _, (b, hq, hkv, sq, sk, d), dtype, prec, strategy, mode, kw, qb = case
    kw = dict(kw)
    bias = _x(9, (1, hq, sq, sk)) if kw.pop("bias", False) else None
    q, k, v = _x(2, (b, hq, sq, d)), _x(3, (b, hkv, sk, d), 0.5), _x(4, (b, hkv, sk, d), 0.3)
    jkw = dict(kw, q_precision=JPrecision(prec[0]), k_precision=JPrecision(prec[1]),
               v_precision=JPrecision(prec[2]), strategy=_j(strategy, JQuantStrategy),
               mode=_j(mode, JQuantMode))
    tkw = dict(kw, q_precision=Precision(prec[0]), k_precision=Precision(prec[1]),
               v_precision=Precision(prec[2]), strategy=strategy, mode=mode)
    if qb is not None:
        jkw["quant_blocks"], tkw["quant_blocks"] = JBlockSizeConfig(*qb), BlockSizeConfig(*qb)
    want = jqfa.fused_quantize_attend(
        *(jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v)),
        None if bias is None else jnp.asarray(bias), out_dtype=jnp.float32, interpret=True,
        **jkw)
    got = fused_quantize_attend(
        *(torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v)),
        None if bias is None else torch.from_numpy(bias), out_dtype=torch.float32, **tkw)
    return want, got


@pytest.mark.parametrize("case", FUSED_CASES, ids=[c[0] for c in FUSED_CASES])
def test_fused_variants_match_jax(case):
    want, got = _run_fused(case)
    j_out, j_lse = np.asarray(want[0]), np.asarray(want[1])
    assert got[0].shape == j_out.shape and got[0].dtype == torch.float32
    assert rel_err(got[0], j_out) <= 1e-3
    vis = j_lse > -1e29
    lse_err = np.abs(got[1].numpy()[vis] - j_lse[vis])
    if case[6].get("hadamard"):
        assert (lse_err <= 1e-3).mean() >= 0.995 and lse_err.max() <= 3e-2
    else:
        assert lse_err.max() <= 1e-3
    np.testing.assert_array_equal(got[1].numpy()[~vis], j_lse[~vis])
    for name, jt, tt in zip("qkv", want[2:5], got[2:5]):
        if jt is None:
            assert tt is None and name == "q"
            continue
        assert (tt.mode.value, tt.strategy.value, tt.block_size) == (
            jt.mode.value, jt.strategy.value, jt.block_size), name
        assert tt.values.shape == jt.values.shape and tt.row_sums is None
        assert _close_ints(_codes(tt), _codes(jt)), name
        np.testing.assert_allclose(tt.scales.numpy(), np.asarray(jt.scales), rtol=1e-6, atol=0)
        if jt.zero_points is None:
            assert tt.zero_points is None
        else:
            assert tt.zero_points.dtype == torch.int32
            assert tt.zero_points.shape == jt.zero_points.shape
            assert _close_ints(tt.zero_points, _t(jt.zero_points)), name
    for name, jm, tm in zip(("qm", "vm"), want[5:], got[5:]):
        assert (jm is None) == (tm is None), name
        if tm is not None:
            assert rel_err(tm, np.asarray(jm)) <= 1e-6, name


@pytest.mark.parametrize("requested,tile,want", [
    (128, 2048, 128), (64, 1024, 64), (512, 128, 128), (48, 256, 32), (200, 128, 128),
    (1, 256, 8), (96, 384, 64), (256, 384, 128),
])
def test_effective_group_is_the_reference_rule(requested, tile, want):
    # The reference's `_grp` (quant_fused_attn.py:982-1000), by hand: floor
    # to a power of two (at least 8), clamp to the tile, halve until it
    # divides the tile.
    assert effective_group(requested, tile) == want


# ---- the STE routes: quantized_flash_attention, fused and two-pass ----

ROUTE_CASES = [
    # id, recipe, mode, strategy, kwargs, bias, env
    ("fused_block_int8_causal", "int8", "block", SYM, dict(causal=True), False, {}),
    ("fused_block_int4_window", "int4", "block", SYM, dict(window=(48, 0)), False, {}),
    ("fused_asym_int8_bias", "int8", "row", ASYM, {}, True, {}),
    ("fused_asym_int4_causal", "int4", "row", ASYM, dict(causal=True), False, {}),
    ("two_pass_int4_causal", "int4", "row", SYM, dict(causal=True), False,
     {"UMFA_DISABLE_FUSED_QUANT": "1"}),
    ("two_pass_asym_int8_causal", "int8", "row", ASYM, dict(causal=True), False,
     {"UMFA_DISABLE_FUSED_QUANT": "1"}),
    ("two_pass_block_int8_window", "int8", "block", SYM, dict(window=(32, 0)), False,
     {"UMFA_DISABLE_FUSED_QUANT": "1"}),
    ("two_pass_asym_int4_bias", "int4", "row", ASYM, {}, True,
     {"UMFA_DISABLE_FUSED_QUANT": "1"}),
]


def _configs(recipe, mode, strategy):
    jcfg = dataclasses.replace(JQuantizationConfig.from_mode_string(recipe, mode),
                               strategy=_j(strategy, JQuantStrategy))
    tcfg = dataclasses.replace(QuantizationConfig.from_mode_string(recipe, mode),
                               strategy=strategy)
    return jcfg, tcfg


@pytest.mark.parametrize("case", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_ste_routes_match_jax(case, monkeypatch):
    name, recipe, mode, strategy, kw, use_bias, env = case
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    q, k, v = _x(1, (2, 4, 128, 64)), _x(2, (2, 2, 128, 64), 0.5), _x(3, (2, 2, 128, 64), 0.3)
    bias = _x(4, (1, 4, 128, 128)) if use_bias else None
    w, w_lse = _x(5, q.shape), _x(6, q.shape[:3])
    jcfg, tcfg = _configs(recipe, mode, strategy)

    def jloss(q, k, v):
        out, lse = jqflash(q, k, v, None if bias is None else jnp.asarray(bias), config=jcfg,
                           interpret=True, return_lse=True, **kw)
        return jnp.sum(out * w) + jnp.sum(lse * w_lse), (out, lse)

    (_, (j_out, j_lse)), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out, lse = quantized_flash_attention(*t, None if bias is None else torch.from_numpy(bias),
                                         config=tcfg, return_lse=True, **kw)
    ((out * torch.from_numpy(w)).sum() + (lse * torch.from_numpy(w_lse)).sum()).backward()
    assert rel_err(out.detach(), np.asarray(j_out)) <= 1e-3
    lse_tol = 1e-5 if name.startswith("two_pass") else 1e-3
    assert np.abs(lse.detach().numpy() - np.asarray(j_lse)).max() <= lse_tol
    for gname, tg, jg in zip(("dq", "dk", "dv"), t, jgrads):
        assert rel_err(tg.grad, np.asarray(jg)) <= 5e-3, gname


def test_hybrid_picking_block_matches_jax_in_block_mode():
    q, k, v = _x(7, (1, 4, 128, 64)), _x(8, (1, 2, 128, 64), 0.5), _x(9, (1, 2, 128, 64))
    q[:, :, 5] *= 100.0  # one outlier row: max/mean row range > 16 → BLOCK
    assert quant.choose_mode(torch.from_numpy(q)) == BLOCK
    assert jquant.choose_mode(jnp.asarray(q)) == JQuantMode.BLOCK
    w = _x(10, q.shape)
    jcfg = JQuantizationConfig.from_mode_string("int8", "block")
    tcfg = QuantizationConfig.from_mode_string("int8", "hybrid")

    def jloss(q, k, v):
        out = jqflash(q, k, v, config=jcfg, causal=True, interpret=True)
        return jnp.sum(out * w), out

    (_, j_out), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = quantized_flash_attention(*t, config=tcfg, causal=True)
    (out * torch.from_numpy(w)).sum().backward()
    assert rel_err(out.detach(), np.asarray(j_out)) <= 1e-3
    for gname, tg, jg in zip(("dq", "dk", "dv"), t, jgrads):
        assert rel_err(tg.grad, np.asarray(jg)) <= 5e-3, gname


# ---- row 5: quantized_attention_forward on INT4, ASYMMETRIC and score_corr ----


def _port_qt(jt) -> QuantizedTensor:
    """A JAX QuantizedTensor carried into the port."""
    return QuantizedTensor(values=_t(jt.values), scales=_t(jt.scales),
                           zero_points=_t(jt.zero_points), row_sums=_t(jt.row_sums),
                           precision=Precision(jt.precision.value), mode=QuantMode(jt.mode.value),
                           strategy=QuantStrategy(jt.strategy.value), block_size=jt.block_size,
                           orig_shape=tuple(jt.orig_shape), orig_dtype=torch.float32)


QFWD_CASES = [
    # id, (B, Hq, Hkv, Sq, Sk, D), precisions, strategy, mode, kwargs, corr, bias
    ("int4_qk_causal_corr", (2, 4, 2, 160, 192, 64), INT4, SYM, ROW, dict(causal=True), True,
     False),
    ("int4_all_window", (1, 4, 2, 96, 160, 64), ("int4",) * 3, SYM, ROW, dict(window=(48, 0)),
     False, False),
    ("asym_int8_causal", (2, 4, 2, 160, 192, 64), INT8, ASYM, ROW, dict(causal=True), False,
     False),
    ("asym_int4_corr_bias", (1, 4, 2, 96, 160, 64), INT4, ASYM, ROW, {}, True, True),
    ("asym_tensor_corr", (1, 4, 2, 128, 128, 64), INT8, ASYM, QuantMode.TENSOR,
     dict(causal=True), True, False),
    # D 66 under INT4: the card unpacks and zero-pads the codes to 80.
    ("int4_corr_d66", (1, 2, 1, 96, 160, 66), INT4, SYM, ROW, dict(causal=True), True, False),
    ("asym_int8_d256", (1, 2, 1, 96, 160, 256), INT8, ASYM, ROW, dict(causal=True), True,
     False),
]


@pytest.mark.parametrize("case", QFWD_CASES, ids=[c[0] for c in QFWD_CASES])
def test_quantized_attention_forward_variants_match_jax(case):
    _, (b, hq, hkv, sq, sk, d), prec, strategy, mode, kw, use_corr, use_bias = case
    q, k, v = _x(11, (b, hq, sq, d)), _x(12, (b, hkv, sk, d), 0.4), _x(13, (b, hkv, sk, d), 0.2)
    jm, js = _j(mode, JQuantMode), _j(strategy, JQuantStrategy)
    jts = [jquant.quantize(jnp.asarray(x), JPrecision(p), jm, js)
           for x, p in zip((q, k, v), prec)]
    corr = _x(14, (b, hq, 1, sk)) if use_corr else None
    bias = _x(15, (1, 1, sq, sk)) if use_bias else None
    j_out, j_lse = jax_qattn(*jts, None if bias is None else jnp.asarray(bias),
                             None if corr is None else jnp.asarray(corr), interpret=True, **kw)
    t_out, t_lse = quantized_attention_forward(
        *(_port_qt(jt) for jt in jts), None if bias is None else torch.from_numpy(bias),
        None if corr is None else torch.from_numpy(corr), **kw)
    j_out, j_lse = np.asarray(j_out), np.asarray(j_lse)
    assert t_out.dtype == torch.float32
    assert rel_err(t_out, j_out) <= 1e-4
    vis = j_lse > -1e29
    np.testing.assert_allclose(t_lse.numpy()[vis], j_lse[vis], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(t_lse.numpy()[~vis], j_lse[~vis])
