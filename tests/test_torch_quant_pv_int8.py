"""Port parity: `pv_int8`, the integer P·V of the single-launch route (table
row 7, chunked local max) and of the two-pass route (row 5), through
`fused_quantize_attend`, `quantized_attention_forward`,
`quantized_flash_attention` with its STE gradients (rows 8 and 9 on the
per-chunk or per-tile V scales), `attention()` and the GPT — against the
JAX package.

The same numpy inputs go through the JAX functions (Pallas kernels in
interpret mode on the CPU) and the port's plain PyTorch versions on the CPU.

Tolerances, with their reasons:
  * `fused_quantize_attend`: out relerr <= 1e-3 and LSE abs <= 1e-3 (the
    fused route's gates, tests/test_torch_quant_fused.py): P's codes depend
    only on each chunk's own max, but the reference rescales each chunk by
    exp(ml − m) against its running max and the port against the final
    max; with the Hadamard rotation, as in tests/test_torch_quant_variants.py,
    >= 99.5 % of the rows within 1e-3 and every row 3e-2. V's residual codes
    at most one apart and >= 99.9 % equal, scales rtol 1e-6, its group the
    reference's pv_chunk.
  * `quantized_attention_forward` on the reference's own residuals at one
    KV tile: out relerr <= 1e-4 and LSE abs <= 1e-5, as
    tests/test_torch_quant_attention.py (one tile: the reference's running
    max is the final max, so P codes round at the same points).
  * the STE routes: out relerr <= 1e-3, LSE <= 1e-3, q/k/v gradients
    relerr <= 5e-3 (the reference's STE contract for INT8,
    tests/test_quantized_attention.py:402-409).
  * the GPT: loss within 1e-4, every parameter's gradient relerr <= 1e-2,
    as tests/test_torch_quant_training.py.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import umfa_tpu
import umfa_tpu_torch
from umfa_tpu.engine.config import Precision as JPrecision
from umfa_tpu.engine.config import QuantizationConfig as JQuantizationConfig
from umfa_tpu.engine.config import QuantMode as JQuantMode
from umfa_tpu.engine.config import QuantStrategy as JQuantStrategy
from umfa_tpu.models import gpt as jgpt
from umfa_tpu.ops import block_mask as jbm
from umfa_tpu.ops import quant as jquant
from umfa_tpu.ops import quant_fused_attn as jqfa
from umfa_tpu.ops.flash_fwd import BlockSizes as JBlockSizes
from umfa_tpu.ops.quant_attention import quantized_attention_forward as jax_qattn
from umfa_tpu.ops.quant_attention import quantized_flash_attention as jqflash
from umfa_tpu_torch.engine.config import Precision, QuantizationConfig, QuantMode, QuantStrategy
from umfa_tpu_torch.models import gpt
from umfa_tpu_torch.ops import block_mask as tbm
from umfa_tpu_torch.ops import quant
from umfa_tpu_torch.ops import quant_fused_attn as tqfa
from umfa_tpu_torch.ops.flash_fwd import BlockSizes
from umfa_tpu_torch.ops.quant import QuantizedTensor
from umfa_tpu_torch.ops.quant_attention import (
    quantized_attention_forward,
    quantized_flash_attention,
)
from umfa_tpu_torch.ops.quant_fused_attn import (
    LN_P_AMP,
    fused_path_supported,
    fused_quantize_attend,
    pv_chunk_of,
)
from umfa_tpu_torch.utils.testing import rel_err


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


def _pv(cfg):
    return dataclasses.replace(cfg, pv_int8=True)


# ---- row 7: fused_quantize_attend(pv_int8=True) ----

INT8 = ("int8", "int8", "int8")
V_INT4 = ("int8", "int8", "int4")
QDENSE = ("bf16", "int8", "int8")
ROW, BLOCK = QuantMode.ROW, QuantMode.BLOCK

FUSED_CASES = [
    # id, (B, Hq, Hkv, Sq, Sk, D), precisions, mode, kwargs
    # Non-causal S 512: one 512-key tile, two 256-key chunks.
    ("s512_two_chunks", (1, 2, 2, 512, 512, 64), INT8, ROW, dict(smooth=True)),
    # Causal S 512: equal 512 tiles, the reference's diagonal sub-tiles (w 256).
    ("causal_diagonal", (1, 2, 2, 512, 512, 64), INT8, ROW, dict(causal=True)),
    # Sk 320 in a 384-key tile: pv_chunk 128, 64 zero-padded rows in the last chunk.
    ("kv_tail_chunk128", (1, 2, 2, 192, 320, 64), INT8, ROW, dict(smooth=True)),
    ("window", (1, 2, 2, 256, 256, 64), INT8, ROW, dict(window=(48, 16))),
    ("gqa_4_2_causal", (2, 4, 2, 256, 256, 64), INT8, ROW, dict(causal=True)),
    ("d128_causal", (1, 2, 2, 256, 256, 128), INT8, ROW, dict(causal=True)),
    ("v_int4", (1, 2, 2, 256, 256, 64), V_INT4, ROW, dict(causal=True)),
    ("block_qk", (1, 4, 2, 256, 256, 64), INT8, BLOCK, dict(causal=True)),
    ("dense_q", (1, 2, 2, 256, 256, 64), QDENSE, ROW, dict(causal=True)),
    ("smoothing_off", (1, 2, 2, 256, 256, 64), INT8, ROW, dict(causal=True, smooth=False)),
    ("smooth_q_hadamard", (1, 2, 2, 256, 256, 64), INT8, ROW,
     dict(causal=True, smooth_q=True, hadamard=True)),
    ("bias_bf16", (1, 2, 2, 192, 192, 32), INT8, ROW, dict(bias=True, dtype="bfloat16")),
]


def _fused_inputs(shape, seed=2):
    b, hq, hkv, sq, sk, d = shape
    return (_x(seed, (b, hq, sq, d)), _x(seed + 1, (b, hkv, sk, d), 0.5),
            _x(seed + 2, (b, hkv, sk, d), 0.3))


def _run_fused(shape, prec, mode, kw, bias=None, block_mask=None):
    kw = dict(kw)
    dtype = kw.pop("dtype", "float32")
    if kw.pop("bias", False):
        bias = _x(9, (1, shape[1], shape[3], shape[4]))
    q, k, v = _fused_inputs(shape)
    jkw = dict(kw, q_precision=JPrecision(prec[0]), k_precision=JPrecision(prec[1]),
               v_precision=JPrecision(prec[2]), mode=JQuantMode(mode.value))
    tkw = dict(kw, q_precision=Precision(prec[0]), k_precision=Precision(prec[1]),
               v_precision=Precision(prec[2]), mode=mode)
    jb = None if bias is None else jnp.asarray(bias)
    tb = None if bias is None else torch.from_numpy(bias)
    if block_mask is not None:
        jm, tm = block_mask
        jb, tb = jm.bias, tm.bias
        jkw.update(block_map=jm.block_map, fetch_kv=jm.fetch_kv, hold_kv=jm.hold_kv,
                   fill_kv=jm.fill_kv, block_sizes=JBlockSizes(jm.block_q, jm.block_k))
        tkw.update(block_map=tm.block_map, fetch_kv=tm.fetch_kv, hold_kv=tm.hold_kv,
                   fill_kv=tm.fill_kv, block_q=tm.block_q, block_k=tm.block_k)
    want = jqfa.fused_quantize_attend(
        *(jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v)), jb, pv_int8=True,
        out_dtype=jnp.float32, interpret=True, **jkw)
    got = fused_quantize_attend(
        *(torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v)), tb, pv_int8=True,
        out_dtype=torch.float32, **tkw)
    return want, got


def _check_fused(want, got, hadamard=False):
    j_out, j_lse = np.asarray(want[0]), np.asarray(want[1])
    assert got[0].shape == j_out.shape and got[0].dtype == torch.float32
    assert rel_err(got[0], j_out) <= 1e-3
    vis = j_lse > -1e29
    lse_err = np.abs(got[1].numpy()[vis] - j_lse[vis])
    if hadamard:
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
        assert _close_ints(_codes(tt), _codes(jt)), name
        np.testing.assert_allclose(tt.scales.numpy(), np.asarray(jt.scales), rtol=1e-6, atol=0)
    for name, jm, tm in zip(("qm", "vm"), want[5:], got[5:]):
        assert (jm is None) == (tm is None), name
        if tm is not None:
            assert rel_err(tm, np.asarray(jm)) <= 1e-6, name


@pytest.mark.parametrize("case", FUSED_CASES, ids=[c[0] for c in FUSED_CASES])
def test_fused_pv_int8_matches_jax(case):
    _, shape, prec, mode, kw = case
    want, got = _run_fused(shape, prec, mode, kw)
    _check_fused(want, got, hadamard=kw.get("hadamard", False))
    # V's residual is BLOCK with the reference's chunk, whatever the mode.
    sk = shape[4]
    assert got[4].mode == QuantMode.BLOCK and got[4].block_size in (128, 256)
    assert got[4].block_size == want[4].block_size <= sk + 127


def test_fused_pv_int8_under_a_block_mask_matches_jax():
    # Documents of 128 rows, causal, 128 x 128 tiles: pv_chunk 128.
    s = 384
    seg = np.repeat(np.arange(3), 128)[None].repeat(2, 0).astype(np.int32)
    jm = jbm.segment_block_mask(jnp.asarray(seg), causal=True, block_sizes=JBlockSizes(128, 128))
    tm = tbm.segment_block_mask(torch.from_numpy(seg), causal=True,
                                block_sizes=BlockSizes(128, 128), device="cpu")
    want, got = _run_fused((2, 4, 2, s, s, 64), INT8, ROW, dict(smooth=True), block_mask=(jm, tm))
    _check_fused(want, got)
    assert got[4].block_size == 128


def test_pv_int8_keeps_the_square_causal_tiles():
    # The reference turns its rectangular causal mode (block_q = 2·block_k)
    # off under pv_int8 (quant_fused_attn.py:944), so the Q-mean window is
    # the square tile: causal S 4096 D 64 gives (1024, 1024), not (2048, 1024).
    kw = dict(causal=True, window=None, has_bias=False)
    assert tqfa.default_mean_rows(4096, 4096, 64, **kw) == (2048, 1024)
    assert tqfa.default_mean_rows(4096, 4096, 64, pv_int8=True, **kw) == (1024, 1024)


def test_pv_chunk_is_the_references():
    for block_k, want in ((128, 128), (256, 256), (384, 128), (1024, 256), (2048, 256),
                          (640, 128)):
        assert pv_chunk_of(block_k) == want


# ---- reference behaviours the port reproduces ----


def test_an_unseen_chunk_codes_one_and_is_removed_by_beta():
    # A chunk whose every lane a row cannot see: ml = −1e30, and
    # s − (ml − ln A) is 0 in fp32 (ln A is absorbed), so every lane codes
    # p̂ = round(exp(0)) = 1 in the reference, and in the port's plain
    # version; β = exp(ml − m) = 0 for a row that sees a key elsewhere.
    s = np.full((2, 256), -1e30, np.float32)
    ml = s.max(axis=-1, keepdims=True)
    j = np.asarray(jnp.round(jnp.exp(jnp.asarray(s) - (jnp.asarray(ml) - jqfa._LN_P_AMP_U))))
    st, mt = torch.from_numpy(s), torch.from_numpy(ml)
    t = (st - (mt - LN_P_AMP)).exp().round()
    assert np.all(j == 1.0) and torch.all(t == 1.0)
    assert LN_P_AMP == float(np.float32(jqfa._LN_P_AMP_U))
    m = torch.tensor([[3.0]])
    assert float(torch.exp(mt[:1] - m)) == 0.0
    # Through the kernel's arithmetic: a causal row's chunks past its
    # diagonal change nothing (the reference walks them with β = 0).
    want, got = _run_fused((1, 2, 2, 512, 512, 64), INT8, ROW, dict(causal=True))
    _check_fused(want, got)


def test_rows_that_see_no_key_average_the_walked_chunks_as_the_reference():
    # Window (64, unbounded right) with Sq > Sk: rows 320.. of an Sk 256 call
    # see no key. In the reference every lane of each chunk their query tile
    # walks codes 1 with β = 1, so such a row's output is the mean of the
    # dequantized V over the walked tiles' lanes (+ vm), its LSE −1e30; a
    # query tile that walks no tile gives 0. Sk 200: the walked tile holds
    # 56 zero-padded rows, each coding 0 − vm in the last chunk's scale.
    for shape in ((1, 2, 2, 512, 256, 64), (1, 2, 2, 400, 200, 64)):
        want, got = _run_fused(shape, INT8, ROW, dict(window=(64, -1), smooth=True))
        _check_fused(want, got)
        j_out, j_lse = np.asarray(want[0]), np.asarray(want[1])
        hidden = j_lse <= -1e29
        assert hidden.any()
        assert np.abs(j_out[hidden]).max() > 1e-3  # not zeroed: the walked chunks' mean
        np.testing.assert_allclose(got[0].numpy()[hidden], j_out[hidden], rtol=0, atol=2e-5)
    # A bias of −1e30 hides every key of some rows: the same rule, on the
    # reference's 256-row tiles.
    shape = (1, 2, 2, 256, 256, 64)
    bias = np.zeros((1, 2, 256, 256), np.float32)
    bias[:, :, 5:9] = -1e30
    want, got = _run_fused(shape, INT8, ROW, dict(causal=True), bias=bias)
    _check_fused(want, got)
    hidden = np.asarray(want[1]) <= -1e29
    assert hidden.sum() == 2 * 4
    np.testing.assert_allclose(got[0].numpy()[hidden], np.asarray(want[0])[hidden], rtol=0,
                               atol=2e-5)


# ---- row 5: quantized_attention_forward(pv_int8=True) ----


def _port_qt(jt) -> QuantizedTensor:
    """A JAX QuantizedTensor carried into the port."""
    return QuantizedTensor(values=_t(jt.values), scales=_t(jt.scales),
                           zero_points=_t(jt.zero_points), row_sums=_t(jt.row_sums),
                           precision=Precision(jt.precision.value), mode=QuantMode(jt.mode.value),
                           strategy=QuantStrategy(jt.strategy.value), block_size=jt.block_size,
                           orig_shape=tuple(jt.orig_shape), orig_dtype=torch.float32)


QFWD_CASES = [
    # id, (B, Hq, Hkv, Sq, Sk, D), precisions, kwargs, corr
    ("int8_causal_gqa", (2, 4, 2, 256, 256, 64), INT8, dict(causal=True), False),
    ("int8_window_tail", (1, 2, 2, 160, 200, 64), INT8, dict(window=(48, 0)), False),
    ("int4_corr", (1, 4, 2, 192, 256, 64), ("int4", "int4", "int8"), dict(causal=True), True),
    ("int4_v_d128", (1, 2, 1, 128, 256, 128), ("int8", "int8", "int4"), {}, False),
]


@pytest.mark.parametrize("case", QFWD_CASES, ids=[c[0] for c in QFWD_CASES])
def test_two_pass_pv_int8_matches_jax_at_one_kv_tile(case):
    _, (b, hq, hkv, sq, sk, d), prec, kw, with_corr = case
    q, k, v = _x(21, (b, hq, sq, d)), _x(22, (b, hkv, sk, d), 0.5), _x(23, (b, hkv, sk, d))
    # V per KV tile: the reference's tile at these sizes is one tile over Sk.
    tile = tqfa._choose_block(2048, sk, d)
    assert tile >= sk
    jq = jquant.quantize(jnp.asarray(q), JPrecision(prec[0]))
    jk = jquant.quantize(jnp.asarray(k), JPrecision(prec[1]))
    jv = jquant.quantize(jnp.asarray(v), JPrecision(prec[2]), JQuantMode.BLOCK,
                         JQuantStrategy.SYMMETRIC, tile)
    corr = _x(24, (b, hq, 1, sk)) if with_corr else None
    j_out, j_lse = jax_qattn(jq, jk, jv, score_corr=None if corr is None else jnp.asarray(corr),
                             pv_int8=True, interpret=True, **kw)
    t_out, t_lse = quantized_attention_forward(_port_qt(jq), _port_qt(jk), _port_qt(jv),
                                               score_corr=_t(corr), pv_int8=True, **kw)
    j_out, j_lse = np.asarray(j_out), np.asarray(j_lse)
    assert rel_err(t_out, j_out) <= 1e-4
    vis = j_lse > -1e29
    np.testing.assert_allclose(t_lse.numpy()[vis], j_lse[vis], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(t_lse.numpy()[~vis], j_lse[~vis])


def test_two_pass_pv_int8_over_several_groups_holds_the_int8_envelope():
    # Over several V groups (256-row BLOCK scales, Sk 1024) the reference
    # walks several KV tiles and codes P = rint(127·p) against its running
    # max, the port against the final max, so the codes differ wherever the
    # max moved (~0.6 % apart here): no bit-level parity exists, so hold
    # both to fp64 attention at the INT8 envelope of the reference's own
    # tests (relerr < 0.02, tests/test_quantized_attention.py:655-690), and
    # to each other within it.
    b, hq, hkv, s, d = 1, 2, 2, 1024, 64
    q, k, v = _x(31, (b, hq, s, d)), _x(32, (b, hkv, s, d)), _x(33, (b, hkv, s, d))
    jq, jk = jquant.quantize(jnp.asarray(q)), jquant.quantize(jnp.asarray(k))
    jv = jquant.quantize(jnp.asarray(v), JPrecision.INT8, JQuantMode.BLOCK,
                         JQuantStrategy.SYMMETRIC, 256)
    j_out, _ = jax_qattn(jq, jk, jv, pv_int8=True, causal=True, interpret=True,
                         block_sizes=JBlockSizes(256, 256))
    t_out, _ = quantized_attention_forward(_port_qt(jq), _port_qt(jk), _port_qt(jv),
                                           pv_int8=True, causal=True)
    sc = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k.astype(np.float64)) / math.sqrt(d)
    sc = np.where(np.tril(np.ones((s, s), bool)), sc, -np.inf)
    pr = np.exp(sc - sc.max(-1, keepdims=True))
    ref = np.einsum("bhqk,bhkd->bhqd", pr / pr.sum(-1, keepdims=True), v.astype(np.float64))
    assert rel_err(t_out, ref) < 0.02 and rel_err(torch.from_numpy(np.asarray(j_out)), ref) < 0.02
    assert rel_err(t_out, np.asarray(j_out)) < 0.02


def test_two_pass_pv_int8_refuses_what_it_cannot_factor():
    x = torch.from_numpy(_x(7, (1, 2, 96, 32)))
    qt = quant.quantize(x)
    with pytest.raises(ValueError, match="constant"):
        quantized_attention_forward(qt, qt, qt, pv_int8=True)  # ROW V scales
    asym = quant.quantize(x, strategy=QuantStrategy.ASYMMETRIC)
    with pytest.raises(ValueError, match="symmetric"):
        quantized_attention_forward(asym, asym, asym, pv_int8=True)
    tensor = quant.quantize(x, mode=QuantMode.TENSOR)
    out, _ = quantized_attention_forward(qt, qt, tensor, pv_int8=True)
    assert torch.isfinite(out).all()


# ---- the STE routes and the route rules ----

ROUTE_CASES = [
    # id, recipe, mode, kwargs, env
    ("fused_int8_causal", "int8", "row", dict(causal=True), {}),
    ("fused_int4_block", "int4", "block", dict(causal=True), {}),
    ("two_pass_int8_causal", "int8", "row", dict(causal=True),
     {"UMFA_DISABLE_FUSED_QUANT": "1"}),
    ("two_pass_int4", "int4", "row", {}, {"UMFA_DISABLE_FUSED_QUANT": "1"}),
]


def _configs(recipe, mode):
    return (_pv(JQuantizationConfig.from_mode_string(recipe, mode)),
            _pv(QuantizationConfig.from_mode_string(recipe, mode)))


@pytest.mark.parametrize("case", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_pv_int8_ste_routes_match_jax(case, monkeypatch):
    name, recipe, mode, kw, env = case
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    q, k, v = _x(1, (2, 4, 256, 64)), _x(2, (2, 2, 256, 64), 0.5), _x(3, (2, 2, 256, 64), 0.3)
    w, w_lse = _x(5, q.shape), _x(6, q.shape[:3])
    jcfg, tcfg = _configs(recipe, mode)

    def jloss(q, k, v):
        out, lse = jqflash(q, k, v, config=jcfg, interpret=True, return_lse=True, **kw)
        return jnp.sum(out * w) + jnp.sum(lse * w_lse), (out, lse)

    (_, (j_out, j_lse)), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out, lse = quantized_flash_attention(*t, config=tcfg, return_lse=True, **kw)
    ((out * torch.from_numpy(w)).sum() + (lse * torch.from_numpy(w_lse)).sum()).backward()
    assert rel_err(out.detach(), np.asarray(j_out)) <= 1e-3
    assert np.abs(lse.detach().numpy() - np.asarray(j_lse)).max() <= 1e-3
    for gname, tg, jg in zip(("dq", "dk", "dv"), t, jgrads):
        assert rel_err(tg.grad, np.asarray(jg)) <= 5e-3, gname


def test_pv_int8_route_rules_match_jax():
    for recipe, mode, strategy in (("int8", "row", "symmetric"), ("int4", "block", "symmetric"),
                                   ("int8", "row", "asymmetric"), ("int8-qdense", "row",
                                                                   "symmetric")):
        jcfg = dataclasses.replace(_pv(JQuantizationConfig.from_mode_string(recipe, mode)),
                                   strategy=JQuantStrategy(strategy))
        tcfg = dataclasses.replace(_pv(QuantizationConfig.from_mode_string(recipe, mode)),
                                   strategy=QuantStrategy(strategy))
        for sk, causal, sq in ((256, True, 256), (16384, False, 256), (512, True, 256)):
            want = jqfa.fused_path_supported(jcfg, sk, 64, None, None, None, causal=causal,
                                             window=None, seq_q=sq)
            assert fused_path_supported(tcfg, sk, 64, causal=causal, window=None,
                                        seq_q=sq) == want
    q = torch.from_numpy(_x(7, (1, 2, 64, 32)))
    asym = _pv(dataclasses.replace(QuantizationConfig(), strategy=QuantStrategy.ASYMMETRIC))
    with pytest.raises(ValueError, match="symmetric"):
        quantized_flash_attention(q, q, q, config=asym)


def test_attention_api_under_a_pv_int8_config():
    q, k, v = _x(41, (1, 4, 192, 64)), _x(42, (1, 2, 192, 64)), _x(43, (1, 2, 192, 64))
    jcfg, tcfg = _configs("int8", "row")
    try:
        umfa_tpu.set_quantization_mode(config=jcfg)
        umfa_tpu_torch.set_quantization_mode(config=tcfg)
        want = umfa_tpu.attention(*(jnp.asarray(x) for x in (q, k, v)), is_causal=True,
                                  interpret=True)
        got = umfa_tpu_torch.attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                       is_causal=True)
    finally:
        umfa_tpu.set_quantization_mode(None)
        umfa_tpu_torch.set_quantization_mode(None)
    assert rel_err(got, np.asarray(want)) <= 1e-3


# ---- the GPT with cfg.quantization = pv_int8 ----

JCFG = jgpt.GPTConfig(vocab=64, dim=128, num_heads=4, num_kv_heads=2, depth=2, max_seq=160,
                      interpret=True)
CFG = gpt.GPTConfig(vocab=64, dim=128, num_heads=4, num_kv_heads=2, depth=2, max_seq=160)


def _loss(model, tokens):
    logits = model(tokens[:, :-1]).float()
    return -torch.log_softmax(logits, dim=-1).gather(-1, tokens[:, 1:, None]).mean()


def _jloss(params, tokens, cfg):
    logits = jgpt.forward(params, tokens[:, :-1], cfg)
    lp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    return -jnp.mean(jnp.take_along_axis(lp, tokens[:, 1:, None], axis=-1))


@pytest.mark.parametrize("route", ["fused", "two_pass"])
def test_pv_int8_gpt_loss_and_every_gradient_match_jax(route, monkeypatch):
    if route == "two_pass":
        monkeypatch.setenv("UMFA_DISABLE_FUSED_QUANT", "1")
    jq, tq = _configs("int8", "row")
    jcfg = dataclasses.replace(JCFG, quantization=jq)
    cfg = dataclasses.replace(CFG, quantization=tq)
    jparams = jgpt.init_params(jax.random.PRNGKey(0), JCFG)
    tokens = np.random.default_rng(21).integers(0, CFG.vocab, (2, 129))
    want_loss, want = jax.value_and_grad(_jloss)(jparams, jnp.asarray(tokens), jcfg)
    model = gpt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    loss = _loss(model, torch.from_numpy(tokens))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-4
    named = {"embed": model.embed, "unembed": model.unembed}
    jflat = {"embed": want["embed"], "unembed": want["unembed"]}
    for i, block in enumerate(model.blocks):
        for name in ("wq", "wkv", "wo", "w1", "w2"):
            named[f"blocks.{i}.{name}"] = getattr(block, name)
            jflat[f"blocks.{i}.{name}"] = want["blocks"][i][name]
    for name, param in named.items():
        assert rel_err(param.grad, np.asarray(jflat[name])) <= 1e-2, name
