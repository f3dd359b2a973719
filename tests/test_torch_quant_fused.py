"""Port parity: the row quantizer (table row 6) and the single-launch
quantize-attend forward (row 7) against the JAX package.

The same numpy inputs go through the JAX functions (Pallas kernels in
interpret mode on the CPU) and the port's plain PyTorch versions on the CPU.

Tolerances, with their reasons:
  * `quantize_rows_fused`: codes (and packed INT4 bytes) bit-identical
    without the Hadamard rotation (the same fp32 subtraction, division and
    round-half-even); scales rtol 1e-6: the port divides absmax by qmax
    exactly, XLA turns the division by the constant into a multiply by its
    reciprocal (one ulp on ~3 % of the rows). With the rotation, codes at
    most one apart (the port rounds the float64 product x·H once, JAX sums
    the fp32 product in its own order, so a value on a .5 boundary can
    round either way).
  * `fused_quantize_attend`: out relerr <= 1e-3 and LSE abs <= 1e-3: both
    round the same operands to bf16 at the same points; the fp32 score sums
    run in another order, which can flip the bf16 rounding of a P element
    (one bf16 ulp of P moves a short row's LSE by ~1e-4). With the Hadamard
    rotation a code may differ by one (below), and one INT4 code of Q or K
    moves a row's scores by ~sq·k·scale, its LSE by up to ~1e-2: there
    >= 99.5 % of the rows hold 1e-3 and every row 3e-2. Residual codes at
    most one apart and >= 99.9 % equal (a mean or rotation an ulp apart
    moves a value across a rounding boundary); qm and vm relerr <= 1e-6
    (fp32 sums of the same rows in another order). Against the fp32
    `reference_attention`: the reference's own envelopes INT8_REL_ERR and
    INT4_REL_ERR (umfa_tpu/utils/testing.py:21, :33).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umfa_tpu.engine.config import Precision as JPrecision
from umfa_tpu.engine.config import QuantizationConfig as JQuantizationConfig
from umfa_tpu.engine.config import QuantStrategy as JQuantStrategy
from umfa_tpu.ops import flash_fwd as jflash_fwd
from umfa_tpu.ops import quant_fused as jquant_fused
from umfa_tpu.ops import quant_fused_attn as jqfa
from umfa_tpu.utils.testing import INT4_REL_ERR, INT8_REL_ERR
from umfa_tpu_torch.engine.config import Precision, QuantizationConfig, QuantMode, QuantStrategy
from umfa_tpu_torch.ops import quant
from umfa_tpu_torch.ops.attention import reference_attention
from umfa_tpu_torch.ops.quant_fused import quantize_rows_fused, quantize_rows_fused_plain
from umfa_tpu_torch.ops.quant_fused_attn import (
    default_mean_rows,
    fused_path_supported,
    fused_quantize_attend,
)
from umfa_tpu_torch.utils.testing import rel_err


def _x(seed, shape, offset=0.0):
    return (np.random.default_rng(seed).normal(0, 1, shape) + offset).astype(np.float32)


def _codes(qt):
    vals = qt.values if isinstance(qt.values, torch.Tensor) else torch.from_numpy(np.array(qt.values))
    prec = qt.precision.value
    return (quant.unpack_int4(vals) if prec == "int4" else vals).to(torch.int32)


def _jprec(p):
    return JPrecision(p.value)


# ---- row 6: quantize_rows_fused ----


@pytest.mark.parametrize("precision", [Precision.INT8, Precision.INT4])
@pytest.mark.parametrize("hadamard", [False, True], ids=["plain", "hadamard"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_fused_matches_jax(precision, hadamard, dtype):
    x = _x(0, (2, 3, 100, 64), offset=0.4)
    mean = x.mean(axis=2, keepdims=True)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jt = jquant_fused.quantize_rows_fused(jx, jnp.asarray(mean), precision=_jprec(precision),
                                          hadamard=hadamard, interpret=True)
    tt = quantize_rows_fused(tx, torch.from_numpy(mean), precision=precision, hadamard=hadamard)
    assert tt.values.shape == jt.values.shape and tt.scales.shape == jt.scales.shape
    assert tt.orig_shape == tuple(x.shape) and tt.orig_dtype == tx.dtype
    assert (tt.mode, tt.strategy) == (QuantMode.ROW, QuantStrategy.SYMMETRIC)
    np.testing.assert_allclose(tt.scales.numpy(), np.asarray(jt.scales), rtol=1e-6, atol=0)
    if hadamard:
        diff = (_codes(tt) - _codes(jt)).abs()
        assert diff.max() <= 1 and (diff == 0).float().mean() >= 0.999
    else:
        # Packed INT4 bytes identical: the codes and the split-halves layout.
        np.testing.assert_array_equal(tt.values.numpy(), np.asarray(jt.values))


@pytest.mark.parametrize("precision", [Precision.INT8, Precision.INT4])
def test_quantize_rows_fused_plain_is_quantize_of_centered(precision):
    x = torch.from_numpy(_x(1, (1, 2, 70, 32), offset=-0.2))
    mean = x.mean(dim=2, keepdim=True)
    got = quantize_rows_fused_plain(x, mean, precision=precision)
    want = quant.quantize(x - mean, precision, QuantMode.ROW)
    assert torch.equal(got.values, want.values) and torch.equal(got.scales, want.scales)
    no_mean = quantize_rows_fused(x, precision=precision)
    assert torch.equal(no_mean.values, quant.quantize(x, precision, QuantMode.ROW).values)
    with pytest.raises(ValueError):
        quantize_rows_fused(x[..., :31], precision=Precision.INT4)
    with pytest.raises(ValueError):
        quantize_rows_fused(x[..., :24], hadamard=True)


# ---- row 7: fused_quantize_attend ----

INT8 = dict(q_precision=Precision.INT8, k_precision=Precision.INT8, v_precision=Precision.INT8)
INT4 = dict(q_precision=Precision.INT4, k_precision=Precision.INT4, v_precision=Precision.INT8)
QDENSE = dict(q_precision=Precision.BF16, k_precision=Precision.INT8, v_precision=Precision.INT8)

FUSED_CASES = [
    # id, (B, Hq, Hkv, Sq, Sk, D), dtype, precisions, kwargs, JAX BlockSizes (None = default)
    ("int8_causal_gqa", (2, 4, 2, 256, 256, 64), "float32", INT8,
     dict(causal=True, smooth=True, smooth_q=False), None),
    ("int4_recipe_causal", (2, 4, 2, 256, 256, 64), "float32", INT4,
     dict(causal=True, smooth=True, smooth_q=True, hadamard=True), None),
    ("int8_smooth_off_bias", (1, 4, 4, 160, 160, 32), "float32", INT8,
     dict(smooth=False, bias="1hqk"), None),
    ("int8_smooth_q_padded_bf16", (2, 4, 2, 160, 160, 64), "bfloat16", INT8,
     dict(causal=True, smooth=True, smooth_q=True), None),
    ("qdense_causal", (2, 4, 2, 256, 256, 64), "float32", QDENSE,
     dict(causal=True, smooth=True), None),
    ("int4_window_blocks", (1, 4, 2, 256, 256, 32), "float32", INT4,
     dict(window=(48, 0), smooth=True, smooth_q=True, hadamard=True), (128, 256)),
    ("int8_left_window_empty_rows", (1, 4, 2, 256, 64, 64), "float32", INT8,
     dict(window=(64, -1), smooth=True, smooth_q=False), None),
    # D 128: the CUDA kernel's second template width (fp32 row sum).
    ("int8_smooth_q_bias_d128", (1, 4, 2, 160, 160, 128), "float32", INT8,
     dict(causal=True, smooth=True, smooth_q=True, bias="11qk"), None),
    ("int4_recipe_d128", (1, 4, 2, 160, 160, 128), "float32", INT4,
     dict(causal=True, smooth=True, smooth_q=True, hadamard=True), None),
    # D 256: the kernel's third template width (bf16 Q tile, 32-key tiles).
    ("int8_causal_d256", (1, 4, 2, 96, 96, 256), "float32", INT8,
     dict(causal=True, smooth=True, smooth_q=True), None),
    ("int8_hadamard_causal_d256", (1, 2, 1, 96, 96, 256), "bfloat16", INT8,
     dict(causal=True, smooth=True, smooth_q=True, hadamard=True), None),
]


def _bias(kind, b, hq, sq, sk):
    shape = {"1hqk": (1, hq, sq, sk), "11qk": (1, 1, sq, sk)}[kind]
    return _x(9, shape)


def _run_both(case):
    _, (b, hq, hkv, sq, sk, d), dtype, prec, kw, blocks = case
    kw = dict(kw)
    bias = kw.pop("bias", None)
    bias = None if bias is None else _bias(bias, b, hq, sq, sk)
    q, k, v = _x(2, (b, hq, sq, d)), _x(3, (b, hkv, sk, d), 0.5), _x(4, (b, hkv, sk, d), 0.3)
    jkw = dict(kw, q_precision=_jprec(prec["q_precision"]),
               k_precision=_jprec(prec["k_precision"]), v_precision=_jprec(prec["v_precision"]))
    mean_rows = None
    if blocks is not None:
        # Explicit BlockSizes: the JAX kernel tiles (and estimates its means)
        # at these sizes; the port gets the matching mean_rows.
        jkw["block_sizes"] = jflash_fwd.BlockSizes(block_q=blocks[0], block_k=blocks[1])
        mean_rows = blocks
    jdt = getattr(jnp, dtype)
    want = jqfa.fused_quantize_attend(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), None if bias is None else jnp.asarray(bias),
        out_dtype=jnp.float32, interpret=True, **jkw)
    tdt = getattr(torch, dtype)
    got = fused_quantize_attend(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
        None if bias is None else torch.from_numpy(bias), out_dtype=torch.float32,
        mean_rows=mean_rows, **kw, **prec)
    return (q, k, v, bias), want, got


@pytest.mark.parametrize("case", FUSED_CASES, ids=[c[0] for c in FUSED_CASES])
def test_fused_quantize_attend_matches_jax(case):
    (q, k, v, bias), want, got = _run_both(case)
    j_out, j_lse = np.asarray(want[0]), np.asarray(want[1])
    t_out, t_lse = got[0], got[1]
    assert t_out.shape == j_out.shape and t_out.dtype == torch.float32
    assert rel_err(t_out, j_out) <= 1e-3
    vis = j_lse > -1e29
    lse_err = np.abs(t_lse.numpy()[vis] - j_lse[vis])
    if case[4].get("hadamard"):
        assert (lse_err <= 1e-3).mean() >= 0.995 and lse_err.max() <= 3e-2
    else:
        assert lse_err.max() <= 1e-3
    np.testing.assert_array_equal(t_lse.numpy()[~vis], j_lse[~vis])
    if case[0] == "int8_left_window_empty_rows":
        # Rows past Sk + 64 see no key: out exactly 0 (no V mean), LSE -1e30.
        assert (~vis).sum() == 4 * (256 - 128)
        np.testing.assert_array_equal(t_out.numpy()[~vis], 0.0)
    for name, jt, tt in zip("qkv", want[2:5], got[2:5]):
        if jt is None:
            assert tt is None and name == "q"
            continue
        assert tt.values.shape == jt.values.shape and tt.precision.value == jt.precision.value
        diff = (_codes(tt) - _codes(jt)).abs()
        assert diff.max() <= 1 and (diff == 0).float().mean() >= 0.999, name
        np.testing.assert_allclose(tt.scales.numpy(), np.asarray(jt.scales), rtol=1e-5)
    for name, jm, tm in zip(("qm", "vm"), want[5:], got[5:]):
        assert (jm is None) == (tm is None), name
        if tm is not None:
            assert tm.shape == jm.shape
            assert rel_err(tm, np.asarray(jm)) <= 1e-6, name
    # The fp32 oracle, at the reference's envelopes.
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    kw = case[4]
    oracle = reference_attention(tq, tk, tv, None if bias is None else torch.from_numpy(bias),
                                 causal=kw.get("causal", False), window=kw.get("window"))
    env = INT4_REL_ERR if case[3] is INT4 else INT8_REL_ERR
    assert rel_err(t_out, oracle) <= env


def test_fused_quantize_attend_without_residuals_and_out_dtypes():
    q, k, v = (torch.from_numpy(_x(s, (1, 2, 128, 32))) for s in (5, 6, 7))
    full = fused_quantize_attend(q, k, v, causal=True)
    bare = fused_quantize_attend(q, k, v, causal=True, emit_residuals=False)
    assert bare[2:] == (None,) * 5
    assert torch.equal(full[0], bare[0]) and torch.equal(full[1], bare[1])
    assert full[0].dtype == torch.float32
    half = fused_quantize_attend(q.half(), k.half(), v.half(), causal=True)
    assert half[0].dtype == torch.float16 and half[2].orig_dtype == torch.float16
    bf = fused_quantize_attend(q.bfloat16(), k.bfloat16(), v.bfloat16(), causal=True)
    assert bf[0].dtype == torch.bfloat16 and bf[1].dtype == torch.float32


@pytest.mark.parametrize("shape", [
    # (Sq, Sk, D, causal, window, bias)
    (4096, 4096, 64, True, None, False),
    (4096, 4096, 64, True, None, True),
    (256, 256, 64, True, None, False),
    (160, 160, 32, False, None, False),
    (256, 64, 64, False, (64, -1), False),
    (4608, 4608, 128, False, None, False),
    (1000, 1000, 64, False, (128, 0), False),
    (3072, 3072, 64, True, None, False),
])
def test_default_mean_rows_are_the_reference_tiles(shape):
    sq, sk, d, causal, window, has_bias = shape
    masked = causal or window is not None
    bs = jflash_fwd.BlockSizes()
    block_k = jflash_fwd._choose_block(min(bs.block_k, 1024) if masked else bs.block_k, sk, d)
    block_q = jflash_fwd._choose_block(bs.fwd_q_request(masked), sq, d)
    if jflash_fwd._rect_mode_ok(causal=causal, window=window, has_bias=has_bias, has_map=False,
                                has_fetch=False, default_blocks=True, block_k=block_k,
                                seq_q=sq, seq_k=sk):
        block_q = 2 * block_k
    got = default_mean_rows(sq, sk, d, causal=causal, window=window, has_bias=has_bias)
    assert got == (block_q, block_k)
    if shape[:4] == (4096, 4096, 64, True) and not has_bias:
        assert got == (2048, 1024)


def test_fused_path_rules_match_jax(monkeypatch):
    cases = [  # (config string, Sq, Sk, D, causal, window)
        ("int8", 256, 256, 64, True, None),
        ("int8", 128, 256, 64, True, None),      # Sq != Sk under a right bound: two-pass
        ("int8", 128, 256, 64, False, (32, -1)),  # left-only window: fused
        ("int8", 16384, 16384, 64, False, None),  # long KV: two-pass
        ("int4", 256, 256, 63, False, None),      # odd D under INT4: two-pass
        ("int8-qdense", 256, 256, 64, True, None),
    ]
    for cfg_s, sq, sk, d, causal, window in cases:
        tcfg = QuantizationConfig.from_mode_string(cfg_s)
        jcfg = JQuantizationConfig.from_mode_string(cfg_s)
        want = jqfa.fused_path_supported(jcfg, sk, d, None, None, None, causal=causal,
                                         window=window, seq_q=sq)
        assert fused_path_supported(tcfg, sk, d, causal=causal, window=window,
                                    seq_q=sq) == want
    tensor = QuantizationConfig.from_mode_string("int8", "tensor")
    assert not fused_path_supported(tensor, 256, 64, causal=False, window=None, seq_q=256)
    monkeypatch.setenv("UMFA_DISABLE_FUSED_QUANT", "1")
    assert not fused_path_supported(QuantizationConfig(), 256, 64, causal=False,
                                    window=None, seq_q=256)
    monkeypatch.delenv("UMFA_DISABLE_FUSED_QUANT")
    sym, asym = QuantStrategy.SYMMETRIC, QuantStrategy.ASYMMETRIC
    for cfg_s, mode, strategy, pv_int8 in (("int8", "block", sym, False),
                                           ("int4", "block", sym, False),
                                           ("int8", "row", asym, False),
                                           ("int8", "row", asym, True)):
        tcfg = dataclasses.replace(QuantizationConfig.from_mode_string(cfg_s, mode),
                                   strategy=strategy, pv_int8=pv_int8)
        jcfg = dataclasses.replace(JQuantizationConfig.from_mode_string(cfg_s, mode),
                                   strategy=JQuantStrategy(strategy.value), pv_int8=pv_int8)
        want = jqfa.fused_path_supported(jcfg, 256, 64, None, None, None, causal=True,
                                         window=None, seq_q=256)
        assert fused_path_supported(tcfg, 256, 64, causal=True, window=None, seq_q=256) == want
    # pv_int8 (symmetric) takes the single-launch route, as in the reference
    # (its values against JAX: tests/test_torch_quant_pv_int8.py).
    pv = dataclasses.replace(QuantizationConfig(), pv_int8=True)
    jpv = dataclasses.replace(JQuantizationConfig(), pv_int8=True)
    assert fused_path_supported(pv, 256, 64, causal=False, window=None, seq_q=256)
    assert jqfa.fused_path_supported(jpv, 256, 64, None, None, None, causal=False, window=None,
                                     seq_q=256)
