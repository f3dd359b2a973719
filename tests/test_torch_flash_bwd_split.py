"""The fp32 backward kernels' 3xTF32 arithmetic, modelled in plain PyTorch.

On the card, `csrc/flash_bwd.cu` computes every product of the fp32 dense
backward on the tensor cores in 3xTF32: each fp32 operand x is split into
big = tf32(x) and small = tf32(x − big), both rounded to nearest with ties
away from zero (cvt.rna.tf32.f32: the low 13 bits of the fp32 encoding
cleared), and a·b is summed as small·big + big·small + big·big. P and dS are
split the same way from the scores. This file holds a model of that
arithmetic (the split on int32 bits, the split product, and the backward's
five products through it), kept here and not in the package, and checks:

  (a) the split: the low 13 bits of big and small are zero; big + small is
      within 2^-22 relative of x; ±0, −1e30 and subnormals survive (a
      subnormal to within half the tf32 spacing there, 2^-137);
  (b) the split backward against the port's exact fp32 plain version, to a
      relerr of 2e-6, and against the JAX package's fp32 backward (its
      Pallas kernels in interpret mode) at the fp32 tolerance of
      tests/test_torch_flash_bwd.py (atol = rtol = 1e-4);
  (c) a control: one TF32 pass on the same inputs lands at least 10× further
      from the plain version than the split, so a dropped term would show.

The model sums in fp32 with round-to-nearest (torch.matmul on the CPU). The
card's tensor cores truncate each mma's sum instead, which the kernels meet
by keeping their chains of mma short (csrc/bwd_tc.cuh); the card tests
(tests/test_torch_kernels_cuda.py) hold the kernels themselves to 5e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umfa_tpu.ops.flash_bwd import flash_attention_backward as jax_flash_backward
from umfa_tpu.ops.flash_fwd import flash_attention_forward as jax_flash_forward
from umfa_tpu_torch.ops.flash_bwd import _kernel_lse, _prepare, flash_attention_backward_plain
from umfa_tpu_torch.ops.flash_fwd import visible_mask
from umfa_tpu_torch.utils.testing import rel_err

FP32 = dict(atol=1e-4, rtol=1e-4)  # tests/test_torch_flash_bwd.py
SPLIT_VS_PLAIN = 2e-6


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on fp32 values: add half of the dropped 13 bits'
    range to the encoding and clear them (a carry rounds the exponent up)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def mm_split(a, b):
    """a @ b in 3xTF32: small·big + big·small + big·big."""
    (ab, asm), (bb, bsm) = split(a), split(b)
    return (asm @ bb + ab @ bsm) + ab @ bb


def mm_one_pass(a, b):
    return tf32_rna(a) @ tf32_rna(b)


def model_backward(p, mm):
    """The kernels' fp32 backward (ops/flash_bwd.py `_plain`) with every
    product taken by `mm`: S = Q·scale·Kᵀ, dP = dO·Vᵀ, dQ = scale·dS·K,
    dK = scale·dSᵀ·Q and dV = Pᵀ·dO, the GQA group summed."""
    b, hq, sq, d = p.q.shape
    _, hkv, sk, _ = p.k.shape
    g = hq // hkv
    k, v = (x.repeat_interleave(g, 1) for x in (p.k, p.v))
    s = mm(p.q * p.scale, k.transpose(-1, -2))
    if p.bias is not None:
        s = s + p.bias
    hidden = ~visible_mask(sq, sk, p.left, p.right, s.device)
    pm = torch.exp(s - _kernel_lse(p.lse)[..., None]).masked_fill(hidden, 0.0)
    ds = pm * (mm(p.do, v.transpose(-1, -2)) - p.delta[..., None])
    dq = mm(ds, k) * p.scale
    dk = mm(ds.transpose(-1, -2), p.q).reshape(b, hkv, g, sk, d).sum(2) * p.scale
    dv = mm(pm.transpose(-1, -2), p.do).reshape(b, hkv, g, sk, d).sum(2)
    return dq, dk, dv


# ---- (a) the split ----------------------------------------------------------

def _values(kind):
    rng = np.random.default_rng(11)
    if kind == "normal":
        x = rng.normal(0, 3, 4096)
    elif kind == "wide_range":
        x = rng.choice([-1.0, 1.0], 4096) * 10.0 ** rng.uniform(-30, 30, 4096)  # small stays normal
    elif kind == "large":
        x = np.array([-1e30, 1e30, -3.0e38, 3.0e38, 1.7e38, -2.5e37])
    elif kind == "ties":
        # 1 + k·2^-11 + 2^-12: exactly half-way between two tf32 values.
        k = np.arange(-64, 64)
        x = np.concatenate([1 + k * 2.0 ** -11 + 2.0 ** -12, -(1 + k * 2.0 ** -11 + 2.0 ** -12)])
    elif kind == "tf32_exact":
        # 11 significant bits: m · 2^e with |m| < 2^11.
        x = rng.integers(-2 ** 11 + 1, 2 ** 11, 1024) * 2.0 ** rng.integers(-40, 40, 1024)
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("kind", ["normal", "wide_range", "large", "ties", "tf32_exact"])
def test_split_parts_are_tf32_and_sum_to_x(kind):
    x = _values(kind)
    big, small = split(x)
    for part in (big, small):
        assert (part.view(torch.int32) & 0x1FFF == 0).all()
        assert torch.isfinite(part).all()
    err = (big.double() + small.double() - x.double()).abs()
    assert (err <= 2.0 ** -22 * x.double().abs()).all()
    if kind == "tf32_exact":
        assert torch.equal(big, x) and (small == 0).all()


@pytest.mark.parametrize("kind", ["normal", "wide_range", "ties"])
def test_tf32_rna_rounds_to_nearest_ties_away(kind):
    # The same rounding taken on the value: 11 significant bits, ties away.
    x = _values(kind).double().numpy()
    m, e = np.frexp(x)
    want = np.sign(m) * np.floor(np.abs(m) * 2 ** 11 + 0.5) / 2 ** 11 * 2.0 ** e
    got = tf32_rna(_values(kind)).double().numpy()
    normal = np.abs(x) >= 2.0 ** -126
    np.testing.assert_array_equal(got[normal], want[normal])


def test_split_keeps_zeros_mask_value_and_subnormals():
    x = torch.tensor([0.0, -0.0, -1e30, 1e-40, -1e-40, 1.4e-45, -3e-39, 2.0 ** -126],
                     dtype=torch.float32)
    big, small = split(x)
    assert torch.isfinite(big).all() and torch.isfinite(small).all()
    assert big[0] == 0 and small[0] == 0 and big[1] == 0 and small[1] == 0
    assert torch.signbit(big[1])  # -0 stays -0
    assert abs(float(big[2] + small[2]) + 1e30) <= 2.0 ** -22 * 1e30
    sub = x.abs() < 2.0 ** -126
    err = (big.double() + small.double() - x.double()).abs()
    assert (err[sub] <= 2.0 ** -137).all()
    # The sign survives in big (small may have either sign).
    assert ((big == 0) | (torch.signbit(big) == torch.signbit(x))).all()
    assert (err[~sub] <= 2.0 ** -22 * x.double().abs()[~sub]).all()


# ---- (b) the split backward against the plain version and JAX ---------------

B, HQ, HKV = 2, 4, 2
CASES = [
    # id, sq, sk, d, kwargs
    ("gqa2_causal", 128, 128, 64, dict(causal=True)),
    ("window", 144, 144, 64, dict(window=(40, 0))),
    ("bias_bhqk_masked", 96, 112, 64, dict(bias_kind="bhqk")),
    ("dlse", 112, 112, 64, dict(causal=True, dlse=True)),
    ("d128", 96, 96, 128, dict(causal=True)),
    ("q_sd3", 160, 160, 64, dict(causal=True, q_sd=3.0)),
    ("fully_masked_rows", 160, 100, 64, dict(window=(0, -1))),
]


def _normal(seed, shape, sd=1.0):
    return np.random.default_rng(seed).normal(0, sd, shape).astype(np.float32)


def _inputs(sq, sk, d, causal=False, window=None, bias_kind=None, dlse=False, q_sd=1.0):
    """numpy q, k, v, dO, bias, dlse; out and lse from the JAX forward."""
    q = _normal(0, (B, HQ, sq, d), q_sd)
    k, v = _normal(1, (B, HKV, sk, d)), _normal(2, (B, HKV, sk, d))
    do = _normal(3, (B, HQ, sq, d))
    bias = None
    if bias_kind == "bhqk":
        bias = _normal(7, (B, HQ, sq, sk))
        bias = np.where(bias > 1.5, np.float32(-1e30), bias)
    g_lse = _normal(4, (B, HQ, sq)) if dlse else None
    kw = dict(causal=causal, window=window)
    out, lse = jax_flash_forward(*(jnp.asarray(x) for x in (q, k, v)),
                                 None if bias is None else jnp.asarray(bias), interpret=True, **kw)
    return dict(q=q, k=k, v=v, out=np.asarray(out), lse=np.asarray(lse), do=do, bias=bias,
                dlse=g_lse), kw


def _torch_args(x):
    t = {n: None if a is None else torch.from_numpy(np.array(a)) for n, a in x.items()}
    return (t["q"], t["k"], t["v"], t["out"], t["lse"], t["do"], t["bias"], t["dlse"])


def _model(x, kw, mm):
    q, k, v, out, lse, do, bias, dlse = _torch_args(x)
    p = _prepare(q, k, v, out, lse, do, bias, dlse, kw["causal"], kw["window"], None)
    return model_backward(p, mm)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_backward_matches_the_plain_version(case):
    _, sq, sk, d, kw = case
    x, mask = _inputs(sq, sk, d, **kw)
    got = _model(x, mask, mm_split)
    want = flash_attention_backward_plain(*_torch_args(x), **mask)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert torch.isfinite(g).all(), name
        assert rel_err(g, w) <= SPLIT_VS_PLAIN, name
    hidden = x["lse"] <= -1e29
    if hidden.any():
        assert (got[0].numpy()[hidden] == 0).all()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_backward_matches_jax(case):
    _, sq, sk, d, kw = case
    x, mask = _inputs(sq, sk, d, **kw)
    got = _model(x, mask, mm_split)
    want = jax_flash_backward(
        *(jnp.asarray(x[n]) for n in ("q", "k", "v", "out", "lse", "do")),
        None if x["bias"] is None else jnp.asarray(x["bias"]),
        None if x["dlse"] is None else jnp.asarray(x["dlse"]), interpret=True, **mask)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **FP32)


# ---- (c) the control: one TF32 pass ------------------------------------------

@pytest.mark.parametrize("case", [c for c in CASES if c[0] in ("gqa2_causal", "d128", "q_sd3",
                                                                "bias_bhqk_masked")],
                         ids=lambda c: c[0])
def test_one_tf32_pass_is_ten_times_further_from_the_plain_version(case):
    _, sq, sk, d, kw = case
    x, mask = _inputs(sq, sk, d, **kw)
    want = flash_attention_backward_plain(*_torch_args(x), **mask)
    split_err = [rel_err(g, w) for g, w in zip(_model(x, mask, mm_split), want)]
    one_err = [rel_err(g, w) for g, w in zip(_model(x, mask, mm_one_pass), want)]
    for s_, o, name in zip(split_err, one_err, ("dq", "dk", "dv")):
        assert o >= 10 * s_, (name, s_, o)
