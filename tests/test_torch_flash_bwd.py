"""Port parity: the dense flash backward (dQ, dK/dV) and the bias gradient.

The same numpy inputs go through the JAX package (its Pallas kernels in
interpret mode on the CPU, as the JAX tests run them) and the port's plain
PyTorch versions on the CPU. The direct tests hand both backwards the same
(q, k, v, out, lse, dO), with out and lse from the JAX forward; the autograd
tests compare `jax.grad` of the JAX `flash_attention` with `.backward()`
through the port's `flash_attention`, with cotangents on out and on lse.

Tolerances: fp32 atol = rtol = 1e-4, the bound of
tests/test_flash_backward.py:32 (both sides compute in full fp32; only the
summation order differs). fp16 is storage-only on both sides (fp32 compute
on the same upcast inputs): the same 1e-4. bf16: both round Q·scale, P and
dS to bf16 at the same points and emit bf16 gradients; an fp32 summation
difference can move a value across a bf16 rounding boundary, so
TOL["bf16"] (2e-2). Rows with no visible key have gradients of exactly 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umfa_tpu.ops.attention import flash_attention as jax_flash_attention
from umfa_tpu.ops.flash_bwd import flash_attention_backward as jax_flash_backward
from umfa_tpu.ops.flash_bwd import flash_attention_bias_grad as jax_bias_grad
from umfa_tpu.ops.flash_fwd import flash_attention_forward as jax_flash_forward
from umfa_tpu_torch.ops.attention import flash_attention
from umfa_tpu_torch.ops.flash_bwd import (
    flash_attention_backward,
    flash_attention_backward_plain,
    flash_attention_bias_grad,
)
from umfa_tpu_torch.utils.testing import TOL, rel_err

B, HQ, HKV, D = 2, 4, 2, 64
FP32 = dict(atol=1e-4, rtol=1e-4)
JDT = {"fp32": jnp.float32, "fp16": jnp.float16, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "fp16": torch.float16, "bf16": torch.bfloat16}


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _bias(kind, sq, sk, seed=7):
    if kind is None:
        return None
    shape = {"bhqk": (B, HQ, sq, sk), "11qk": (1, 1, sq, sk), "b11k": (B, 1, 1, sk),
             "b1qk": (B, 1, sq, sk)}[kind]
    return _normal(seed, *shape)


def _t(a, dtype):
    """A JAX or numpy array as a CPU tensor of `dtype` (exact for the
    array's own type: bf16 and fp16 go through float32)."""
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(dtype)


def _direct(sq, sk, dtype="fp32", bias_kind=None, dlse=False, heads=(HQ, HKV), d=D,
            fp32_grads=False, batch=B, **kw):
    """JAX's and the port's backward on the same (q, k, v, out, lse, dO);
    bf16 inputs emit bf16 gradients unless fp32_grads."""
    hq, hkv = heads
    q, k, v = (_normal(0, batch, hq, sq, d), _normal(1, batch, hkv, sk, d),
               _normal(2, batch, hkv, sk, d))
    do, g_lse = _normal(3, batch, hq, sq, d), _normal(4, batch, hq, sq)
    bias = _bias(bias_kind, sq, sk)
    jdt, tdt = JDT[dtype], TDT[dtype]
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    jb = None if bias is None else jnp.asarray(bias)
    j_out, j_lse = jax_flash_forward(jq, jk, jv, jb, interpret=True, **kw)
    jdo = jnp.asarray(do, j_out.dtype)
    jdlse = jnp.asarray(g_lse) if dlse else None
    bf16_grads = dtype == "bf16" and not fp32_grads
    want = jax_flash_backward(jq, jk, jv, j_out, j_lse, jdo, jb, jdlse, interpret=True,
                              grad_dtype=jnp.bfloat16 if bf16_grads else None, **kw)
    got = flash_attention_backward(
        *(_t(x, tdt) for x in (jq, jk, jv, j_out)), _t(j_lse, torch.float32),
        _t(jdo, tdt), None if bias is None else torch.from_numpy(bias),
        torch.from_numpy(g_lse) if dlse else None,
        grad_dtype=torch.bfloat16 if bf16_grads else None, **kw)
    return [np.asarray(w, np.float32) for w in want], got, j_lse


DIRECT_CASES = [
    # id, sq, sk, kwargs
    ("full", 128, 128, {}),
    ("causal", 128, 128, dict(causal=True)),
    ("causal_sq_ne_sk_odd", 97, 150, dict(causal=True)),
    ("window", 144, 144, dict(window=(40, 0))),
    ("window_both_sides", 131, 100, dict(window=(17, 9))),
    ("bias_bhqk", 96, 112, dict(bias_kind="bhqk")),
    ("bias_11qk_causal", 120, 120, dict(causal=True, bias_kind="11qk")),
    ("bias_b11k", 80, 144, dict(bias_kind="b11k")),
    ("dlse", 112, 112, dict(causal=True, dlse=True)),
    ("gqa_4_1", 64, 96, dict(heads=(4, 1))),
    ("fully_masked_rows", 160, 100, dict(window=(0, -1))),
]


@pytest.mark.parametrize("case", DIRECT_CASES, ids=[c[0] for c in DIRECT_CASES])
def test_flash_backward_fp32_matches_jax(case):
    name, sq, sk, kw = case
    want, got, j_lse = _direct(sq, sk, **kw)
    for w, g, n in zip(want, got, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, err_msg=n, **FP32)
    if name == "fully_masked_rows":
        hidden = np.asarray(j_lse) <= -1e29
        assert hidden.sum() == B * HQ * (sq - sk)
        np.testing.assert_array_equal(got[0].numpy()[hidden], 0.0)


@pytest.mark.parametrize("dtype", ["bf16", "fp16"])
def test_flash_backward_bf16_fp16_match_jax(dtype):
    want, got, _ = _direct(100, 130, dtype=dtype, causal=True, bias_kind="b1qk", dlse=True)
    tol = TOL["bf16"] if dtype == "bf16" else FP32
    for w, g, n in zip(want, got, ("dq", "dk", "dv")):
        # bf16 inputs emit bf16 gradients; fp16 ones fp32 (storage-only).
        assert g.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
        np.testing.assert_allclose(g.float().numpy(), w, err_msg=n, **tol)


# bf16 inputs with fp32 gradients at head dims whose softmax scale is not a
# power of two: Sᵀ takes bf16(q·scale) and dK the raw Q with scale on its
# sum (flash_bwd.py:52, :451-456). Relerr 5e-4: both sides round P and dS
# to bf16 at the same points and differ only where an fp32 summation order
# moves an element across a rounding boundary (~7e-5 here); dK from the
# rounded scaled Q would sit at ~1.7e-3. D 256, the widest head the bf16
# kernels take, at a smaller shape (B1 H2 S128).
BF16_FP32_GRAD_CASES = [
    # id, d, sq, sk, kwargs
    ("causal-80", 80, 100, 130, dict(causal=True, dlse=True)),
    ("causal-128", 128, 100, 130, dict(causal=True, dlse=True)),
    ("window_bias-80", 80, 100, 130, dict(window=(40, 8), bias_kind="b1qk")),
    ("window_bias-128", 128, 100, 130, dict(window=(40, 8), bias_kind="b1qk")),
    ("causal-256", 256, 128, 128, dict(causal=True, dlse=True, batch=1, heads=(2, 2))),
]


@pytest.mark.parametrize("case", BF16_FP32_GRAD_CASES, ids=[c[0] for c in BF16_FP32_GRAD_CASES])
def test_flash_backward_bf16_inputs_fp32_grads_match_jax(case):
    _, d, sq, sk, kw = case
    want, got, _ = _direct(sq, sk, dtype="bf16", d=d, fp32_grads=True, **kw)
    for w, g, n in zip(want, got, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32, n
        assert rel_err(g, w) <= 5e-4, n


def test_flash_backward_plain_is_the_cpu_path():
    q, k, v = _normal(0, 1, 2, 40, 32), _normal(1, 1, 1, 56, 32), _normal(2, 1, 1, 56, 32)
    args = [torch.from_numpy(x) for x in (q, k, v, _normal(3, 1, 2, 40, 32),
                                           _normal(4, 1, 2, 40), _normal(5, 1, 2, 40, 32))]
    for a, b in zip(flash_attention_backward(*args, causal=True, scale=0.3),
                    flash_attention_backward_plain(*args, causal=True, scale=0.3)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["bhqk", "11qk", "b1qk"])
def test_bias_grad_matches_jax(kind):
    sq, sk = 96, 120
    q, k, v = _normal(0, B, HQ, sq, D), _normal(1, B, HKV, sk, D), _normal(2, B, HKV, sk, D)
    bias = _bias(kind, sq, sk)
    jq, jk, jv, jb = (jnp.asarray(x) for x in (q, k, v, bias))
    j_out, j_lse = jax_flash_forward(jq, jk, jv, jb, causal=True, interpret=True)
    do = jnp.asarray(_normal(3, B, HQ, sq, D))
    want = np.asarray(jax_bias_grad(jq, jk, jv, j_out, j_lse, do, jb, causal=True,
                                    interpret=True))
    got = flash_attention_bias_grad(*(_t(x, torch.float32) for x in (jq, jk, jv, j_out, j_lse, do)),
                                    torch.from_numpy(bias), causal=True)
    assert got.shape == bias.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **FP32)


# fp32 inputs at head dims over 128, which the card's dbias kernel takes
# since its 3xTF32 body (D 192 zero-padded inside its 32-column chunks):
# the CPU path is the plain version, the same arithmetic, held to the
# reference at the fp32 gate.
@pytest.mark.parametrize("d", [192, 256])
@pytest.mark.parametrize("kind", ["11qk", "bhqk"])
def test_bias_grad_fp32_wide_heads_match_jax(kind, d):
    sq, sk = 80, 104
    q, k, v = _normal(0, B, HQ, sq, d), _normal(1, B, HKV, sk, d), _normal(2, B, HKV, sk, d)
    bias = _bias(kind, sq, sk)
    jq, jk, jv, jb = (jnp.asarray(x) for x in (q, k, v, bias))
    j_out, j_lse = jax_flash_forward(jq, jk, jv, jb, causal=True, interpret=True)
    do = jnp.asarray(_normal(3, B, HQ, sq, d))
    want = np.asarray(jax_bias_grad(jq, jk, jv, j_out, j_lse, do, jb, causal=True,
                                    interpret=True))
    got = flash_attention_bias_grad(*(_t(x, torch.float32) for x in (jq, jk, jv, j_out, j_lse, do)),
                                    torch.from_numpy(bias), causal=True)
    assert got.shape == bias.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **FP32)


# bf16 inputs at D 128 (scale not a power of two): both sides take
# S = bf16(q·scale)·Kᵀ and dP = dO·Vᵀ as exact bf16 products summed in
# fp32, and dbias = P∘(dP − δ) in fp32 with no rounding, so only summation
# orders differ: the fp32 gate, relerr 1e-4.
@pytest.mark.parametrize("kind", ["11qk", "bhqk"])
def test_bias_grad_bf16_d128_matches_jax(kind):
    sq, sk, d = 96, 120, 128
    q, k, v = _normal(0, B, HQ, sq, d), _normal(1, B, HKV, sk, d), _normal(2, B, HKV, sk, d)
    bias = _bias(kind, sq, sk)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    jb = jnp.asarray(bias)
    j_out, j_lse = jax_flash_forward(jq, jk, jv, jb, causal=True, interpret=True)
    do = jnp.asarray(_normal(3, B, HQ, sq, d), jnp.bfloat16)
    want = np.asarray(jax_bias_grad(jq, jk, jv, j_out, j_lse, do, jb, causal=True,
                                    interpret=True))
    got = flash_attention_bias_grad(*(_t(x, torch.bfloat16) for x in (jq, jk, jv, j_out)),
                                    _t(j_lse, torch.float32), _t(do, torch.bfloat16),
                                    torch.from_numpy(bias), causal=True)
    assert got.shape == bias.shape and got.dtype == torch.float32
    assert rel_err(got, want) <= 1e-4


AUTOGRAD_CASES = [
    # id, sq, sk, kwargs, bias kind, bias_grad
    ("causal_gqa", 96, 96, dict(causal=True), None, False),
    ("window_sq_ne_sk", 77, 120, dict(window=(30, 4)), None, False),
    ("bias_11qk_grad", 96, 96, dict(causal=True), "11qk", True),
    ("bias_b11k_grad", 64, 100, {}, "b11k", True),
    ("bias_bhqk_no_grad", 64, 64, {}, "bhqk", False),
]


@pytest.mark.parametrize("case", AUTOGRAD_CASES, ids=[c[0] for c in AUTOGRAD_CASES])
def test_flash_attention_grads_match_jax_grad(case):
    _, sq, sk, kw, bias_kind, bias_grad = case
    q, k, v = _normal(0, B, HQ, sq, D), _normal(1, B, HKV, sk, D), _normal(2, B, HKV, sk, D)
    bias = _bias(bias_kind, sq, sk)
    w_out, w_lse = _normal(5, B, HQ, sq, D), _normal(6, B, HQ, sq)

    def jloss(q, k, v, bias):
        out, lse = jax_flash_attention(q, k, v, bias, return_lse=True, bias_grad=bias_grad,
                                       interpret=True, **kw)
        return jnp.sum(out * w_out) + jnp.sum(lse * w_lse)

    args = [jnp.asarray(x) for x in (q, k, v)] + [None if bias is None else jnp.asarray(bias)]
    argnums = (0, 1, 2, 3) if bias is not None else (0, 1, 2)
    want = jax.grad(jloss, argnums=argnums)(*args)

    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    tb = None if bias is None else torch.from_numpy(bias).requires_grad_(True)
    out, lse = flash_attention(tq, tk, tv, tb, return_lse=True, bias_grad=bias_grad, **kw)
    ((out * torch.from_numpy(w_out)).sum() + (lse * torch.from_numpy(w_lse)).sum()).backward()
    got = (tq.grad, tk.grad, tv.grad) + ((tb.grad,) if tb is not None else ())
    for w, g, n in zip(want, got, ("dq", "dk", "dv", "dbias")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=n, **FP32)
    if tb is not None and not bias_grad:
        assert torch.equal(tb.grad, torch.zeros_like(tb))


def test_flash_attention_grads_bf16_and_only_lse_cotangent():
    q, k, v = _normal(0, 1, 2, 64, 32), _normal(1, 1, 2, 64, 32), _normal(2, 1, 2, 64, 32)
    tq, tk, tv = (torch.from_numpy(x).bfloat16().requires_grad_(True) for x in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=True)
    out.float().square().sum().backward()
    for t in (tq, tk, tv):
        assert t.grad.dtype == torch.bfloat16 and torch.isfinite(t.grad.float()).all()
    # A loss on lse alone: g_out arrives as None and is taken as zero.
    w = _normal(3, 1, 2, 64)

    def jloss(q, k, v):
        _, lse = jax_flash_attention(q, k, v, causal=True, return_lse=True, interpret=True)
        return jnp.sum(lse * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    _, lse = flash_attention(tq, tk, tv, causal=True, return_lse=True)
    (lse * torch.from_numpy(w)).sum().backward()
    for wg, t in zip(want, (tq, tk, tv)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wg), **FP32)
