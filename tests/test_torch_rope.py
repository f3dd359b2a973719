"""Port parity: in-kernel RoPE (`flash_attention_forward(rope_cos=, rope_sin=)`)
and `rope_attention` against the JAX package.

The same numpy inputs go through the JAX reference (its Pallas kernels in
interpret mode on the CPU) and the port's plain PyTorch paths on the CPU.
JAX runs its forward with BlockSizes(128, 128), so at S >= 256 it walks more
than one query tile and takes its in-kernel route (flash_fwd.py:880-895):
Q rotated and scaled in fp32 and rounded once, K rotated and rounded to its
type, as the port does.

Tolerances, with their reasons:
  * fp32 forward atol = rtol = 2e-5 (the bound of the reference's
    test_rope_inkernel_matches_xla_rotation, tests/test_ops_misc.py:224);
    both sides rotate and attend in full fp32, in other orders;
  * bf16 forward: out relerr 1e-2 and LSE 1e-3, row 1's bf16 gate (the
    reference rounds P against the running max of its 128-key tiles, the
    port against the row's final max);
  * under causal or a window with Sq != Sk the reference rotates in plain
    math before its kernel (flash_fwd.py:888-895, :926-933): Q is rounded to
    its type before the scale, one rounding more than the in-kernel route.
    In fp32 that rounding is exact, so those cases are held in fp32 only;
  * `rope_attention` out and q/k/v gradients atol = rtol = 1e-4 (fp32; the
    backward bound of tests/test_flash_backward.py:32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import umfa_tpu
import umfa_tpu_torch
from umfa_tpu.ops import block_mask as jbm
from umfa_tpu.ops import rope as jrope
from umfa_tpu.ops.flash_fwd import BlockSizes as JBlockSizes
from umfa_tpu.ops.flash_fwd import flash_attention_forward as jax_flash_forward
from umfa_tpu_torch.ops import block_mask as tbm
from umfa_tpu_torch.ops import rope
from umfa_tpu_torch.ops.flash_fwd import flash_attention_forward, flash_attention_forward_plain
from umfa_tpu_torch.utils.testing import rel_err

FWD = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)
JBS = JBlockSizes(block_q=128, block_k=128)


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _inputs(seed, b, hq, hkv, sq, sk, d):
    return (_normal(seed, b, hq, sq, d), _normal(seed + 1, b, hkv, sk, d),
            _normal(seed + 2, b, hkv, sk, d))


def _tables(s, d):
    cos, sin = jrope.rope_angles(s, d)
    return np.array(cos), np.array(sin)


FWD_CASES = [
    # id, (b, hq, hkv, sq, sk, d), kwargs, bias, in-kernel in JAX
    ("full_d64", (1, 2, 2, 256, 256, 64), {}, False, True),
    ("causal_gqa", (1, 4, 2, 256, 256, 64), dict(causal=True), False, True),
    ("window_d128", (2, 2, 1, 384, 384, 128), dict(window=(100, 20)), False, True),
    ("sq_ne_sk_full", (1, 4, 2, 256, 384, 64), {}, False, True),
    ("bias_d128", (1, 2, 2, 256, 256, 128), dict(causal=True), True, True),
    ("causal_sq_ne_sk", (1, 4, 2, 256, 384, 64), dict(causal=True), False, False),
    ("window_sq_ne_sk_d128", (1, 2, 1, 384, 256, 128), dict(window=(64, 0)), False, False),
]


def _bias(b, hq, sq, sk):
    bias = _normal(9, b, hq, sq, sk)
    return np.where(bias > 2.0, -1e30, bias).astype(np.float32)


def _forward_both(case, dtype):
    _, (b, hq, hkv, sq, sk, d), kw, with_bias, _ = case
    q, k, v = _inputs(3, b, hq, hkv, sq, sk, d)
    cos, sin = _tables(max(sq, sk) + 5, d)  # a longer table: rows past S unread
    bias = _bias(b, hq, sq, sk) if with_bias else None
    jdt, tdt = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    j_out, j_lse = jax_flash_forward(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), None if bias is None else jnp.asarray(bias),
        rope_cos=jnp.asarray(cos), rope_sin=jnp.asarray(sin), block_sizes=JBS, interpret=True,
        **kw)
    t_out, t_lse = flash_attention_forward(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
        None if bias is None else torch.from_numpy(bias),
        rope_cos=torch.from_numpy(cos), rope_sin=torch.from_numpy(sin), **kw)
    assert t_out.dtype == tdt and t_lse.dtype == torch.float32
    return (np.asarray(j_out, np.float32), np.asarray(j_lse), t_out.float().numpy(),
            t_lse.numpy())


@pytest.mark.parametrize("case", FWD_CASES, ids=[c[0] for c in FWD_CASES])
def test_rope_forward_fp32_matches_jax(case):
    j_out, j_lse, t_out, t_lse = _forward_both(case, "fp32")
    np.testing.assert_allclose(t_out, j_out, **FWD)
    np.testing.assert_allclose(t_lse, j_lse, **FWD)


@pytest.mark.parametrize("case", [c for c in FWD_CASES if c[4]], ids=[c[0] for c in FWD_CASES
                                                                      if c[4]])
def test_rope_forward_bf16_matches_jax_in_kernel_route(case):
    j_out, j_lse, t_out, t_lse = _forward_both(case, "bf16")
    assert rel_err(t_out, j_out) <= 1e-2
    vis = j_lse > -1e29
    assert np.abs(t_lse[vis] - j_lse[vis]).max() <= 1e-3


def test_rope_forward_equals_rotating_first_in_fp32():
    # The in-kernel rotation is the two-pass one: in fp32 both round nowhere
    # but at the same products (the plain version shares apply_rope).
    q, k, v = (torch.from_numpy(x) for x in _inputs(5, 1, 4, 2, 96, 160, 32))
    cos, sin = rope.rope_angles(160, 32, device="cpu")
    out, lse = flash_attention_forward(q, k, v, causal=True, rope_cos=cos, rope_sin=sin)
    want, want_lse = flash_attention_forward(
        rope.apply_rope(q, cos[:96], sin[:96], interleaved=False),
        rope.apply_rope(k, cos, sin, interleaved=False), v, causal=True)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    plain = flash_attention_forward_plain(q, k, v, causal=True, rope_cos=cos, rope_sin=sin)
    assert torch.equal(plain[0], out) and torch.equal(plain[1], lse)


def test_rope_forward_refuses_what_it_does_not_take():
    q, k, v = (torch.from_numpy(x) for x in _inputs(6, 1, 2, 2, 64, 64, 32))
    cos, sin = rope.rope_angles(64, 32, device="cpu")
    with pytest.raises(ValueError, match="come together"):
        flash_attention_forward(q, k, v, rope_cos=cos)
    with pytest.raises(ValueError, match="does not fit"):
        flash_attention_forward(q, k, v, rope_cos=cos[:63], rope_sin=sin[:63])
    odd = torch.zeros(1, 2, 64, 33)
    with pytest.raises(ValueError, match="even head_dim"):
        flash_attention_forward(odd, odd, odd, rope_cos=torch.zeros(64, 16),
                                rope_sin=torch.zeros(64, 16))
    mask = tbm.causal_block_mask(64, 64, device="cpu")
    walk = mask.walk()
    with pytest.raises(ValueError, match="block-sparse walk"):
        flash_attention_forward(q, k, v, rope_cos=cos, rope_sin=sin, block_map=walk.block_map,
                                fetch_ids=walk.fetch_kv, block_q=walk.block_q,
                                block_k=walk.block_k)


ATTN_CASES = [
    # id, (b, hq, hkv, s, d), rope_attention kwargs
    ("inkernel_causal", (1, 2, 2, 256, 64), dict(interleaved=False, causal=True)),
    ("inkernel_gqa_window", (2, 4, 2, 256, 128), dict(interleaved=False, window=(80, 0))),
    ("inkernel_full", (1, 2, 1, 128, 64), dict(interleaved=False)),
    ("two_pass_interleaved", (1, 4, 2, 128, 64), dict(interleaved=True, causal=True)),
]


def _grads_both(shape, kw, extra_j=None, extra_t=None, seed=11):
    b, hq, hkv, s, d = shape
    q, k, v = _inputs(seed, b, hq, hkv, s, s, d)
    w = _normal(seed + 7, b, hq, s, d)

    def jloss(q, k, v):
        out = jrope.rope_attention(q, k, v, interpret=True, **kw, **(extra_j or {}))
        return jnp.sum(out.astype(jnp.float32) * w), out

    (_, j_out), j_grads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = rope.rope_attention(tq, tk, tv, **kw, **(extra_t or {}))
    (out * torch.from_numpy(w)).sum().backward()
    return (np.asarray(j_out), [np.asarray(g) for g in j_grads], out.detach().numpy(),
            [t.grad.numpy() for t in (tq, tk, tv)])


@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_rope_attention_out_and_grads_match_jax(case):
    _, shape, kw = case
    j_out, j_grads, t_out, t_grads = _grads_both(shape, kw)
    np.testing.assert_allclose(t_out, j_out, **GRAD)
    for name, got, want in zip("qkv", t_grads, j_grads):
        np.testing.assert_allclose(got, want, err_msg=f"d{name}", **GRAD)


def test_rope_attention_bias_and_block_mask_take_the_two_pass_route(monkeypatch):
    from umfa_tpu_torch.ops import flash_fwd

    seen = []
    real = rope._RopeFlash.apply

    def spy(*args):
        seen.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(rope._RopeFlash, "apply", spy)
    q, k, v = (torch.from_numpy(x) for x in _inputs(12, 1, 2, 2, 64, 64, 32))
    rope.rope_attention(q, k, v, interleaved=False)
    assert len(seen) == 1  # the in-kernel route without extra kwargs
    bias = _normal(13, 1, 1, 256, 256)
    j_out, j_grads, t_out, t_grads = _grads_both(
        (1, 2, 2, 256, 64), dict(interleaved=False, causal=True),
        extra_j=dict(bias=jnp.asarray(bias)), extra_t=dict(bias=torch.from_numpy(bias)))
    np.testing.assert_allclose(t_out, j_out, **GRAD)
    for got, want in zip(t_grads, j_grads):
        np.testing.assert_allclose(got, want, **GRAD)
    jmask = jbm.causal_block_mask(256, 256, block_sizes=JBS)
    tmask = tbm.causal_block_mask(256, 256, block_sizes=flash_fwd.BlockSizes(128, 128),
                                  device="cpu")
    j_out, j_grads, t_out, t_grads = _grads_both(
        (1, 2, 2, 256, 64), dict(interleaved=False), extra_j=dict(block_mask=jmask),
        extra_t=dict(block_mask=tmask))
    np.testing.assert_allclose(t_out, j_out, **GRAD)
    for got, want in zip(t_grads, j_grads):
        np.testing.assert_allclose(got, want, **GRAD)
    assert len(seen) == 1  # neither took the in-kernel route


def test_rope_attention_counts_only_the_total():
    umfa_tpu_torch.reset_dispatch_stats()
    umfa_tpu.reset_dispatch_stats()
    q, k, v = _inputs(17, 1, 2, 2, 64, 64, 32)
    for interleaved in (False, True):
        rope.rope_attention(*(torch.from_numpy(x) for x in (q, k, v)), interleaved=interleaved)
        jrope.rope_attention(*(jnp.asarray(x) for x in (q, k, v)), interleaved=interleaved,
                             interpret=True)
    got, want = umfa_tpu_torch.get_dispatch_stats(), umfa_tpu.get_dispatch_stats()
    assert got["total"] == 2 and sum(got.values()) == 2
    assert {r: want.get(r, 0) for r in got} == got


def test_rope_attention_default_tables_on_q_device():
    q, k, v = (torch.from_numpy(x) for x in _inputs(19, 1, 2, 2, 48, 80, 32))
    out = rope.rope_attention(q, k, v, interleaved=False, base=500.0)
    cos, sin = rope.rope_angles(80, 32, base=500.0, device="cpu")
    want = rope.rope_attention(q, k, v, cos, sin, interleaved=False)
    assert torch.equal(out, want)
    assert umfa_tpu_torch.rope_attention is rope.rope_attention
