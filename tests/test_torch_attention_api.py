"""Port parity: the public `attention()` API against `umfa_tpu.attention`.

Same numpy inputs through both packages (JAX kernels in interpret mode on
the CPU; the port's plain PyTorch paths on the CPU): promotion, masks,
is_causal, window, return_lse, gradients (q, k, v and the mask), dispatch
stats and the opt-in naive routes.

Tolerances: fp32 1e-4 (atol and rtol) for outputs and gradients, the bound
of tests/test_flash_backward.py:32 (full fp32 on both sides, summation
order differs). Dropout: the two packages draw different random bits, so
only the statistics are compared (the kept share within 0.03 of 1 - p, a
5-sigma band at 8192 draws).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import umfa_tpu
import umfa_tpu_torch
from umfa_tpu_torch import api
from umfa_tpu_torch.engine import config as tcfg

FP32 = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _clean_state():
    for pkg in (umfa_tpu, umfa_tpu_torch):
        pkg.reset_dispatch_stats()
        pkg.clear_quantization_mode()
    yield
    for pkg in (umfa_tpu, umfa_tpu_torch):
        pkg.clear_quantization_mode()


def _qkv(seed, shape_q, shape_kv=None):
    rng = np.random.default_rng(seed)
    shape_kv = shape_kv or shape_q
    return (rng.normal(0, 1, shape_q).astype(np.float32),
            rng.normal(0, 1, shape_kv).astype(np.float32),
            rng.normal(0, 1, shape_kv).astype(np.float32))


def _both(q, k, v, mask=None, **kw):
    want = umfa_tpu.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              None if mask is None else jnp.asarray(mask), interpret=True, **kw)
    got = umfa_tpu_torch.attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v),
                                   None if mask is None else torch.from_numpy(mask), **kw)
    return want, got


@pytest.mark.parametrize("shape", [(64, 32), (2, 64, 32)], ids=["2d", "3d"])
def test_promotion_matches_jax(shape):
    q, k, v = _qkv(0, shape)
    want, got = _both(q, k, v, is_causal=True)
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    want, got = _both(q, k, v, return_lse=True)
    assert got[1].shape == shape[:-1]
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FP32)


MASK_CASES = [
    # id, mask builder (rng, sq, sk) → numpy mask, kwargs
    ("bool_11qk", lambda r, sq, sk: r.random((1, 1, sq, sk)) > 0.3, {}),
    ("bool_2d_causal", lambda r, sq, sk: r.random((sq, sk)) > 0.2, dict(is_causal=True)),
    ("uint8_b1qk", lambda r, sq, sk: (r.random((2, 1, sq, sk)) > 0.3).astype(np.uint8), {}),
    ("float_1hqk", lambda r, sq, sk: r.normal(0, 1, (1, 4, sq, sk)).astype(np.float32), {}),
    ("float_key_bcast", lambda r, sq, sk: r.normal(0, 1, (2, 1, sq, 1)).astype(np.float32), {}),
    ("none_window", lambda r, sq, sk: None, dict(window=(24, 3))),
    ("none_window_sq_ne_sk", lambda r, sq, sk: None, dict(window=(-1, 40), is_causal=False)),
]


@pytest.mark.parametrize("case", MASK_CASES, ids=[c[0] for c in MASK_CASES])
def test_masks_and_windows_match_jax(case):
    _, build, kw = case
    q, k, v = _qkv(1, (2, 4, 72, 32), (2, 2, 88, 32))
    mask = build(np.random.default_rng(2), 72, 88)
    want, got = _both(q, k, v, mask, return_lse=True, **kw)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FP32)


def test_all_true_mask_elided_and_counted():
    q, k, v = _qkv(3, (1, 2, 64, 32))
    mask = np.ones((64, 64), bool)
    want, got = _both(q, k, v, mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    for pkg in (umfa_tpu, umfa_tpu_torch):
        stats = pkg.get_dispatch_stats()
        assert stats["mask_all_true_skipped"] == 1 and stats["fused_autograd"] == 1


@pytest.mark.parametrize("bias_grad", [True, False])
def test_gradients_match_jax_grad(bias_grad):
    q, k, v = _qkv(4, (2, 4, 80, 32), (2, 2, 80, 32))
    bias = np.random.default_rng(5).normal(0, 1, (1, 4, 80, 80)).astype(np.float32)
    w = np.random.default_rng(6).normal(0, 1, q.shape).astype(np.float32)

    def jloss(q, k, v, bias):
        out = umfa_tpu.attention(q, k, v, bias, is_causal=True, bias_grad=bias_grad,
                                 interpret=True)
        return jnp.sum(out * w)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*(jnp.asarray(x) for x in (q, k, v, bias)))
    t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v, bias)]
    out = umfa_tpu_torch.attention(*t[:3], t[3], is_causal=True, bias_grad=bias_grad)
    (out * torch.from_numpy(w)).sum().backward()
    for wg, tg, n in zip(want, t, ("dq", "dk", "dv", "dbias")):
        np.testing.assert_allclose(tg.grad.numpy(), np.asarray(wg), err_msg=n, **FP32)
    if not bias_grad:
        assert torch.equal(t[3].grad, torch.zeros_like(t[3]))
    stats = umfa_tpu_torch.get_dispatch_stats()
    assert stats["fused_autograd"] == 1 and stats["naive_fallback"] == 0


def test_attention_with_lse_and_dispatch_counts():
    q, k, v = _qkv(7, (1, 2, 48, 32))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = umfa_tpu_torch.attention_with_lse(tq, tk, tv, is_causal=True)
    want_out, want_lse = umfa_tpu.attention_with_lse(*(jnp.asarray(x) for x in (q, k, v)),
                                                     is_causal=True, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **FP32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **FP32)
    umfa_tpu_torch.attention(tq, tk, tv)
    stats = umfa_tpu_torch.get_dispatch_stats()
    assert (stats["total"], stats["fused_fwd"], stats["fused_autograd"]) == (2, 1, 1)
    umfa_tpu_torch.reset_dispatch_stats()
    assert umfa_tpu_torch.get_dispatch_stats()["total"] == 0


def test_disable_fused_and_nan_check_routes(monkeypatch):
    q, k, v = _qkv(8, (1, 2, 40, 32))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    fused = umfa_tpu_torch.attention(tq, tk, tv, is_causal=True)
    monkeypatch.setattr(tcfg, "DISABLE_FUSED", True)
    naive = umfa_tpu_torch.attention(tq, tk, tv, is_causal=True)
    assert umfa_tpu_torch.get_dispatch_stats()["naive_fallback"] == 1
    np.testing.assert_allclose(naive.detach().numpy(), fused.detach().numpy(), **FP32)
    naive.sum().backward()  # the naive route is plain autograd
    assert tq.grad is not None
    monkeypatch.setattr(tcfg, "DISABLE_FUSED", False)
    monkeypatch.setattr(tcfg, "NAN_CHECK", True)
    umfa_tpu_torch.attention(tq, tk, tv, is_causal=True)
    assert umfa_tpu_torch.get_dispatch_stats()["naive_fallback"] == 1  # finite: no recompute
    monkeypatch.setattr(api, "flash_attention",
                        lambda q, *a, **kw: (torch.full_like(q, float("nan")), None))
    out = umfa_tpu_torch.attention(tq, tk, tv, is_causal=True)
    assert umfa_tpu_torch.get_dispatch_stats()["naive_fallback"] == 2
    np.testing.assert_allclose(out.detach().numpy(), fused.detach().numpy(), **FP32)


def test_env_flags_parse_like_the_reference(monkeypatch):
    for val, want in (("1", True), ("yes", True), ("0", False), ("", False), ("no", False)):
        monkeypatch.setenv("UMFA_DISABLE_FUSED", val)
        assert tcfg.env_flag("UMFA_DISABLE_FUSED") is want
    monkeypatch.delenv("UMFA_DISABLE_FUSED")
    assert tcfg.env_flag("UMFA_DISABLE_FUSED") is False
    assert not hasattr(tcfg, "FORCE_INTERPRET")


def test_dropout_route_statistics():
    # q = 0 gives uniform probabilities 1/Sk and v = I_Sk makes the output
    # the keep mask itself: out * Sk * (1 - p) is 0 or 1.
    p, sk = 0.25, 64
    q = np.zeros((1, 2, 64, sk), np.float32)
    v = np.broadcast_to(np.eye(sk, dtype=np.float32), (1, 2, sk, sk)).copy()
    tq, tv = torch.from_numpy(q), torch.from_numpy(v)
    no_drop = umfa_tpu_torch.attention(tq, tq, tv, dropout_p=0.0)
    np.testing.assert_allclose(no_drop.numpy(), np.full(q.shape, 1 / sk), atol=1e-6)
    assert umfa_tpu_torch.get_dispatch_stats()["naive_fallback"] == 0
    got = umfa_tpu_torch.attention(tq, tq, tv, dropout_p=p,
                                   dropout_generator=torch.Generator().manual_seed(0))
    want = umfa_tpu.attention(jnp.asarray(q), jnp.asarray(q), jnp.asarray(v), dropout_p=p,
                              dropout_key=jax.random.PRNGKey(0), interpret=True)
    for out in (got.numpy(), np.asarray(want)):
        keep = out * sk * (1 - p)
        np.testing.assert_allclose(keep[(keep > 0.5)], 1.0, atol=1e-5)
        assert abs((keep > 0.5).mean() - (1 - p)) < 0.03
    assert umfa_tpu_torch.get_dispatch_stats()["naive_fallback"] == 1
    with pytest.raises(ValueError, match="dropout_generator"):
        umfa_tpu_torch.attention(tq, tq, tv, dropout_p=p)


def test_unported_routes_raise():
    q, k, v = (torch.from_numpy(x) for x in _qkv(9, (1, 2, 64, 32)))
    # The int8 and int4 modes now take the quantized route (slice 3), as
    # the reference does; the values are held by test_torch_quant_training.
    umfa_tpu_torch.set_quantization_mode("int8", "row")
    out = umfa_tpu_torch.attention(q, k, v)
    assert out.shape == q.shape and torch.isfinite(out).all()
    umfa_tpu_torch.clear_quantization_mode()
    with umfa_tpu_torch.use_quantization("int4"):
        umfa_tpu_torch.attention(q, k, v)
    assert umfa_tpu_torch.get_quantization_mode() is None
    assert umfa_tpu_torch.get_dispatch_stats()["quantized_autograd"] == 2
    # int8-qdense keeps Q dense: the dense route, as in the reference.
    with umfa_tpu_torch.use_quantization("int8-qdense"):
        umfa_tpu_torch.attention(q, k, v)
    # A block mask walks on the dense route (int8-qdense's too; values held
    # by test_torch_block_mask.py) and on the integer-quantized route, which
    # takes it as quantized_flash_attention(block_mask=...) with no other
    # bias (values held by test_torch_quant_block_mask.py); the naive
    # dropout route still raises on one.
    from umfa_tpu_torch.engine.config import QuantizationConfig
    from umfa_tpu_torch.ops.quant_attention import quantized_flash_attention

    mask = umfa_tpu_torch.causal_block_mask(64, 64, device="cpu")
    with umfa_tpu_torch.use_quantization("int8-qdense"):
        out = umfa_tpu_torch.attention(q, k, v, mask)
    assert torch.isfinite(out).all()
    want = quantized_flash_attention(q, k, v, config=QuantizationConfig.from_mode_string("int8"),
                                     block_mask=mask)
    with umfa_tpu_torch.use_quantization("int8"):
        assert torch.equal(umfa_tpu_torch.attention(q, k, v, mask), want)
        assert torch.equal(umfa_tpu_torch.attention(q, k, v, lambda i, j: j <= i), want)
        with pytest.raises(NotImplementedError, match="block mask"):
            umfa_tpu_torch.attention(q, k, v, mask, dropout_p=0.1,
                                     dropout_generator=torch.Generator())
    assert umfa_tpu_torch.get_dispatch_stats()["quantized_autograd"] == 4
