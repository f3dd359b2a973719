"""Port parity: utils/interop.py (umfa_tpu/utils/interop.py).

The port's SDPA override against JAX's `torch_sdpa` (its kernels in
interpret mode) on the same CPU tensors from a numpy seed: fp32
atol = rtol = 2e-5 (TOL["fp32"]). Every test restores
`F.scaled_dot_product_attention` in a `finally`: the tests of one file run
in one worker, and a leaked override would reach every later test there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from umfa_tpu.utils import interop as jinterop
from umfa_tpu_torch.engine import stats
from umfa_tpu_torch.utils import interop

FP32 = dict(atol=2e-5, rtol=2e-5)
NATIVE = F.scaled_dot_product_attention


def _overridden():
    return getattr(F.scaled_dot_product_attention, "_umfa_override", False)


def _qkv(seed, hq=4, hkv=4, s=64, d=32):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(0, 1, (2, hq, s, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(0, 1, (2, hkv, s, d)).astype(np.float32))
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("case", ["causal", "bool_mask", "gqa", "float_bias"])
def test_override_matches_the_jax_torch_sdpa(case):
    q, k, v = _qkv(0, hkv=2 if case == "gqa" else 4)
    kw, jkw = {}, {}
    if case in ("causal", "gqa"):
        kw = jkw = dict(is_causal=True)
    elif case == "bool_mask":
        mask = torch.from_numpy(np.random.default_rng(1).random((2, 1, 64, 64)) > 0.3)
        kw = jkw = dict(attn_mask=mask)
    else:
        bias = torch.from_numpy(np.random.default_rng(2).normal(0, 1, (1, 4, 64, 64))
                                .astype(np.float32))
        kw = jkw = dict(attn_mask=bias, scale=0.2)
    if case == "gqa":
        kw = dict(kw, enable_gqa=True)
    want = jinterop.torch_sdpa(q, k, v, interpret=True, **jkw)
    uninstall = interop.install_torch_sdpa()
    try:
        stats.reset_dispatch_stats()
        got = F.scaled_dot_product_attention(q, k, v, **kw)
        assert stats.get_dispatch_stats()["fused_autograd"] == 1
    finally:
        uninstall()
    assert F.scaled_dot_product_attention is NATIVE
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FP32)
    direct = interop.torch_sdpa(q, k, v, **{n: a for n, a in kw.items() if n != "enable_gqa"})
    assert torch.equal(got, direct)


def test_override_takes_gradients_through_the_port():
    q, k, v = (t.requires_grad_(True) for t in _qkv(3))
    try:
        with interop.use_torch_sdpa():
            F.scaled_dot_product_attention(q, k, v, is_causal=True).square().sum().backward()
    finally:
        if _overridden():
            interop._set_sdpa(NATIVE)
    grads = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    NATIVE(q, k, v, is_causal=True).square().sum().backward()
    for g, t in zip(grads, (q, k, v)):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), atol=1e-4, rtol=1e-4)


def test_refcounted_single_shot_uninstallers():
    uninstall = interop.install_torch_sdpa()
    try:
        assert _overridden()
        inner = interop.install_torch_sdpa()
        inner()
        assert _overridden()
        inner()  # a second release of one handle does nothing
        assert _overridden()
        with interop.use_torch_sdpa():
            with interop.use_torch_sdpa():
                assert _overridden()
            assert _overridden()
        assert _overridden()
    finally:
        uninstall()
    assert F.scaled_dot_product_attention is NATIVE
    uninstall()
    assert F.scaled_dot_product_attention is NATIVE and interop._sdpa_install_count == 0


def test_pass_through_keeps_torchs_own_function(monkeypatch):
    calls = []

    def native(*args, **kwargs):
        calls.append(kwargs)
        return NATIVE(*args, **kwargs)

    monkeypatch.setattr(F, "scaled_dot_product_attention", native)
    q, k, v = _qkv(4)
    try:
        with interop.use_torch_sdpa():
            stats.reset_dispatch_stats()
            F.scaled_dot_product_attention(q, k, v, dropout_p=0.5)          # dropout
            F.scaled_dot_product_attention(q[0], k[0], v[0])                 # 3-D
            F.scaled_dot_product_attention(q.double(), k.double(), v.double())  # dtype
            with pytest.raises(RuntimeError):  # heads differ, no enable_gqa: torch's error
                F.scaled_dot_product_attention(q, k[:, :2], v[:, :2])
            assert stats.get_dispatch_stats()["total"] == 0
            assert len(calls) == 4
            F.scaled_dot_product_attention(q, k, v)
            assert len(calls) == 4 and stats.get_dispatch_stats()["total"] == 1
    finally:
        if _overridden():
            interop._set_sdpa(native)
    assert F.scaled_dot_product_attention is native


def test_dlpack_round_trip_with_jax():
    a = jnp.arange(12, dtype=jnp.float32).reshape(3, 4)
    t = interop.from_dlpack(a)
    assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    x = torch.randn(2, 5, requires_grad=True)
    back = jnp.from_dlpack(interop.to_dlpack(x))
    np.testing.assert_array_equal(np.asarray(back), x.detach().numpy())
    n = np.from_dlpack(interop.to_dlpack(x))
    np.testing.assert_array_equal(n, x.detach().numpy())
    assert interop.from_dlpack(x) is x
    with pytest.raises(TypeError):
        interop.from_dlpack([1, 2])
