"""Port parity: the MoE FFN (models/moe.py).

JAX weights (moe.init_params with a PRNGKey) are carried into the port with
`params_from_jax`; inputs come from numpy (tests/test_moe.py's sizes). The
routes (each token's experts) are compared before the outputs: a top-k
edge may swap two experts when their probabilities lie within a few ulps,
and then only that token's row may differ (`_agreeing_rows`).

Tolerances: router weights atol 1e-6 and indices equal; the FFN output in
fp32 atol = rtol = 1e-5 (the same fp32 products, summed in other orders),
in bf16 relerr 2e-2 (TOL["bf16"]); the load-balance loss rtol 1e-6; the
gradients of sum(y²) + 0.01·aux in fp32 atol = rtol = 1e-4, the backward
bound of tests/test_flash_backward.py:32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umfa_tpu.models import moe as jmoe
from umfa_tpu_torch.models import moe
from umfa_tpu_torch.utils.testing import rel_err

BASE = dict(dim=32, hidden=48, num_experts=4, top_k=2, capacity_factor=4.0)


def _setup(seed=0, batch=2, seq=16, dtype="float32", **kw):
    jcfg = jmoe.MoEConfig(**{**BASE, **kw}, dtype=dtype)
    cfg = moe.MoEConfig(**{**BASE, **kw}, dtype=dtype)
    jp = jmoe.init_params(jax.random.PRNGKey(seed), jcfg)
    model = moe.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu")
    x = np.random.default_rng(seed).normal(0, 1, (batch, seq, cfg.dim)).astype(np.float32)
    jx = jnp.asarray(x, jcfg.jdtype)
    tx = torch.from_numpy(x).to(cfg.tdtype)
    return jcfg, cfg, jp, model, jx, tx


def _agreeing_rows(jidx, jprobs, idx, k):
    """Tokens routed alike in both packages; a token that differs must have
    its k-th and (k+1)-th probabilities within 4 fp32 ulps."""
    differ = (np.asarray(jidx) != idx.numpy()).any(-1)
    if differ.any():
        srt = -np.sort(-np.asarray(jprobs)[differ], axis=-1)
        gap = srt[:, k - 1] - srt[:, k]
        assert (gap <= 4 * np.spacing(srt[:, k - 1])).all(), gap
    return ~differ


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("routed_scale", [1.0, 0.7])
def test_router_topk_and_load_balance_loss_match_jax(dtype, routed_scale):
    jcfg, cfg, jp, model, jx, tx = _setup(1, dtype=dtype, num_experts=8, top_k=3,
                                          routed_scale=routed_scale)
    jw, jidx, jprobs = jmoe.router_topk(jp, jx.reshape(-1, cfg.dim), jcfg)
    w, idx, probs = moe.router_topk(model, tx.reshape(-1, cfg.dim), cfg)
    assert w.dtype == probs.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(probs.detach().numpy(), np.asarray(jprobs), atol=1e-6)
    aux = moe.load_balance_loss(probs, idx, cfg.num_experts)
    want = jmoe.load_balance_loss(jprobs, jidx, cfg.num_experts)
    np.testing.assert_allclose(float(aux.detach()), float(want), rtol=1e-6)
    assert float(aux.detach()) >= 1.0 - 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dispatch", ["ragged", "dense"])
@pytest.mark.parametrize("shared", [0, 1])
def test_moe_ffn_matches_jax(dtype, dispatch, shared):
    jcfg, cfg, jp, model, jx, tx = _setup(2, dtype=dtype, dispatch=dispatch, n_shared=shared,
                                          routed_scale=0.7 if shared else 1.0)
    _, jidx, jprobs = jmoe.router_topk(jp, jx.reshape(-1, cfg.dim), jcfg)
    _, idx, _ = moe.router_topk(model, tx.reshape(-1, cfg.dim), cfg)
    rows = _agreeing_rows(jidx, jprobs, idx, cfg.top_k)
    jy, jaux = jmoe.moe_ffn(jp, jx, jcfg)
    with torch.no_grad():
        y, aux = moe.moe_ffn(model, tx, cfg)
    assert y.shape == tx.shape and y.dtype == tx.dtype
    got = y.float().numpy().reshape(-1, cfg.dim)[rows]
    want = np.asarray(jy, np.float32).reshape(-1, cfg.dim)[rows]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert rel_err(got, want) <= 2e-2
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def test_dense_dispatch_drops_as_jax_under_tight_capacity():
    # capacity_factor 0.5: tokens past an expert's capacity are dropped, the
    # same tokens in both packages (tests/test_moe.py:78-94).
    jcfg, cfg, jp, model, jx, tx = _setup(3, dispatch="dense", capacity_factor=0.5)
    jy, _ = jmoe.moe_ffn(jp, jx, jcfg)
    with torch.no_grad():
        y, _ = moe.moe_ffn(model, tx, cfg)
        y_full, _ = moe.moe_ffn(model, tx, dataclasses.replace(cfg, capacity_factor=8.0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    assert torch.isfinite(y).all()
    assert torch.linalg.norm(y) < torch.linalg.norm(y_full)


def test_ragged_equals_dense_under_ample_capacity():
    _, cfg, _, model, _, tx = _setup(4, num_experts=8)
    with torch.no_grad():
        yr, _ = moe.moe_ffn(model, tx, cfg)
        yd, _ = moe.moe_ffn(model, tx, dataclasses.replace(cfg, dispatch="dense",
                                                           capacity_factor=8.0))
    np.testing.assert_allclose(yr.numpy(), yd.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dispatch", ["ragged", "dense"])
def test_moe_gradients_match_jax(dispatch):
    # The port of tests/test_moe.py:105-122, held to jax.grad of the same loss.
    jcfg, cfg, jp, model, jx, tx = _setup(5, batch=1, seq=8, dispatch=dispatch, dim=16,
                                          hidden=24, n_shared=1)

    def jloss(p):
        y, aux = jmoe.moe_ffn(p, jx, jcfg)
        return jnp.sum(y**2) + 0.01 * aux

    want = jax.grad(jloss)(jp)
    y, aux = moe.moe_ffn(model, tx, cfg)
    (y.square().sum() + 0.01 * aux).backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[name]), atol=1e-4, rtol=1e-4,
                                   err_msg=name)
    assert float(model.w2.grad.abs().sum()) > 0 and float(model.router.grad.abs().sum()) > 0


def test_moe_combine_gives_the_same_bits_twice():
    _, cfg, _, model, _, tx = _setup(6, batch=4, seq=32, num_experts=8, top_k=3, n_shared=1)
    with torch.no_grad():
        a, _ = moe.moe_ffn(model, tx, cfg)
        b, _ = moe.moe_ffn(model, tx, cfg)
    assert torch.equal(a, b)


def test_ep_axis_raises():
    # The dense dispatch refuses an ep_axis that no current mesh has, naming
    # it; the ragged one ignores ep_axis, as the reference's does.
    from umfa_tpu_torch.parallel import make_mesh

    cfg = moe.MoEConfig(**BASE, dtype="float32", dispatch="dense", ep_axis="ep")
    model = moe.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    x = torch.zeros((1, 4, cfg.dim))
    with pytest.raises(ValueError, match="'ep'"):
        moe.moe_ffn(model, x, cfg)
    with make_mesh(dp=2, devices=["cpu"] * 2), pytest.raises(ValueError, match="'ep'"):
        moe.moe_ffn(model, x, cfg)
    ragged = dataclasses.replace(cfg, dispatch="ragged")
    assert torch.equal(moe.moe_ffn(model, x, ragged)[0],
                       moe.moe_ffn(model, x, dataclasses.replace(ragged, ep_axis=None))[0])


def test_params_keep_the_router_fp32():
    _, cfg, jp, model, _, _ = _setup(7, dtype="bfloat16", n_shared=1)
    assert model.router.dtype == torch.float32
    assert all(getattr(model, n).dtype == torch.bfloat16 for n in ("w1", "w3", "w2", "ws1"))
    init = moe.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert init.router.dtype == torch.float32 and init.w1.dtype == torch.bfloat16
    for name, p in init.named_parameters():
        assert tuple(p.shape) == jp[name].shape, name
