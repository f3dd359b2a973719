"""Port parity: the FLUX-style DiT (models/dit.py), dense and quantized.

tests/test_models.py's configuration (dim 256, 4 heads, depth 2, S 64,
fp32): JAX weights (init_params with PRNGKey(0)) are carried into the port
with `params_from_jax`; inputs, cond and the regression target come from
numpy. The JAX side runs `jax.value_and_grad` of the mean squared error
(its kernels in interpret mode on the CPU); the port runs the same loss on
the CPU and `.backward()` through `flash_attention` (dense) or
`quantized_flash_attention` (STE).

Tolerances: dense, the GPT training test's (tests/test_torch_gpt_train.py):
forward and every gradient atol = rtol = 1e-4, loss abs 1e-5 (fp32 through
two blocks, the stacks summing in other orders). int8 and int4, those of
tests/test_torch_quant_training.py's GPT: loss abs 1e-4 and every
gradient relerr 1e-2 (an activation may cross a quantizer rounding boundary
in either package).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umfa_tpu.engine.config import QuantizationConfig as JQuantizationConfig
from umfa_tpu.models import dit as jdit
from umfa_tpu_torch.engine.config import QuantizationConfig
from umfa_tpu_torch.models import dit
from umfa_tpu_torch.parallel import make_mesh
from umfa_tpu_torch.utils.testing import rel_err

JCFG = jdit.DiTConfig(dim=256, num_heads=4, depth=2, dtype="float32", interpret=True)
CFG = dit.DiTConfig(dim=256, num_heads=4, depth=2, dtype="float32")
FP32 = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 64
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def jparams():
    return jdit.init_params(jax.random.PRNGKey(0), JCFG)


def _data(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, S, CFG.dim)).astype(np.float32),
            rng.normal(0, 1, (B, CFG.dim)).astype(np.float32),
            rng.normal(0, 1, (B, S, CFG.dim)).astype(np.float32))


def _port(jparams, cfg):
    return dit.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")


def _loss(model, x, cond, tgt):
    return ((dit.forward(model, x, cond).float() - tgt) ** 2).mean()


def _jloss(params, x, cond, tgt, cfg):
    return jnp.mean((jdit.forward(params, x, cond, cfg) - tgt) ** 2)


def _grads_against_jax(jparams, jcfg, cfg, seed):
    x, cond, tgt = _data(seed)
    want_loss, want = jax.value_and_grad(_jloss)(jparams, *(jnp.asarray(a) for a in (x, cond, tgt)),
                                                 jcfg)
    model = _port(jparams, cfg)
    loss = _loss(model, *(torch.from_numpy(a) for a in (x, cond, tgt)))
    loss.backward()
    named = dict(model.named_parameters())
    assert len(named) == len(dit.PARAMS) * cfg.depth
    pairs = {name: (named[f"blocks.{i}.{name}"].grad, want["blocks"][i][name])
             for i in range(cfg.depth) for name in dit.PARAMS}
    return loss.item(), float(want_loss), pairs, model


def test_forward_matches_jax(jparams):
    x, cond, _ = _data(1)
    want = jdit.forward(jparams, jnp.asarray(x), jnp.asarray(cond), JCFG)
    model = _port(jparams, CFG)
    with torch.no_grad():
        got = dit.forward(model, torch.from_numpy(x), torch.from_numpy(cond))
    assert got.shape == (B, S, CFG.dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


def test_loss_and_every_gradient_match_jax(jparams):
    loss, want_loss, pairs, _ = _grads_against_jax(jparams, JCFG, CFG, 2)
    assert abs(loss - want_loss) <= 1e-5
    for name, (got, want) in pairs.items():
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=name, **FP32)


@pytest.mark.parametrize("recipe", ["int8", "int4"])
def test_quantized_loss_and_every_gradient_match_jax(jparams, recipe):
    jq = JQuantizationConfig() if recipe == "int8" else JQuantizationConfig.from_mode_string("int4")
    tq = QuantizationConfig() if recipe == "int8" else QuantizationConfig.from_mode_string("int4")
    loss, want_loss, pairs, model = _grads_against_jax(
        jparams, dataclasses.replace(JCFG, quantization=jq),
        dataclasses.replace(CFG, quantization=tq), 3)
    assert abs(loss - want_loss) <= 1e-4
    for name, (got, want) in pairs.items():
        assert rel_err(got, np.asarray(want)) <= 1e-2, name


@pytest.mark.parametrize("recipe", [None, "int8"])
def test_sgd_step_reduces_loss(jparams, recipe):
    # Mirrors tests/test_models.py:25-42 and :63-80: one plain SGD step, lr 1e-2.
    cfg = CFG if recipe is None else dataclasses.replace(CFG, quantization=QuantizationConfig())
    x, cond, tgt = (torch.from_numpy(a) for a in _data(4))
    model = _port(jparams, cfg)
    l0 = _loss(model, x, cond, tgt)
    l0.backward()
    with torch.no_grad():
        for p in model.parameters():
            p -= 1e-2 * p.grad
    assert _loss(model, x, cond, tgt).item() < l0.item()


def test_init_params_scales_and_layouts():
    cfg = dataclasses.replace(CFG, depth=1)
    model = dit.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    blk = model.blocks[0]
    hidden = cfg.dim * cfg.mlp_ratio
    shapes = {"wqkv": (cfg.dim, 3, cfg.num_heads, cfg.head_dim),
              "wo": (cfg.num_heads, cfg.head_dim, cfg.dim), "w1": (cfg.dim, hidden),
              "b1": (hidden,), "w2": (hidden, cfg.dim), "b2": (cfg.dim,),
              "wmod": (cfg.dim, 6, cfg.dim), "bmod": (6, cfg.dim)}
    assert {n: tuple(getattr(blk, n).shape) for n in dit.PARAMS} == shapes
    assert blk.wqkv.std().item() == pytest.approx(cfg.dim**-0.5, rel=0.05)
    assert blk.wmod.std().item() == pytest.approx(0.1 * cfg.dim**-0.5, rel=0.05)
    assert not blk.b1.any() and not blk.bmod.any()
    assert all(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("axis", ["tp_axis", "sp_axis"])
def test_sharded_routes_raise(jparams, axis):
    # An axis that no current mesh has raises a ValueError naming it.
    cfg = dataclasses.replace(CFG, **{axis: "x"})
    model = _port(jparams, cfg)
    x, cond, _ = (torch.from_numpy(a) for a in _data(5))
    with pytest.raises(ValueError, match="'x'"):
        dit.block_forward(model.blocks[0], x, cond, cfg)
    with make_mesh(dp=1, sp=2, tp=2, devices=CPU8), pytest.raises(ValueError, match="'x'"):
        dit.forward(model, x, cond)
    qcfg = dataclasses.replace(CFG, sp_axis="sp", quantization=QuantizationConfig())
    with make_mesh(sp=2, devices=CPU8), pytest.raises(ValueError, match="quantized ring"):
        dit.forward(_port(jparams, qcfg), x, cond)


# The mesh routes at __graft_entry__.py:69-79's width: dim 256, 8 heads,
# depth 2, batch 2, S 128 a sequence rank; dp1/sp4/tp2 on 8 virtual ranks.
MESH_JCFG = jdit.DiTConfig(dim=256, num_heads=8, depth=2, dtype="float32", interpret=True)
MESH_SIZES = dict(dp=1, sp=4, tp=2)
MESH_B, MESH_S = 2, 512
# Bound on the reference's own bf16 sharded-vs-single spread at this width
# (measured 1.05e-3 relerr); chip_smoke.py phase 18's DiT gate is twice it.
REF_BF16_SPREAD = 2e-3


@pytest.fixture(scope="module")
def mesh_jparams():
    return jdit.init_params(jax.random.PRNGKey(0), MESH_JCFG)


def _mesh_data():
    rng = np.random.default_rng(11)
    x, tgt = (rng.normal(0, 1, (MESH_B, MESH_S, 256)).astype(np.float32) for _ in range(2))
    cond = rng.normal(0, 1, (MESH_B, 256)).astype(np.float32)
    return x, cond, tgt


def _jax_sharded_forward(jparams, jcfg, x, cond, tgt):
    """The reference's sharded forward and loss (__graft_entry__.py:81-106:
    parameter shardings, the loss psum'd over ("dp", "sp"))."""
    from jax.sharding import Mesh as JMesh
    from jax.sharding import PartitionSpec as P

    from umfa_tpu.utils.compat import shard_map

    cfg = dataclasses.replace(jcfg, tp_axis="tp", sp_axis="sp")
    mesh = JMesh(np.array(jax.devices()[:8]).reshape(1, 4, 2), ("dp", "sp", "tp"))
    block = {"wqkv": P(None, None, "tp", None), "wo": P("tp", None, None), "w1": P(None, "tp"),
             "b1": P("tp"), "w2": P("tp", None), "b2": P(), "wmod": P(), "bmod": P()}
    specs = {"blocks": [dict(block) for _ in range(jcfg.depth)]}
    xs = P("dp", "sp", None)

    def body(params, x, cond, tgt):
        pred = jdit.forward(params, x, cond, cfg)
        local = jnp.sum((pred.astype(jnp.float32) - tgt) ** 2)
        return pred, jax.lax.psum(local, ("dp", "sp")) / (MESH_B * MESH_S * jcfg.dim)

    f = shard_map(body, mesh=mesh, in_specs=(specs, xs, P("dp", None), xs), out_specs=(xs, P()))
    pred, loss = jax.jit(f)(jparams, *(jnp.asarray(a, jcfg.jdtype) for a in (x, cond)),
                            jnp.asarray(tgt))
    return np.asarray(pred, np.float32), float(loss)


def test_mesh_forward_and_gradients(mesh_jparams):
    # Forward and loss against the reference's shard_map forward; every
    # gradient against jax.value_and_grad of the UNSHARDED forward (the
    # reference's sharded step scales them by tp and sp: ROADMAP.md).
    x, cond, tgt = _mesh_data()
    want_pred, want_loss = _jax_sharded_forward(mesh_jparams, MESH_JCFG, x, cond, tgt)
    _, want = jax.value_and_grad(_jloss)(mesh_jparams,
                                         *(jnp.asarray(a) for a in (x, cond, tgt)), MESH_JCFG)
    cfg = dit.DiTConfig(dim=256, num_heads=8, depth=2, dtype="float32", tp_axis="tp",
                        sp_axis="sp")
    model = _port(mesh_jparams, cfg)
    with make_mesh(**MESH_SIZES, devices=CPU8):
        pred = dit.forward(model, *(torch.from_numpy(a) for a in (x, cond)))
    loss = ((pred - torch.from_numpy(tgt)) ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(pred.detach().numpy(), want_pred, **FP32)
    assert abs(loss.item() - want_loss) <= 1e-5
    named = dict(model.named_parameters())
    for i in range(cfg.depth):
        for name in dit.PARAMS:
            np.testing.assert_allclose(named[f"blocks.{i}.{name}"].grad.numpy(),
                                       np.asarray(want["blocks"][i][name]),
                                       err_msg=f"blocks.{i}.{name}", **FP32)


def test_mesh_bf16_spread_within_the_references(mesh_jparams):
    # bf16: how far the reference's sharded forward sits from its own
    # single-device forward, and the port's mesh forward from its own.
    jcfg = dataclasses.replace(MESH_JCFG, dtype="bfloat16")
    jparams = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), mesh_jparams)
    x, cond, tgt = _mesh_data()
    sharded, _ = _jax_sharded_forward(jparams, jcfg, x, cond, tgt)
    single = np.asarray(jdit.forward(jparams, *(jnp.asarray(a, jnp.bfloat16) for a in (x, cond)),
                                     jcfg), np.float32)
    ref_spread = rel_err(sharded, single)
    cfg = dit.DiTConfig(dim=256, num_heads=8, depth=2, dtype="bfloat16")
    tx, tc = (torch.from_numpy(a).bfloat16() for a in (x, cond))
    with torch.no_grad():
        one = dit.forward(_port(jparams, cfg), tx, tc)
        with make_mesh(**MESH_SIZES, devices=CPU8):
            mesh = dit.forward(_port(jparams, dataclasses.replace(cfg, tp_axis="tp",
                                                                  sp_axis="sp")), tx, tc)
    port_spread = rel_err(mesh, one)
    assert 0 < ref_spread <= REF_BF16_SPREAD, ref_spread
    assert port_spread <= 2 * ref_spread, (port_spread, ref_spread)
    assert rel_err(mesh, sharded) <= 2 * REF_BF16_SPREAD


def test_init_params_defaults_to_the_card():
    cfg = dataclasses.replace(CFG, depth=1)
    if torch.cuda.is_available():
        assert dit.init_params(cfg).blocks[0].wqkv.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dit.init_params(cfg)
