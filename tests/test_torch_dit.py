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
from umfa_tpu_torch.utils.testing import rel_err

JCFG = jdit.DiTConfig(dim=256, num_heads=4, depth=2, dtype="float32", interpret=True)
CFG = dit.DiTConfig(dim=256, num_heads=4, depth=2, dtype="float32")
FP32 = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 64


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
    cfg = dataclasses.replace(CFG, **{axis: "x"})
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        _port(jparams, cfg)
    model = _port(jparams, CFG)
    x, cond, _ = (torch.from_numpy(a) for a in _data(5))
    with pytest.raises(NotImplementedError, match="mesh layer"):
        dit.block_forward(model.blocks[0], x, cond, cfg)


def test_init_params_defaults_to_the_card():
    cfg = dataclasses.replace(CFG, depth=1)
    if torch.cuda.is_available():
        assert dit.init_params(cfg).blocks[0].wqkv.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dit.init_params(cfg)
