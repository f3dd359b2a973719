"""Port parity: the GPT model's forward and serving paths, and their
numerical traps (training: tests/test_torch_gpt_train.py).

JAX weights (init_params with PRNGKey(0)) are carried into the port with
`params_from_jax`; token ids come from numpy. The JAX model runs its
kernels in interpret mode on the CPU; the port runs on the CPU.

Tolerances: logits atol 1e-4 (fp32 through two layers; the two stacks sum
in other orders, measured ~1e-6); generated tokens identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umfa_tpu.models import gpt as jgpt
from umfa_tpu.ops import rope as jrope
from umfa_tpu_torch.engine.config import QuantizationConfig
from umfa_tpu_torch.models import gpt
from umfa_tpu_torch.ops import rope

JCFG = jgpt.GPTConfig(vocab=64, dim=128, num_heads=4, num_kv_heads=2, depth=2,
                      max_seq=96, interpret=True)
CFG = gpt.GPTConfig(vocab=64, dim=128, num_heads=4, num_kv_heads=2, depth=2, max_seq=96)


@pytest.fixture(scope="module")
def jparams():
    return jgpt.init_params(jax.random.PRNGKey(0), JCFG)


def _port(jparams, cfg=CFG):
    return gpt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, CFG.vocab, shape)


def test_layernorm_gelu_rope_traps_match_jax():
    rng = np.random.default_rng(0)
    x = (rng.normal(0, 3, (2, 5, 128)) + 1.5).astype(np.float32)
    # LayerNorm: no affine, eps 1e-6, population variance, fp32.
    np.testing.assert_allclose(gpt._ln(torch.from_numpy(x)).numpy(),
                               np.asarray(jgpt._ln(jnp.asarray(x))), atol=2e-6)
    # GELU: jax.nn.gelu defaults to the tanh approximation.
    h = torch.from_numpy(x)
    np.testing.assert_allclose(
        torch.nn.functional.gelu(h, approximate="tanh").numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(x))), atol=2e-6)
    # RoPE: both pairings, the exact inverse, and the model's tables.
    xr = rng.normal(0, 1, (2, 3, 10, 32)).astype(np.float32)
    cos, sin = rope.rope_angles(10, 32, device="cpu")
    jcos, jsin = jrope.rope_angles(10, 32)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    for interleaved in (True, False):
        for neg in (False, True):
            got = rope.apply_rope(torch.from_numpy(xr), cos, sin, negate_sin=neg,
                                  interleaved=interleaved)
            want = jrope.apply_rope(jnp.asarray(xr), jcos, jsin, negate_sin=neg,
                                    interleaved=interleaved)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
        back = rope.apply_rope(rope.apply_rope(torch.from_numpy(xr), cos, sin,
                                               interleaved=interleaved),
                               cos, sin, negate_sin=True, interleaved=interleaved)
        np.testing.assert_allclose(back.numpy(), xr, atol=1e-5)
    for pos in (np.arange(7) + 5, np.array([[3, 4], [9, 10]])):
        for got, want in zip(gpt._rope_tables(torch.from_numpy(pos), 32, 10000.0),
                             jgpt._rope_tables(jnp.asarray(pos), 32, 10000.0)):
            assert got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_rope_angles_default_to_the_card():
    """The device rule: without a device the tables go to the card, a
    RuntimeError where there is none, as every entry point's do."""
    if torch.cuda.is_available():
        assert rope.rope_angles(8, 16)[0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            rope.rope_angles(8, 16)
    assert rope.rope_angles(8, 16, device="cpu")[1].device.type == "cpu"


def test_forward_logits_match_jax(jparams):
    tokens = _tokens(1, (2, 40))
    want = np.asarray(jgpt.forward(jparams, jnp.asarray(tokens), JCFG))
    model = _port(jparams)
    got = model(torch.from_numpy(tokens))
    assert got.shape == (2, 40, CFG.vocab)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("kind", ["dtype", "int8"])
def test_forward_with_cache_prefill_chunk_and_decode_match_jax(jparams, kind):
    jcfg = dataclasses.replace(JCFG, kv_cache=kind)
    cfg = dataclasses.replace(CFG, kv_cache=kind)
    model = _port(jparams, cfg)
    tokens = _tokens(2, (2, 60))
    jc = jgpt.init_caches(jcfg, 2)
    tc = gpt.init_caches(cfg, 2, device="cpu")
    steps = [  # (start, end, kwargs): prefill, chunk_start, bias route, 8 decode steps
        (0, 24, dict(prefill=True)), (24, 32, dict(chunk_start=24)), (32, 52, {}),
        *[(t, t + 1, {}) for t in range(52, 60)],
    ]
    for a, b, kw in steps:
        want, jc = jgpt.forward_with_cache(jparams, jnp.asarray(tokens[:, a:b]), jc, jcfg, **kw)
        got, tc = gpt.forward_with_cache(model, torch.from_numpy(tokens[:, a:b]), tc, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0,
                                   err_msg=f"tokens {a}:{b}")
    assert int(tc[0].length[0]) == 60


@pytest.mark.parametrize("kind", ["dtype", "int8"])
def test_generate_tokens_identical_to_jax(jparams, kind):
    jcfg = dataclasses.replace(JCFG, kv_cache=kind)
    model = _port(jparams, dataclasses.replace(CFG, kv_cache=kind))
    prompt = _tokens(3, (2, 10))
    want = np.asarray(jgpt.generate(jparams, jnp.asarray(prompt), 6, jcfg))
    got = gpt.generate(model, torch.from_numpy(prompt), 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ragged_step_matches_jax(jparams):
    tokens = _tokens(4, (2, 20))
    model = _port(jparams)
    jc = jgpt.init_caches(JCFG, 2)
    tc = gpt.init_caches(CFG, 2, device="cpu")
    _, jc = jgpt.forward_with_cache(jparams, jnp.asarray(tokens), jc, JCFG)
    _, tc = gpt.forward_with_cache(model, torch.from_numpy(tokens), tc)
    for c in jc:
        c.length = c.length.at[1].set(12)
    for c in tc:
        c.length = torch.tensor([20, 12], dtype=torch.int32)
    new = _tokens(5, (2, 1))
    want, _ = jgpt.forward_with_cache(jparams, jnp.asarray(new), jc, JCFG, uniform_pos=False)
    got, _ = gpt.forward_with_cache(model, torch.from_numpy(new), tc, uniform_pos=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_init_params_scales_and_quantized_forward_refused():
    cfg = dataclasses.replace(CFG, dim=256, vocab=512)
    model = gpt.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert model.blocks[0].wq.shape == (256, 4, 64)
    assert model.blocks[0].wkv.shape == (256, 2, 2, 64)
    assert model.blocks[0].wo.shape == (4, 64, 256)
    assert all(p.requires_grad for p in model.parameters())  # trainable
    assert model.embed.std().item() == pytest.approx(256**-0.5, rel=0.02)
    assert model.blocks[1].w2.std().item() == pytest.approx(1024**-0.5, rel=0.02)
    again = gpt.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again.unembed, model.unembed)
    # The quantized training forward now runs (slice 3); its values are
    # held against JAX by test_torch_quant_training.
    qcfg = dataclasses.replace(CFG, quantization=QuantizationConfig())
    qmodel = gpt.init_params(qcfg, torch.Generator().manual_seed(0), device="cpu")
    logits = qmodel(torch.zeros((1, 4), dtype=torch.long))
    assert logits.shape == (1, 4, CFG.vocab) and torch.isfinite(logits).all()
