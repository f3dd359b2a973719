"""Port parity: the DeepSeek-style model (models/deepseek.py).

tests/test_models.py's configurations (vocab 64, dim 128, 4 heads, latent
16, 4 experts, top 2, one shared, moe_hidden 64, fp32): JAX weights
(init_params with a PRNGKey) are carried into the port with
`params_from_jax`; token ids come from numpy. JAX runs its flash attention
in interpret mode on the CPU; the port runs its plain versions on the CPU.

Every layer's routes are recorded in both packages and compared before the
logits: a token whose top-k edge swaps (its k-th and (k+1)-th router
probabilities within 4 fp32 ulps) changes its own row and, through causal
attention, the rows after it, so the logits are held before the first such
token of each sequence (`_held_positions`).

Tolerances: logits and aux atol = rtol = 1e-5 against JAX (fp32 through
two layers, summed in other orders); the latent-cache decode against the
port's own forward atol = rtol = 5e-3, as tests/test_models.py:138-171
holds the reference's; greedy tokens equal.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umfa_tpu.models import deepseek as jds
from umfa_tpu.models import moe as jmoe
from umfa_tpu_torch.models import deepseek, moe

KW = dict(vocab=64, dim=128, num_heads=4, latent_dim=16, depth=2, num_experts=4, top_k=2,
          n_shared=1, moe_hidden=64, dtype="float32")
JCFG = jds.DeepSeekConfig(**KW, interpret=True)
CFG = deepseek.DeepSeekConfig(**KW)
FP32 = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def jparams():
    return jds.init_params(jax.random.PRNGKey(0), JCFG)


def _port(jparams, cfg=CFG):
    return deepseek.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                                    device="cpu")


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 64, shape).astype(np.int32)


@contextlib.contextmanager
def _routes(module, store):
    """Record (idx, probs) of every router_topk call of `module` (the JAX or
    the port's moe) as numpy, in call order."""
    inner = module.router_topk

    def record(params, x, cfg):
        w, idx, probs = inner(params, x, cfg)
        store.append((np.asarray(idx if not isinstance(idx, torch.Tensor) else idx.numpy()),
                      np.asarray(probs if not isinstance(probs, torch.Tensor)
                                 else probs.detach().numpy())))
        return w, idx, probs

    module.router_topk = record
    try:
        yield
    finally:
        module.router_topk = inner


def _held_positions(jroutes, routes, batch, k):
    """(B, S) positions before each sequence's first token routed otherwise
    in any layer; each such token's probability gap lies within 4 ulps."""
    assert len(jroutes) == len(routes)
    first = None
    for (jidx, jprobs), (idx, _) in zip(jroutes, routes):
        differ = (jidx != idx).any(-1)
        if differ.any():
            srt = -np.sort(-jprobs[differ], axis=-1)
            gap = srt[:, k - 1] - srt[:, k]
            assert (gap <= 4 * np.spacing(srt[:, k - 1])).all(), gap
        differ = differ.reshape(batch, -1)
        first = differ if first is None else first | differ
    return np.cumsum(first, axis=1) == 0


def test_forward_logits_and_aux_match_jax(jparams):
    tokens = _tokens(0, (2, 24))
    jr, tr = [], []
    with _routes(jmoe, jr):
        jlogits, jaux = jds.forward(jparams, jnp.asarray(tokens), JCFG)
    with _routes(moe, tr), torch.no_grad():
        logits, aux = deepseek.forward(_port(jparams), torch.from_numpy(tokens).long(), CFG)
    assert logits.shape == (2, 24, 64) and logits.dtype == torch.float32
    held = _held_positions(jr, tr, 2, CFG.top_k)
    np.testing.assert_allclose(logits.numpy()[held], np.asarray(jlogits)[held], **FP32)
    np.testing.assert_allclose(float(aux), float(jaux), **FP32)
    assert float(aux) >= CFG.depth * (1.0 - 1e-5)


def test_decode_step_matches_jax_and_its_forward(jparams):
    tokens = _tokens(1, (2, 12))
    model = _port(jparams)
    jcaches = jds.init_caches(JCFG, 2, 12)
    caches = deepseek.init_caches(CFG, 2, 12, device="cpu")
    with torch.no_grad():
        full, _ = deepseek.forward(model, torch.from_numpy(tokens).long(), CFG)
    jr, tr = [], []
    got, want = [], []
    for lo, hi in [(0, 8)] + [(t, t + 1) for t in range(8, 12)]:
        with _routes(jmoe, jr):
            jl, jcaches = jds.decode_step(jparams, jnp.asarray(tokens[:, lo:hi]), jcaches, JCFG)
        with _routes(moe, tr):
            tl, caches = deepseek.decode_step(model, torch.from_numpy(tokens[:, lo:hi]).long(),
                                              caches, CFG)
        want.append(np.asarray(jl))
        got.append(tl.numpy())
        np.testing.assert_allclose(tl.numpy(), full.numpy()[:, hi - 1], atol=5e-3, rtol=5e-3)
    for (jidx, _), (idx, _) in zip(jr, tr):
        np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(np.stack(got), np.stack(want), **FP32)
    assert [int(c.length[0]) for c in caches] == [12, 12]


def test_greedy_generate_matches_jax():
    # tests/test_models.py:174-188's configuration: depth 1, PRNGKey(1).
    jcfg = dataclasses.replace(JCFG, depth=1)
    cfg = dataclasses.replace(CFG, depth=1)
    jp = jds.init_params(jax.random.PRNGKey(1), jcfg)
    prompt = _tokens(2, (2, 6))
    want = np.asarray(jds.generate(jp, jnp.asarray(prompt), jcfg, max_new_tokens=5))
    model = _port(jp, cfg)
    got = deepseek.generate(model, torch.from_numpy(prompt).long(), cfg, max_new_tokens=5)
    assert got.shape == (2, 5)
    np.testing.assert_array_equal(got.numpy(), want)
    again = deepseek.generate(model, torch.from_numpy(prompt).long(), cfg, max_new_tokens=5)
    assert torch.equal(got, again)


def test_sampled_generate_follows_its_generator(jparams):
    model = _port(jparams)
    prompt = torch.from_numpy(_tokens(3, (2, 6))).long()

    def run(seed):
        return deepseek.generate(model, prompt, CFG, max_new_tokens=6, greedy=False,
                                 generator=torch.Generator().manual_seed(seed))

    a = run(0)
    assert a.shape == (2, 6) and ((a >= 0) & (a < CFG.vocab)).all()
    assert torch.equal(a, run(0))
    assert torch.equal(a, deepseek.generate(model, prompt, CFG, max_new_tokens=6,
                                            greedy=False))


def test_params_from_jax_keeps_the_router_and_gains_fp32():
    jcfg = dataclasses.replace(JCFG, dtype="bfloat16")
    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    jp = jds.init_params(jax.random.PRNGKey(0), jcfg)
    model = _port(jp, cfg)
    assert model.embed.dtype == torch.bfloat16 and model.lnf.dtype == torch.float32
    for layer in model.layers:
        assert layer.ln1.dtype == layer.ln2.dtype == torch.float32
        assert layer.ffn.router.dtype == torch.float32
        assert layer.ffn.w1.dtype == layer.attn.wq.dtype == torch.bfloat16
    init = deepseek.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    names = {n: tuple(p.shape) for n, p in init.named_parameters()}
    assert names == {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert init.layers[0].ffn.router.dtype == torch.float32


def test_bf16_forward_and_decode_agree(jparams):
    # The bf16 model end to end on the CPU: finite logits, aux >= depth,
    # and the latent-cache decode near its own forward (relerr 5e-2: bf16
    # through two layers, the absorbed and the decompressed routes round at
    # other points).
    from umfa_tpu_torch.utils.testing import rel_err

    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    model = deepseek.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(_tokens(4, (2, 16))).long()
    with torch.no_grad():
        full, aux = deepseek.forward(model, tokens, cfg)
    assert torch.isfinite(full).all() and float(aux) >= cfg.depth * (1 - 1e-5)
    caches = deepseek.init_caches(cfg, 2, 16, device="cpu")
    logits, caches = deepseek.decode_step(model, tokens, caches, cfg)
    assert rel_err(logits, full[:, -1]) <= 5e-2
