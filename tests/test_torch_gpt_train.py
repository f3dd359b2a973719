"""Port parity: training the GPT model (loss and every parameter gradient).

tests/test_gpt.py's configuration (vocab 64, dim 128, 4/2 heads, depth 2,
fp32): JAX weights (init_params with PRNGKey(0)) are carried into the port
with `params_from_jax`, token ids come from numpy. The JAX side runs
`jax.value_and_grad` of the next-token cross-entropy (its kernels in
interpret mode on the CPU); the port runs the same loss on the CPU and
`.backward()` through `flash_attention` and `ops/flash_bwd.py`.

Tolerances: loss abs 1e-5; each gradient atol = rtol = 1e-4, the backward
bound of tests/test_flash_backward.py:32 (fp32 through two layers; the two
stacks sum in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umfa_tpu.models import gpt as jgpt
from umfa_tpu_torch.models import gpt

JCFG = jgpt.GPTConfig(vocab=64, dim=128, num_heads=4, num_kv_heads=2, depth=2,
                      max_seq=96, interpret=True)
CFG = gpt.GPTConfig(vocab=64, dim=128, num_heads=4, num_kv_heads=2, depth=2, max_seq=96)
FP32 = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def jparams():
    return jgpt.init_params(jax.random.PRNGKey(0), JCFG)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, CFG.vocab, shape)


def _jloss(params, tokens):
    logits = jgpt.forward(params, tokens[:, :-1], JCFG)
    lp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    return -jnp.mean(jnp.take_along_axis(lp, tokens[:, 1:, None], axis=-1))


def loss_fn(model, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy in fp32 (tests/test_gpt.py:31-37)."""
    logits = model(tokens[:, :-1]).float()
    lp = torch.log_softmax(logits, dim=-1)
    return -lp.gather(-1, tokens[:, 1:, None]).mean()


def _port_params(model):
    """The port's parameters under the JAX tree's names."""
    named = {"embed": model.embed, "unembed": model.unembed}
    for i, block in enumerate(model.blocks):
        for name in ("wq", "wkv", "wo", "w1", "w2"):
            named[f"blocks.{i}.{name}"] = getattr(block, name)
    return named


def _jax_flat(tree):
    flat = {"embed": tree["embed"], "unembed": tree["unembed"]}
    for i, block in enumerate(tree["blocks"]):
        for name, val in block.items():
            flat[f"blocks.{i}.{name}"] = val
    return flat


def test_loss_and_every_gradient_match_jax(jparams):
    tokens = _tokens(11, (2, 49))
    want_loss, want_grads = jax.value_and_grad(_jloss)(jparams, jnp.asarray(tokens))
    model = gpt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), CFG, device="cpu")
    loss = loss_fn(model, torch.from_numpy(tokens))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    want = _jax_flat(want_grads)
    got = _port_params(model)
    assert sorted(got) == sorted(want)
    assert len(list(model.parameters())) == len(got) == 2 + 5 * CFG.depth
    for name, param in got.items():
        np.testing.assert_allclose(param.grad.numpy(), np.asarray(want[name]), err_msg=name, **FP32)


def test_sgd_step_reduces_loss(jparams):
    # Mirrors tests/test_gpt.py:27-41: one plain SGD step with lr 0.5.
    tokens = torch.from_numpy(_tokens(12, (2, 48)))
    model = gpt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), CFG, device="cpu")
    l0 = loss_fn(model, tokens)
    l0.backward()
    with torch.no_grad():
        for p in model.parameters():
            p -= 0.5 * p.grad
    assert loss_fn(model, tokens).item() < l0.item()


def test_serving_entry_points_stay_out_of_autograd(jparams):
    model = gpt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), CFG, device="cpu")
    caches = gpt.init_caches(CFG, 1, device="cpu")
    logits, _ = gpt.forward_with_cache(model, torch.from_numpy(_tokens(13, (1, 8))), caches,
                                       prefill=True)
    assert not logits.requires_grad and not caches[0].k.requires_grad
    out = gpt.generate(model, torch.from_numpy(_tokens(14, (1, 4))), 2)
    assert out.shape == (1, 6) and not out.requires_grad
