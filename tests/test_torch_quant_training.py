"""Port parity: quantized training — `attention()` under a quantization mode,
`quantized_flash_attention`, and the GPT with `cfg.quantization` — against
`jax.grad` / `jax.value_and_grad` of the JAX package (Pallas kernels in
interpret mode on the CPU); the port runs its plain PyTorch paths on the
CPU. Inputs come from numpy seeds.

Tolerances, with their reasons:
  * attention outputs relerr 1e-3 and LSE abs 1e-3, the forward's bounds
    (tests/test_torch_quant_fused.py; under the INT4 recipe's Hadamard
    rotation >= 99.5 % of the rows hold 1e-3 and every row 3e-2, for the
    one-code flips explained there);
  * q/k/v gradients relerr 5e-3 under INT8 and 2e-2 under INT4: the
    reference's own STE contract (tests/test_quantized_attention.py:402-409),
    which bounds what a one-code flip of a residual (allowed between the
    two quantizers) can do to a gradient;
  * the bias gradient (fp32 dense kernel on the same dequantized operands):
    relerr 5e-3;
  * GPT (int8, int4, int8 BLOCK, int8 ASYMMETRIC): loss abs 1e-4 and
    every parameter's gradient relerr 1e-2. The two
    stacks compute LayerNorm, RoPE and the projections in fp32 in other
    orders, so an activation may cross a quantizer rounding boundary (one
    code) in either package; through two layers that moves a gradient by up
    to ~1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import umfa_tpu
import umfa_tpu_torch
from umfa_tpu.engine.config import QuantizationConfig as JQuantizationConfig
from umfa_tpu.engine.config import QuantStrategy as JQuantStrategy
from umfa_tpu.models import gpt as jgpt
from umfa_tpu.ops.quant_attention import quantized_flash_attention as jqflash
from umfa_tpu_torch import _kernels
from umfa_tpu_torch.engine.config import QuantizationConfig, QuantMode, QuantStrategy
from umfa_tpu_torch.models import gpt
from umfa_tpu_torch.ops.quant_attention import quantized_flash_attention
from umfa_tpu_torch.utils.testing import rel_err


@pytest.fixture(autouse=True)
def _clean_state():
    for pkg in (umfa_tpu, umfa_tpu_torch):
        pkg.reset_dispatch_stats()
        pkg.clear_quantization_mode()
    yield
    for pkg in (umfa_tpu, umfa_tpu_torch):
        pkg.clear_quantization_mode()


def _x(seed, shape, offset=0.0):
    return (np.random.default_rng(seed).normal(0, 1, shape) + offset).astype(np.float32)


def _grad_tol(mode):
    return 2e-2 if mode.startswith("int4") else 5e-3


ATTN_CASES = [
    # id, (precision, mode), kwargs, bias (bias_grad), lse cotangent, env[, head_dim]
    ("int8_causal", ("int8", "row"), dict(is_causal=True), None, False, {}),
    ("int4_causal_lse", ("int4", "row"), dict(is_causal=True), None, True, {}),
    ("int8_tensor_two_pass", ("int8", "tensor"), dict(is_causal=True), None, False, {}),
    ("int8_bias_grad_lse", ("int8", "row"), {}, True, True, {}),
    ("int4_bias_no_grad", ("int4", "row"), {}, False, False, {}),
    ("int8_disable_fused", ("int8", "row"), dict(is_causal=True), None, False,
     {"UMFA_DISABLE_FUSED_QUANT": "1"}),
    # The two-pass route at a head_dim that is not a multiple of 4.
    ("int8_two_pass_d63", ("int8", "row"), dict(is_causal=True), None, False,
     {"UMFA_DISABLE_FUSED_QUANT": "1"}, 63),
    # set_quantization_mode(..., "block") on the single-launch route, and the
    # int4 recipe on the two-pass route (INT4 operands, the Q-mean row).
    ("int8_block_causal", ("int8", "block"), dict(is_causal=True), None, False, {}),
    ("int4_block_bias_grad", ("int4", "block"), {}, True, False, {}),
    ("int4_two_pass_lse", ("int4", "row"), dict(is_causal=True), None, True,
     {"UMFA_DISABLE_FUSED_QUANT": "1"}),
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_attention_quantized_gradients_match_jax(case, monkeypatch):
    _, (prec, mode), kw, bias_grad, lse_cot, env = case[:6]
    d = case[6] if len(case) > 6 else 64
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    shape_q, shape_kv = (2, 4, 128, d), (2, 2, 128, d)
    q, k, v = _x(1, shape_q), _x(2, shape_kv, 0.5), _x(3, shape_kv, 0.3)
    bias = None if bias_grad is None else _x(4, (1, 4, 128, 128))
    w, w_lse = _x(5, shape_q), _x(6, shape_q[:3])
    bg = bool(bias_grad)

    def jloss(q, k, v, bias):
        out, lse = umfa_tpu.attention_with_lse(q, k, v, bias, bias_grad=bg, interpret=True, **kw)
        return jnp.sum(out * w) + (jnp.sum(lse * w_lse) if lse_cot else 0.0), (out, lse)

    umfa_tpu.set_quantization_mode(prec, mode)
    jargs = [jnp.asarray(x) for x in (q, k, v)] + [None if bias is None else jnp.asarray(bias)]
    argn = (0, 1, 2, 3) if bias is not None else (0, 1, 2)
    (_, (j_out, j_lse)), jgrads = jax.value_and_grad(jloss, argnums=argn, has_aux=True)(*jargs)

    umfa_tpu_torch.set_quantization_mode(prec, mode)
    t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    tb = None if bias is None else torch.from_numpy(bias).requires_grad_(True)
    _kernels.reset_launch_counts()
    out, lse = umfa_tpu_torch.attention_with_lse(*t, tb, bias_grad=bg, **kw)
    loss = (out * torch.from_numpy(w)).sum()
    if lse_cot:
        loss = loss + (lse * torch.from_numpy(w_lse)).sum()
    loss.backward()
    assert rel_err(out.detach(), np.asarray(j_out)) <= 1e-3
    lse_err = np.abs(lse.detach().numpy() - np.asarray(j_lse))
    if prec == "int4":
        assert (lse_err <= 1e-3).mean() >= 0.995 and lse_err.max() <= 3e-2
    else:
        assert lse_err.max() <= 1e-3
    tol = _grad_tol(prec)
    for name, tg, jg in zip(("dq", "dk", "dv"), t, jgrads):
        assert rel_err(tg.grad, np.asarray(jg)) <= tol, name
    if bias is not None:
        if bias_grad:
            assert rel_err(tb.grad, np.asarray(jgrads[3])) <= 5e-3
        else:
            assert torch.equal(tb.grad, torch.zeros_like(tb))
    stats = umfa_tpu_torch.get_dispatch_stats()
    assert stats["quantized_autograd"] == 1 and stats["naive_fallback"] == 0
    # CPU tensors: the plain versions ran, no kernel was launched.
    assert sum(_kernels.launches.values()) == 0


def test_quantized_flash_attention_qdense_and_no_grad_match_jax():
    q, k, v = _x(7, (1, 4, 128, 32)), _x(8, (1, 2, 128, 32), 0.5), _x(9, (1, 2, 128, 32))
    w = _x(10, q.shape)
    jcfg = JQuantizationConfig.from_mode_string("int8-qdense")
    tcfg = QuantizationConfig.from_mode_string("int8-qdense")

    def jloss(q, k, v):
        return jnp.sum(jqflash(q, k, v, config=jcfg, causal=True, interpret=True) * w)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    (quantized_flash_attention(*t, config=tcfg, causal=True) * torch.from_numpy(w)).sum().backward()
    for name, tg, jg in zip(("dq", "dk", "dv"), t, jgrads):
        assert rel_err(tg.grad, np.asarray(jg)) <= 5e-3, name
    # Without gradients the kernel writes no residuals; the values are the same.
    with torch.no_grad():
        bare = quantized_flash_attention(*t, config=tcfg, causal=True, return_lse=True)
    full = quantized_flash_attention(*t, config=tcfg, causal=True, return_lse=True)
    assert torch.equal(bare[0], full[0].detach()) and torch.equal(bare[1], full[1].detach())


def test_unported_quantized_configs_raise(monkeypatch):
    q, k, v = (torch.from_numpy(_x(s, (1, 2, 64, 32))) for s in (11, 12, 13))
    base = QuantizationConfig()
    asym = dataclasses.replace(base, strategy=QuantStrategy.ASYMMETRIC)
    # pv_int8 runs (its values against JAX: tests/test_torch_quant_pv_int8.py);
    # with ASYMMETRIC the reference sends it to the two-pass route, which
    # refuses it: a ValueError here.
    out = quantized_flash_attention(q, k, v, config=dataclasses.replace(base, pv_int8=True))
    assert out.shape == q.shape and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="symmetric"):
        quantized_flash_attention(q, k, v, config=dataclasses.replace(asym, pv_int8=True))
    # BLOCK and ASYMMETRIC run (their values against JAX:
    # tests/test_torch_quant_variants.py).
    for good in (asym, dataclasses.replace(base, mode=QuantMode.BLOCK)):
        out = quantized_flash_attention(q, k, v, config=good)
        assert out.shape == q.shape and torch.isfinite(out).all()
    hot = q.clone()
    hot[:, :, 7] *= 1000.0  # one outlier row: HYBRID picks BLOCK
    block = quantized_flash_attention(hot, k, v, config=dataclasses.replace(base, mode=QuantMode.BLOCK))
    hybrid = quantized_flash_attention(hot, k, v, config=dataclasses.replace(base, mode=QuantMode.HYBRID))
    assert torch.equal(hybrid, block)
    monkeypatch.setenv("UMFA_DISABLE_FUSED_QUANT", "1")
    # The two-pass route runs the int4 recipe (INT4 operands and the Q-mean
    # row) and pv_int8 (V per KV tile).
    out = quantized_flash_attention(q, k, v, config=QuantizationConfig.from_mode_string("int4"))
    assert out.shape == q.shape and torch.isfinite(out).all()
    out = quantized_flash_attention(q, k, v, config=dataclasses.replace(base, pv_int8=True))
    assert out.shape == q.shape and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="dense-Q"):
        quantized_flash_attention(q, k, v, config=QuantizationConfig.from_mode_string("int8-qdense"))


# ---- the GPT with cfg.quantization ----

JCFG = jgpt.GPTConfig(vocab=64, dim=128, num_heads=4, num_kv_heads=2, depth=2, max_seq=96,
                      interpret=True)
CFG = gpt.GPTConfig(vocab=64, dim=128, num_heads=4, num_kv_heads=2, depth=2, max_seq=96)


@pytest.fixture(scope="module")
def jparams():
    return jgpt.init_params(jax.random.PRNGKey(0), JCFG)


def _loss(model, tokens):
    logits = model(tokens[:, :-1]).float()
    return -torch.log_softmax(logits, dim=-1).gather(-1, tokens[:, 1:, None]).mean()


def _jloss(params, tokens, cfg):
    logits = jgpt.forward(params, tokens[:, :-1], cfg)
    lp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    return -jnp.mean(jnp.take_along_axis(lp, tokens[:, 1:, None], axis=-1))


def _recipe(name):
    """(JAX config, port config) of a recipe: a mode string, "<precision>-block",
    or "int8-asym" (the int8 recipe, ASYMMETRIC)."""
    if name == "int8-asym":
        return (dataclasses.replace(JQuantizationConfig(), strategy=JQuantStrategy.ASYMMETRIC),
                dataclasses.replace(QuantizationConfig(), strategy=QuantStrategy.ASYMMETRIC))
    prec, _, mode = name.partition("-")
    return (JQuantizationConfig.from_mode_string(prec, mode or "row"),
            QuantizationConfig.from_mode_string(prec, mode or "row"))


@pytest.mark.parametrize("recipe", ["int8", "int4", "int8-block", "int8-asym"])
def test_quantized_gpt_loss_and_every_gradient_match_jax(jparams, recipe):
    jq, tq = _recipe(recipe)
    jcfg = dataclasses.replace(JCFG, quantization=jq)
    cfg = dataclasses.replace(CFG, quantization=tq)
    tokens = np.random.default_rng(21).integers(0, CFG.vocab, (2, 49))
    want_loss, want = jax.value_and_grad(_jloss)(jparams, jnp.asarray(tokens), jcfg)
    model = gpt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    loss = _loss(model, torch.from_numpy(tokens))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-4
    named = {"embed": model.embed, "unembed": model.unembed}
    jflat = {"embed": want["embed"], "unembed": want["unembed"]}
    for i, block in enumerate(model.blocks):
        for name in ("wq", "wkv", "wo", "w1", "w2"):
            named[f"blocks.{i}.{name}"] = getattr(block, name)
            jflat[f"blocks.{i}.{name}"] = want["blocks"][i][name]
    assert len(named) == len(list(model.parameters())) == 2 + 5 * CFG.depth
    for name, param in named.items():
        assert rel_err(param.grad, np.asarray(jflat[name])) <= 1e-2, name
    # One plain SGD step lowers the loss (tests/test_gpt.py:27-41, lr 0.5).
    with torch.no_grad():
        for prm in model.parameters():
            prm -= 0.5 * prm.grad
    assert _loss(model, torch.from_numpy(tokens)).item() < loss.item()
