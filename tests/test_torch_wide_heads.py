"""Port parity at head dims above 256 (rows 1-4 of the kernel table).

On the card the dense forward, dQ, dK/dV and dbias take any head dim (the
wide bodies of `csrc/wide_tc.cuh` above 256; tests/test_torch_kernels_cuda.py
holds them to their plain versions). Here
the same numpy inputs go through the JAX package (its Pallas kernels in
interpret mode on the CPU) and the port's plain versions on the CPU.

Tolerances, those of tests/test_torch_flash_fwd_wide.py: at S <= 256 the
reference walks one KV tile, so both sides round P against the same row
max and only the summation order differs. Forward fp32 out relerr 2e-5
(TOL["fp32"]) and LSE abs 1e-5; bf16 out relerr 1e-3 and LSE abs 1e-3.
Gradients and the bias gradient in fp32: atol = rtol = 1e-4
(tests/test_torch_flash_bwd.py). The SDPA override: fp32 2e-5
(tests/test_torch_interop.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import umfa_tpu
import umfa_tpu_torch
from umfa_tpu.ops.flash_bwd import flash_attention_bias_grad as jax_bias_grad
from umfa_tpu.ops.flash_fwd import flash_attention_forward as jax_flash_forward
from umfa_tpu_torch.ops.flash_bwd import flash_attention_bias_grad
from umfa_tpu_torch.ops.flash_fwd import (
    WIDE_D,
    flash_attention_forward,
    refuse_wide,
)
from umfa_tpu_torch.utils import interop
from umfa_tpu_torch.utils.testing import TOL, rel_err

FP32 = dict(atol=1e-4, rtol=1e-4)
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _normal(seed, *shape, std=1.0):
    return np.random.default_rng(seed).normal(0, std, shape).astype(np.float32)


def _qkv(seed, b, hq, hkv, sq, sk, d):
    return (_normal(seed, b, hq, sq, d), _normal(seed + 1, b, hkv, sk, d),
            _normal(seed + 2, b, hkv, sk, d))


FWD_CASES = {
    # name: (b, hq, hkv, sq, sk, d, kwargs, bias shape)
    "d264_causal": (1, 2, 2, 128, 128, 264, dict(causal=True), None),
    "d300_gqa_kv_tail": (1, 4, 2, 96, 160, 300, dict(causal=True), None),
    "d320_window_bias": (1, 2, 1, 64, 128, 320, dict(window=(20, 8)), (1, 2, 64, 128)),
    "d512_bias_bqk": (2, 2, 2, 96, 96, 512, {}, (2, 96, 96)),  # 3-D: (B, Sq, Sk)
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(FWD_CASES))
def test_forward_matches_jax(name, dtype):
    b, hq, hkv, sq, sk, d, kw, bias_shape = FWD_CASES[name]
    q, k, v = _qkv(0, b, hq, hkv, sq, sk, d)
    bias = None if bias_shape is None else _normal(9, *bias_shape)
    jdt, tdt = DTYPES[dtype]
    j_out, j_lse = jax_flash_forward(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                     None if bias is None else jnp.asarray(bias),
                                     interpret=True, **kw)
    t_out, t_lse = flash_attention_forward(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                                           None if bias is None else torch.from_numpy(bias), **kw)
    assert t_out.dtype == tdt and t_out.shape == q.shape
    rtol, ltol = (TOL["fp32"]["rtol"], 1e-5) if dtype == "fp32" else (1e-3, 1e-3)
    assert rel_err(t_out.float().numpy(), np.asarray(j_out, np.float32)) <= rtol
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), atol=ltol, rtol=0)


GRAD_CASES = {
    # name: (hq, hkv, sq, sk, d, kwargs)
    "d320_causal_gqa": (4, 2, 96, 96, 320, dict(is_causal=True)),
    "d512_sq_ne_sk": (2, 2, 64, 100, 512, {}),
}


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_attention_grads_match_jax_grad(name):
    hq, hkv, sq, sk, d, kw = GRAD_CASES[name]
    q, k, v = _qkv(3, 1, hq, hkv, sq, sk, d)
    w = _normal(6, 1, hq, sq, d)

    def jloss(q, k, v):
        return jnp.sum(umfa_tpu.attention(q, k, v, interpret=True, **kw) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    (umfa_tpu_torch.attention(*t, **kw) * torch.from_numpy(w)).sum().backward()
    for wg, tg, n in zip(want, t, ("dq", "dk", "dv")):
        np.testing.assert_allclose(tg.grad.numpy(), np.asarray(wg), err_msg=n, **FP32)


@pytest.mark.parametrize("kind", ["11qk", "bhqk"])
def test_bias_grad_matches_jax(kind):
    b, hq, hkv, sq, sk, d = 1, 2, 1, 80, 104, 320
    q, k, v = _qkv(0, b, hq, hkv, sq, sk, d)
    bias = _normal(7, *{"11qk": (1, 1, sq, sk), "bhqk": (b, hq, sq, sk)}[kind])
    jq, jk, jv, jb = (jnp.asarray(x) for x in (q, k, v, bias))
    j_out, j_lse = jax_flash_forward(jq, jk, jv, jb, causal=True, interpret=True)
    do = jnp.asarray(_normal(3, b, hq, sq, d))
    want = np.asarray(jax_bias_grad(jq, jk, jv, j_out, j_lse, do, jb, causal=True,
                                    interpret=True))
    got = flash_attention_bias_grad(
        *(torch.from_numpy(np.array(x, np.float32)) for x in (jq, jk, jv, j_out, j_lse, do)),
        torch.from_numpy(bias), causal=True)
    assert got.shape == bias.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **FP32)


def test_sdpa_override_matches_jax_attention():
    # The FLUX VAE mid-block's call (one head of 512 channels, non-causal),
    # cut to S 256.
    q, k, v = _qkv(11, 1, 1, 1, 256, 256, 512)
    want = umfa_tpu.attention(*(jnp.asarray(x) for x in (q, k, v)), interpret=True)
    with interop.use_torch_sdpa():
        got = F.scaled_dot_product_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_refusals_start_above_256():
    # Every kernel but rows 1-4 takes head_dim <= WIDE_D and refuses wider
    # heads before any launch, naming ROADMAP.md fault 2.
    refuse_wide("the quant_attn_fwd kernel", WIDE_D)  # takes it
    with pytest.raises(ValueError, match=r"head_dim <= 256, got 257 \(ROADMAP\.md fault 2"):
        refuse_wide("the quant_attn_fwd kernel", 257)
