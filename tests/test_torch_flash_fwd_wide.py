"""Port parity: the dense flash forward at head dims 128 and 256.

The same numpy inputs go through the JAX reference (the Pallas kernel in
interpret mode on the CPU, at its default tiles) and the port's plain
PyTorch version on the CPU. At these sizes (S <= 256) the reference walks
one KV tile, so both round P against the same row max.

Row sum: the reference appends a ones column to V only at D < 128; at
D >= 128 its row sum l adds the fp32 P while P·V takes the bf16-rounded P
(umfa_tpu/ops/flash_fwd.py:499, :523). With large scores (q ~ N(0, 3))
summing the rounded P instead moves out by ~1e-3 and the LSE by ~1e-3;
summing what the reference sums leaves only the summation order: out
relerr <= 1e-4, LSE abs <= 1e-5.

D 256: fp32 out relerr <= 2e-5 (TOL["fp32"]) and LSE abs <= 1e-5; bf16
out relerr <= 1e-3 and LSE abs <= 1e-3, the gates of
tests/test_torch_flash_fwd.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umfa_tpu.ops.flash_fwd import flash_attention_forward as jax_flash_forward
from umfa_tpu_torch.ops.flash_fwd import flash_attention_forward
from umfa_tpu_torch.utils.testing import TOL, rel_err

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, b, hq, hkv, s, d, q_std=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, q_std, (b, hq, s, d)).astype(np.float32),
            rng.normal(0, 1, (b, hkv, s, d)).astype(np.float32),
            rng.normal(0, 1, (b, hkv, s, d)).astype(np.float32))


def _both(q, k, v, dtype, **kw):
    jdt, tdt = DTYPES[dtype]
    j_out, j_lse = jax_flash_forward(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                     jnp.asarray(v, jdt), interpret=True, **kw)
    t_out, t_lse = flash_attention_forward(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                                           **kw)
    assert t_out.dtype == tdt and t_lse.dtype == torch.float32
    return (np.asarray(j_out, np.float32), np.asarray(j_lse),
            t_out.float().numpy(), t_lse.numpy())


def test_flash_forward_d128_bf16_row_sum_adds_the_fp32_p():
    q, k, v = _inputs(0, 1, 2, 2, 256, 128, q_std=3.0)
    j_out, j_lse, t_out, t_lse = _both(q, k, v, "bf16", causal=True)
    assert rel_err(t_out, j_out) <= 1e-4
    np.testing.assert_allclose(t_lse, j_lse, atol=1e-5, rtol=0)


D256_CASES = {"causal": dict(causal=True), "window": dict(window=(40, 8))}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("mask", sorted(D256_CASES))
def test_flash_forward_d256_matches_jax(dtype, mask):
    q, k, v = _inputs(1, 1, 4, 2, 192, 256)  # GQA group 2
    j_out, j_lse, t_out, t_lse = _both(q, k, v, dtype, **D256_CASES[mask])
    rtol, ltol = (TOL["fp32"]["rtol"], 1e-5) if dtype == "fp32" else (1e-3, 1e-3)
    assert rel_err(t_out, j_out) <= rtol
    np.testing.assert_allclose(t_lse, j_lse, atol=ltol, rtol=0)
