"""Port parity: dense flash forward.

The same numpy inputs go through the JAX reference (the Pallas kernel in
interpret mode on the CPU, as the JAX tests run it) and the port's plain
PyTorch version on the CPU.

Tolerances: fp32 out relerr <= FP32 and LSE abs <= 1e-5 (TOL["fp32"]: both
sides compute in full fp32, only the summation order differs). fp16 is
storage-only on both sides (fp32 compute, one final cast): 1e-3. bf16:
both round Q·scale and P to bf16 at the same points; at these sizes the
reference walks one KV tile, so the rounding happens relative to the same
row max and only summation order differs: out relerr <= 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umfa_tpu.ops.attention import reference_attention as jax_reference_attention
from umfa_tpu.ops.flash_fwd import flash_attention_forward as jax_flash_forward
from umfa_tpu_torch.ops.attention import flash_attention, reference_attention
from umfa_tpu_torch.ops.flash_fwd import flash_attention_forward
from umfa_tpu_torch.utils.testing import TOL, rel_err

B, HQ, HKV, D = 2, 4, 2, 64
FP32 = TOL["fp32"]["rtol"]  # 2e-5


def _inputs(seed, sq, sk, heads=(HQ, HKV)):
    rng = np.random.default_rng(seed)
    hq, hkv = heads
    return (rng.normal(0, 1, (B, hq, sq, D)).astype(np.float32),
            rng.normal(0, 1, (B, hkv, sk, D)).astype(np.float32),
            rng.normal(0, 1, (B, hkv, sk, D)).astype(np.float32))


def _decode_bias(sq, sk, length):
    """The serving route's (B, 1, Tq, Sk) length-and-causal bias."""
    pos = np.arange(sk)[None, :]
    qpos = (length - sq + np.arange(sq))[:, None]
    masked = (pos > qpos) | (pos >= length)
    bias = np.where(masked, -1e30, 0.0).astype(np.float32)
    return np.broadcast_to(bias, (B, 1, sq, sk)).copy()


def _bias(kind, sq, sk, seed=7):
    rng = np.random.default_rng(seed)
    if kind is None:
        return None
    if kind == "b11k":
        return rng.normal(0, 1, (B, 1, 1, sk)).astype(np.float32)
    if kind == "1hqk":
        return rng.normal(0, 1, (1, HQ, sq, sk)).astype(np.float32)
    if kind == "decode":
        return _decode_bias(sq, sk, sk - 8)
    if kind == "row_masked":
        # Row 3 masked by bias alone: an average over every key, not a zero.
        bias = rng.normal(0, 1, (B, 1, sq, sk)).astype(np.float32)
        bias[:, :, 3] = -1e30
        return bias
    raise ValueError(kind)


def _both(q, k, v, bias, dtype=np.float32, **kw):
    jdt = {np.float32: jnp.float32, np.float16: jnp.float16, "bf16": jnp.bfloat16}[dtype]
    tdt = {np.float32: torch.float32, np.float16: torch.float16, "bf16": torch.bfloat16}[dtype]
    j_out, j_lse = jax_flash_forward(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        None if bias is None else jnp.asarray(bias), interpret=True, **kw)
    t_out, t_lse = flash_attention_forward(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt),
        None if bias is None else torch.from_numpy(bias), **kw)
    assert t_out.dtype == tdt and t_lse.dtype == torch.float32
    return (np.asarray(j_out, np.float32), np.asarray(j_lse),
            t_out.float().numpy(), t_lse.numpy())


CASES = [
    # id, sq, sk, kwargs, bias kind
    ("causal_sq_ne_sk", 160, 192, dict(causal=True), None),
    ("window_chunk_start", 40, 192, dict(window=(-1, 152)), None),
    ("window_left", 192, 192, dict(window=(48, 0)), None),
    ("window_both_causal", 130, 130, dict(causal=True, window=(20, 5)), None),
    ("bias_b11k", 160, 192, {}, "b11k"),
    ("bias_1hqk_causal", 96, 96, dict(causal=True), "1hqk"),
    ("bias_decode_route", 24, 192, {}, "decode"),
    ("bias_masked_row", 64, 100, {}, "row_masked"),
    ("fully_masked_rows", 224, 160, dict(window=(0, -1)), None),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_forward_fp32_matches_jax(case):
    _, sq, sk, kw, bias_kind = case
    q, k, v = _inputs(0, sq, sk)
    bias = _bias(bias_kind, sq, sk)
    j_out, j_lse, t_out, t_lse = _both(q, k, v, bias, **kw)
    assert rel_err(t_out, j_out) <= FP32
    vis = j_lse > -1e29
    np.testing.assert_allclose(t_lse[vis], j_lse[vis], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(t_lse[~vis], j_lse[~vis])
    if case[0] == "fully_masked_rows":
        assert (~vis).sum() == B * HQ * (sq - sk)
        np.testing.assert_array_equal(t_out[~vis], 0.0)
        np.testing.assert_array_equal(t_lse[~vis], np.float32(-1e30))
    if case[0] == "bias_masked_row":
        # Uniform average over the keys, exactly as the reference.
        want = v.mean(axis=2).repeat(HQ // HKV, axis=1)
        np.testing.assert_allclose(t_out[:, :, 3], want, atol=1e-5)
        np.testing.assert_array_equal(t_lse[:, :, 3], np.float32(-1e30))


def test_flash_forward_gqa_group_1_and_4():
    for heads in ((4, 4), (4, 1)):
        q, k, v = _inputs(1, 72, 72, heads)
        j_out, j_lse, t_out, t_lse = _both(q, k, v, None, causal=True)
        assert rel_err(t_out, j_out) <= FP32
        np.testing.assert_allclose(t_lse, j_lse, atol=1e-5, rtol=0)


def test_flash_forward_fp16_storage_and_bf16():
    q, k, v = _inputs(2, 100, 140)
    j_out, j_lse, t_out, t_lse = _both(q, k, v, None, np.float16, causal=True)
    np.testing.assert_allclose(t_out, j_out, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(t_lse, j_lse, atol=1e-3, rtol=0)
    j_out, j_lse, t_out, t_lse = _both(q, k, v, None, "bf16", causal=True)
    assert rel_err(t_out, j_out) <= 1e-3
    np.testing.assert_allclose(t_lse, j_lse, atol=1e-3, rtol=0)


def test_flash_attention_and_reference_match_jax():
    q, k, v = _inputs(3, 80, 80)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = flash_attention(tq, tk, tv, causal=True, return_lse=True)
    assert flash_attention(tq, tk, tv, causal=True).shape == out.shape
    ref = reference_attention(tq, tk, tv, causal=True)
    want = np.asarray(jax_reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              causal=True))
    assert rel_err(ref, want) <= FP32
    assert rel_err(out, want) <= FP32
    assert lse.shape == (B, HQ, 80)


def test_flash_forward_scale_and_out_dtype():
    q, k, v = _inputs(4, 64, 96)
    j_out, j_lse, t_out, t_lse = _both(q, k, v, None, scale=0.3)
    assert rel_err(t_out, j_out) <= FP32
    np.testing.assert_allclose(t_lse, j_lse, atol=1e-5, rtol=0)
    out, _ = flash_attention_forward(torch.from_numpy(q).bfloat16(), torch.from_numpy(k).bfloat16(),
                                     torch.from_numpy(v).bfloat16(), out_dtype=torch.float32)
    assert out.dtype == torch.float32


def test_flash_forward_refuses_grad():
    # The forward wrapper alone builds no autograd graph: it refuses inputs
    # that require grad under grad mode; flash_attention is differentiable.
    q, k, v = (torch.from_numpy(x) for x in _inputs(5, 16, 16))
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="flash_attention for gradients"):
        flash_attention_forward(q, k, v)
    with torch.no_grad():
        flash_attention_forward(q, k, v)
    out = flash_attention(q, k, v)
    assert out.requires_grad
    out.sum().backward()
    assert q.grad is not None and q.grad.shape == q.shape
