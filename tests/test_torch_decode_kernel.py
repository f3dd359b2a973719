"""Port parity: the flash-decode kernel's host function and the decode route
switch (UMFA_ENABLE_DECODE_KERNEL).

The same numpy inputs go through JAX `quantized_flash_decode(...,
interpret=True)` and the port's `quantized_flash_decode` on CPU tensors
(its plain tile walk). Ragged cache lengths are built with
`append_quantized` in both packages, as tests/test_serving.py:236-245 does.

Tolerances: the plain walk rounds where `_decode_kernel` rounds, so the two
agree to fp32 summation order: relerr <= 1e-5 in fp32 and in bf16
(measured 1.1e-7 to 5.1e-7 at B2 Hq4 Hkv2 S1024 D64 block 512, Tq 1, 4,
16, lengths 700 and 333). A rounding point in the wrong place (the V
scale applied after the cast to bf16, say) lands near 1e-3. Against the
port's own gemv route, which rounds the normalized P·vs instead: relerr
<= 2e-5 in fp32, as tests/test_serving.py:227-257 holds the reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import umfa_tpu.serving.decode_kernel as jdk
from umfa_tpu.serving import decode as jdecode
from umfa_tpu.serving import kv_cache as jkv
from umfa_tpu_torch.serving import decode as tdecode
from umfa_tpu_torch.serving import decode_kernel as tdk
from umfa_tpu_torch.serving import kv_cache as tkv
from umfa_tpu_torch.utils.testing import rel_err

B, FILL, LENGTHS = 2, 700, (700, 333)


def _caches(hkv, s_max, d, seed=0, lengths=LENGTHS):
    """Both packages' INT8 caches holding the same rows, at ragged lengths."""
    rng = np.random.default_rng(seed)
    k = rng.normal(0, 1, (B, hkv, FILL, d)).astype(np.float32)
    v = rng.normal(0, 1, (B, hkv, FILL, d)).astype(np.float32)
    jc = jkv.append_quantized(jkv.init_quantized_cache(B, hkv, s_max, d), jnp.asarray(k),
                              jnp.asarray(v))
    tc = tkv.append_quantized(tkv.init_quantized_cache(B, hkv, s_max, d, device="cpu"),
                              torch.from_numpy(k), torch.from_numpy(v))
    jc.length = jnp.asarray(lengths, jnp.int32)
    tc.length = torch.tensor(lengths, dtype=torch.int32)
    return jc, tc


def _bias(tq, s_max, lengths=LENGTHS):
    """The decode route's (B, 1, Tq, S_max) length-and-causal bias: query t
    sits at position length - Tq + t."""
    pos = np.arange(s_max)[None, None, :]
    ln = np.asarray(lengths)[:, None, None]
    qpos = ln - tq + np.arange(tq)[None, :, None]
    masked = (pos > qpos) | (pos >= ln)
    return np.where(masked, -1e30, 0.0).astype(np.float32)[:, None]


def _q(seed, hq, tq, d):
    return np.random.default_rng(seed).normal(0, 1, (B, hq, tq, d)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tq", [1, 4, 16])
@pytest.mark.parametrize("heads", [(4, 2, 64), (2, 2, 64), (4, 2, 128), (4, 2, 72), (2, 1, 256)],
                         ids=["gqa_d64", "mha_d64", "gqa_d128", "gqa_d72", "gqa_d256"])
def test_plain_flash_decode_matches_jax_interpret(heads, tq, dtype):
    hq, hkv, d = heads
    s_max, block = 1024, 512  # two KV tiles
    jc, tc = _caches(hkv, s_max, d)
    q = _q(1, hq, tq, d)
    bias = _bias(tq, s_max)
    want = np.asarray(jdk.quantized_flash_decode(
        jnp.asarray(q, dtype=dtype), jc.k_values, jc.k_scales, jc.v_values, jc.v_scales,
        jnp.asarray(bias), block_k=block, interpret=True))
    got = tdk.quantized_flash_decode(
        torch.from_numpy(q).to(getattr(torch, dtype)), tc.k_values, tc.k_scales, tc.v_values,
        tc.v_scales, torch.from_numpy(bias), block_k=block)
    assert got.dtype == torch.float32 and got.shape == (B, hq, tq, d)
    assert rel_err(got, want) <= 1e-5
    # The plain twin is the same function.
    again = tdk.quantized_flash_decode_plain(
        torch.from_numpy(q).to(getattr(torch, dtype)), tc.k_values, tc.k_scales, tc.v_values,
        tc.v_scales, torch.from_numpy(bias), block_k=block)
    assert torch.equal(got, again)


# The shapes the card's cluster edges are tested at: MQA at Tq 16 (256
# query rows a kv head), S_max 64 (one tile; on the card most splits of the
# cluster get no cache row), and slots of length 0 beside full ones (every
# column at -1e30: V averaged uniformly). (b, hq, hkv, tq, d, s_max,
# block_k, lengths); the cache is filled to S_max.
EDGE_CASES = {
    "mqa_tq16": (2, 16, 1, 16, 64, 1024, 512, (700, 333)),
    "s64": (2, 4, 2, 4, 64, 64, 64, (64, 17)),
    "empty_among_full": (4, 4, 2, 4, 64, 768, 256, (768, 0, 768, 0)),
}


def _full_caches(b, hkv, s_max, d, lengths, seed):
    rng = np.random.default_rng(seed)
    k = rng.normal(0, 1, (b, hkv, s_max, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, hkv, s_max, d)).astype(np.float32)
    jc = jkv.append_quantized(jkv.init_quantized_cache(b, hkv, s_max, d), jnp.asarray(k),
                              jnp.asarray(v))
    tc = tkv.append_quantized(tkv.init_quantized_cache(b, hkv, s_max, d, device="cpu"),
                              torch.from_numpy(k), torch.from_numpy(v))
    jc.length = jnp.asarray(lengths, jnp.int32)
    tc.length = torch.tensor(lengths, dtype=torch.int32)
    return jc, tc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(EDGE_CASES), ids=list(EDGE_CASES))
def test_plain_flash_decode_cluster_edge_shapes_match_jax(case, dtype):
    b, hq, hkv, tq, d, s_max, block, lengths = EDGE_CASES[case]
    jc, tc = _full_caches(b, hkv, s_max, d, lengths, seed=11)
    q = np.random.default_rng(12).normal(0, 1, (b, hq, tq, d)).astype(np.float32)
    bias = _bias(tq, s_max, lengths)
    want = np.asarray(jdk.quantized_flash_decode(
        jnp.asarray(q, dtype=dtype), jc.k_values, jc.k_scales, jc.v_values, jc.v_scales,
        jnp.asarray(bias), block_k=block, interpret=True))
    got = tdk.quantized_flash_decode(
        torch.from_numpy(q).to(getattr(torch, dtype)), tc.k_values, tc.k_scales, tc.v_values,
        tc.v_scales, torch.from_numpy(bias), block_k=block)
    assert got.shape == (b, hq, tq, d) and torch.isfinite(got).all()
    # fp32: summation order only. bf16: a score whose last fp32 bit differs
    # between the two orders can round p·vs to the neighbouring bf16 (one
    # such flip in the 256 x 1024 scores of mqa_tq16 moves one query row:
    # relerr 1.8e-5, the rest of the cases ~1e-7); 1e-4 admits a few flips,
    # a rounding point in the wrong place lands near 1e-3.
    assert rel_err(got, want) <= (1e-5 if dtype == "float32" else 1e-4)


def test_plain_flash_decode_broadcast_bias_and_empty_slot():
    """A (B, 1, 1, S) bias broadcast over Tq, and a slot of length 0 (every
    column at -1e30), which averages V uniformly in both packages."""
    s_max, lengths = 1024, (0, 333)
    jc, tc = _caches(2, s_max, 64, seed=3, lengths=lengths)
    q = _q(4, 4, 2, 64)
    bias = _bias(1, s_max, lengths)
    want = np.asarray(jdk.quantized_flash_decode(
        jnp.asarray(q), jc.k_values, jc.k_scales, jc.v_values, jc.v_scales, jnp.asarray(bias),
        block_k=256, interpret=True))
    got = tdk.quantized_flash_decode(torch.from_numpy(q), tc.k_values, tc.k_scales,
                                     tc.v_values, tc.v_scales, torch.from_numpy(bias),
                                     block_k=256)
    assert torch.isfinite(got).all() and rel_err(got, want) <= 1e-5
    uniform = (tc.v_values[0].float() * tc.v_scales[0]).mean(dim=1)  # (Hkv, D)
    assert torch.allclose(got[0, :, 0], uniform.repeat_interleave(2, dim=0), atol=1e-5)


def test_flash_decode_refuses_bad_arguments():
    _, tc = _caches(2, 1024, 64)
    q = torch.zeros((B, 4, 1, 64))
    bias = torch.from_numpy(_bias(1, 1024))
    args = (tc.k_values, tc.k_scales, tc.v_values, tc.v_scales)
    with pytest.raises(ValueError, match="multiple of block_k"):
        tdk.quantized_flash_decode(q, *args, bias, block_k=384)
    with pytest.raises(ValueError, match="INT8"):
        tdk.quantized_flash_decode(q, tc.k_values.float(), *args[1:], bias)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tdk.quantized_flash_decode(torch.zeros((B, 3, 1, 64)), *args, bias)
    with pytest.raises(ValueError, match="bias"):
        tdk.quantized_flash_decode(q, *args, bias[..., :512])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tq", [1, 4])
def test_decode_attention_switch_matches_jax_and_gemv(monkeypatch, tq, dtype):
    jc, tc = _caches(2, 1024, 64, seed=5)
    q = _q(6, 4, tq, 64)
    jq, tq_ = jnp.asarray(q, dtype=dtype), torch.from_numpy(q).to(getattr(torch, dtype))
    monkeypatch.setenv("UMFA_ENABLE_DECODE_KERNEL", "1")
    want = np.asarray(jdecode.decode_attention(jq, jc, interpret=True).astype(jnp.float32))
    got = tdecode.decode_attention(tq_, tc)
    assert got.dtype == tq_.dtype
    # bf16: both round the same fp32 result (measured identical here).
    assert rel_err(got, want) <= 1e-5
    monkeypatch.delenv("UMFA_ENABLE_DECODE_KERNEL")
    gemv = tdecode.decode_attention(tq_, tc)
    if dtype == "float32":
        assert rel_err(got, gemv) <= 2e-5


@pytest.mark.parametrize("s_max,block_k", [(4096, 2048), (768, 256), (128, None)])
def test_decode_route_rule_matches_jax(monkeypatch, s_max, block_k):
    """With the switch on, both packages take the kernel with the same
    block_k, or both take the gemv (S_max 128 has no block >= 256)."""
    lengths = (min(FILL, s_max), s_max // 3)
    jc, tc = _caches(2, s_max, 64, seed=7, lengths=lengths) if s_max >= FILL else \
        _small_caches(s_max, lengths)
    calls = {"jax": [], "torch": []}

    def spy(name, fn):
        def wrapped(*args, **kw):
            calls[name].append(kw["block_k"])
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(jdk, "quantized_flash_decode", spy("jax", jdk.quantized_flash_decode))
    monkeypatch.setattr(tdecode, "quantized_flash_decode",
                        spy("torch", tdecode.quantized_flash_decode))
    monkeypatch.setenv("UMFA_ENABLE_DECODE_KERNEL", "1")
    q = _q(8, 4, 1, 64)
    want = np.asarray(jdecode.decode_attention(jnp.asarray(q), jc, interpret=True))
    got = tdecode.decode_attention(torch.from_numpy(q), tc)
    assert calls["jax"] == calls["torch"] == ([] if block_k is None else [block_k])
    assert rel_err(got, want) <= 1e-5


def _small_caches(s_max, lengths):
    rng = np.random.default_rng(9)
    k = rng.normal(0, 1, (B, 2, s_max, 64)).astype(np.float32)
    v = rng.normal(0, 1, (B, 2, s_max, 64)).astype(np.float32)
    jc = jkv.append_quantized(jkv.init_quantized_cache(B, 2, s_max, 64), jnp.asarray(k),
                              jnp.asarray(v))
    tc = tkv.append_quantized(tkv.init_quantized_cache(B, 2, s_max, 64, device="cpu"),
                              torch.from_numpy(k), torch.from_numpy(v))
    jc.length = jnp.asarray(lengths, jnp.int32)
    tc.length = torch.tensor(lengths, dtype=torch.int32)
    return jc, tc
