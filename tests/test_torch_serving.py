"""Port parity: KV caches and decode attention.

The same numpy inputs go through the JAX serving layer (kernels in
interpret mode on the CPU) and the port's on the CPU.

Tolerances: cache contents equal (dense rows are copies; int8 values
bit-identical, scales rtol 1e-6). decode_attention, dense fp32: relerr
<= 2e-5 (TOL["fp32"]); INT8 cache through the quantized kernel: relerr
<= 1e-4 (see test_torch_quant_attention.py); the small-Tq gemv route is
plain fp32 matmuls on both sides: relerr <= 2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umfa_tpu.serving import decode as jdecode
from umfa_tpu.serving import kv_cache as jkv
from umfa_tpu_torch.serving import decode as tdecode
from umfa_tpu_torch.serving import kv_cache as tkv
from umfa_tpu_torch.utils.testing import rel_err

B, HQ, HKV, D, S_MAX = 2, 4, 2, 64, 128


def _rows(seed, t, b=B):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, HKV, t, D)).astype(np.float32),
            rng.normal(0, 1, (b, HKV, t, D)).astype(np.float32))


def _caches(kind, s_max=S_MAX):
    if kind == "int8":
        return (jkv.init_quantized_cache(B, HKV, s_max, D),
                tkv.init_quantized_cache(B, HKV, s_max, D, device="cpu"))
    return (jkv.init_cache(B, HKV, s_max, D, jnp.float32),
            tkv.init_cache(B, HKV, s_max, D, torch.float32, device="cpu"))


def _append(kind, jc, tc, k, v, pos):
    if kind == "int8":
        jc = jkv.append_quantized(jc, jnp.asarray(k), jnp.asarray(v), pos=pos)
        tc = tkv.append_quantized(tc, torch.from_numpy(k), torch.from_numpy(v), pos=pos)
    else:
        jc = jkv.append(jc, jnp.asarray(k), jnp.asarray(v), pos=pos)
        tc = tkv.append(tc, torch.from_numpy(k), torch.from_numpy(v), pos=pos)
    return jc, tc


def _assert_same_cache(jc, tc):
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    if isinstance(tc, tkv.QuantizedKVCache):
        for name in ("k_values", "v_values"):
            np.testing.assert_array_equal(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)))
        for name in ("k_scales", "v_scales"):
            np.testing.assert_allclose(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)),
                                       rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
        np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))


@pytest.mark.parametrize("kind", ["dtype", "int8"])
def test_append_uniform_ragged_and_clamped_match_jax(kind):
    jc, tc = _caches(kind, s_max=64)
    k, v = _rows(0, 20)
    jc, tc = _append(kind, jc, tc, k, v, pos=0)         # uniform, in place
    _assert_same_cache(jc, tc)
    jc.length = jc.length.at[1].set(11)                   # ragged lengths
    tc.length[1] = 11
    k, v = _rows(1, 6)
    jc, tc = _append(kind, jc, tc, k, v, pos=None)
    _assert_same_cache(jc, tc)
    k, v = _rows(2, 8)                                    # 60 + 8 > 64: row 0 clamped
    jc.length = jnp.asarray([60, 26], jnp.int32)
    tc.length = torch.tensor([60, 26], dtype=torch.int32)
    jc, tc = _append(kind, jc, tc, k, v, pos=None)
    _assert_same_cache(jc, tc)
    jc, tc = _append(kind, jc, tc, k, v, pos=62)          # uniform start clamped
    _assert_same_cache(jc, tc)


def test_append_debug_poison_on_broken_uniform_promise(monkeypatch):
    monkeypatch.setenv("UMFA_DEBUG", "1")
    for kind in ("dtype", "int8"):
        jc, tc = _caches(kind)
        jc.length = jnp.asarray([4, 9], jnp.int32)
        tc.length = torch.tensor([4, 9], dtype=torch.int32)
        k, v = _rows(3, 2)
        jc, tc = _append(kind, jc, tc, k, v, pos=4)
        buf = tc.k if kind == "dtype" else tc.k_scales
        jbuf = jc.k if kind == "dtype" else jc.k_scales
        assert torch.isnan(buf[:, :, 4:6]).all() and np.isnan(np.asarray(jbuf)[:, :, 4:6]).all()


def _filled(kind, seed, n):
    """Caches holding n tokens (+ the full-sequence k, v)."""
    jc, tc = _caches(kind)
    k, v = _rows(seed, n)
    jc, tc = _append(kind, jc, tc, k, v, pos=0)
    return jc, tc, k, v


def _q(seed, t):
    return np.random.default_rng(seed).normal(0, 1, (B, HQ, t, D)).astype(np.float32)


ROUTES = [
    # id, filled tokens, Tq, kwargs
    ("prefill", 40, 40, dict(prefill=True)),
    ("chunk_start", 56, 16, dict(chunk_start=40)),
    ("generic_bias_tq24", 64, 24, {}),
    ("gemv_tq1", 47, 1, {}),
    ("gemv_tq4", 52, 4, {}),
]


@pytest.mark.parametrize("kind", ["dtype", "int8"])
@pytest.mark.parametrize("route", ROUTES, ids=[r[0] for r in ROUTES])
def test_decode_attention_routes_match_jax(kind, route):
    _, n, tq, kw = route
    jc, tc, _, _ = _filled(kind, 10, n)
    q = _q(11, tq)
    want = np.asarray(jdecode.decode_attention(jnp.asarray(q), jc, interpret=True, **kw))
    got = tdecode.decode_attention(torch.from_numpy(q), tc, **kw)
    assert got.dtype == torch.float32 and got.shape == (B, HQ, tq, D)
    tol = 1e-4 if (kind == "int8" and tq > 16) else 2e-5
    assert rel_err(got, want) <= tol


def test_decode_ragged_lengths_match_jax():
    for kind in ("dtype", "int8"):
        jc, tc, _, _ = _filled(kind, 12, 48)
        jc.length = jnp.asarray([48, 30], jnp.int32)
        tc.length = torch.tensor([48, 30], dtype=torch.int32)
        for tq in (1, 20):
            q = _q(13, tq)
            want = np.asarray(jdecode.decode_attention(jnp.asarray(q), jc, interpret=True))
            got = tdecode.decode_attention(torch.from_numpy(q), tc)
            assert rel_err(got, want) <= (1e-4 if kind == "int8" and tq > 16 else 2e-5)


def test_decode_bias_budget_chunking_matches_jax(monkeypatch):
    """Above the bias budget the generic route chunks Tq (one-time warning)
    and still equals the reference, for both cache kinds."""
    # The (B, 1, 40, S_MAX) f32 bias is 40960 bytes: over budget, chunks of 20.
    for mod in (jdecode, tdecode):
        monkeypatch.setattr(mod, "_BIAS_BUDGET_BYTES", 20480)
    for kind in ("dtype", "int8"):
        for mod in (jdecode, tdecode):
            monkeypatch.setattr(mod, "_warned_bias_cliff", False)
        jc, tc, _, _ = _filled(kind, 14, 64)
        q = _q(15, 40)
        with pytest.warns(UserWarning, match="intra-chunk bias"):
            want = np.asarray(jdecode.decode_attention(jnp.asarray(q), jc, interpret=True))
        with pytest.warns(UserWarning, match="intra-chunk bias"):
            got = tdecode.decode_attention(torch.from_numpy(q), tc)
        assert rel_err(got, want) <= (1e-4 if kind == "int8" else 2e-5)
