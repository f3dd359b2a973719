"""Port parity: ring attention forward (`parallel/ring_pallas.py`,
`parallel/ring.py`) against the JAX package's rings.

The same numpy inputs go through JAX's `ring_flash_attention_pallas` (and
`ring_flash_attention`) under `shard_map` on 4 of the 8 virtual CPU
devices, its Pallas kernels in interpret mode as tests/test_parallel.py
runs them, and through the port with `LocalRing(4)` on CPU tensors (the
kernels' plain versions).

Tolerances: fp32 out relerr 2e-5 and LSE max abs 1e-5 (both compute in
full fp32 at the same rounding points; only the summation order differs).
bf16: both round P to bf16 against the same running max and store o in
bf16 after every step, so only a summation-order difference that moves a
value across a bf16 rounding boundary separates them: measured relerr
2.7e-5 to 1.1e-4 and LSE max abs <= 9.6e-7 at these shapes, gated at
relerr 1e-3 and LSE 1e-5. fp16: the port computes it as fp32 (P not
rounded) and casts the output to fp16 once, where the reference rounds P
to fp16 and stores o in fp16 after every step; held at the dense fp16
forward's gates (tests/test_torch_flash_fwd.py), atol/rtol 1e-3 and LSE
1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from umfa_tpu.parallel.ring import merge_partials as jax_merge
from umfa_tpu.parallel.ring import ring_flash_attention as jax_ring_plain
from umfa_tpu.parallel.ring import zigzag_shard as jax_zigzag_shard
from umfa_tpu.parallel.ring_pallas import ring_flash_attention_pallas as jax_ring
from umfa_tpu.parallel.ring_pallas import ring_pallas_selfloop_bwd_check as jax_selfloop_bwd
from umfa_tpu.parallel.ring_pallas import ring_pallas_selfloop_check as jax_selfloop
from umfa_tpu_torch.ops.attention import flash_attention, reference_attention
from umfa_tpu_torch.parallel import (
    LocalRing,
    SelfLoop,
    merge_partials,
    ring_flash_attention,
    ring_flash_attention_pallas,
    zigzag_shard,
    zigzag_unshard,
)
from umfa_tpu_torch.parallel import ring_pallas as rp
from umfa_tpu_torch.utils.testing import rel_err

N_DEV, S, D = 4, 256, 64
SP = P(None, None, "sp", None)
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16, "fp16": jnp.float16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}
GATES = {"fp32": (2e-5, 1e-5), "bf16": (1e-3, 1e-5)}


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _qkv(hq, hkv, seq=S, d=D):
    return _normal(0, 1, hq, seq, d), _normal(1, 1, hkv, seq, d), _normal(2, 1, hkv, seq, d)


def _mesh():
    return Mesh(np.array(jax.devices()[:N_DEV]), ("sp",))


def _jax_ring_pallas(q, k, v, dtype, **kw):
    f = shard_map(
        lambda q, k, v: jax_ring(q, k, v, axis_name="sp", interpret=True, return_lse=True, **kw),
        mesh=_mesh(), in_specs=(SP,) * 3, out_specs=(SP, P(None, None, "sp")), check_vma=False)
    out, lse = jax.jit(f)(*(jnp.asarray(x, JDT[dtype]) for x in (q, k, v)))
    return np.asarray(out.astype(jnp.float32)), np.asarray(lse)


def _t(x, dtype="fp32"):
    return torch.from_numpy(np.asarray(x, np.float32).copy()).to(TDT[dtype])


RING_CASES = [  # (hq, hkv, causal, zigzag, seq)
    (2, 2, True, False, S),
    (2, 2, False, False, S),
    (2, 2, True, True, S),
    (4, 2, True, False, S),
    (2, 2, True, False, 384),  # S_loc 96: block_k 96
    (2, 2, True, True, 384),   # S_loc 96: zigzag halves of 48
]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", RING_CASES, ids=["causal", "noncausal", "zigzag", "gqa",
                                                  "causal_s96", "zigzag_s96"])
def test_ring_pallas_forward_matches_jax(case, dtype):
    hq, hkv, causal, zigzag, seq = case
    q, k, v = _qkv(hq, hkv, seq)
    if zigzag:
        q, k, v = (np.asarray(jax_zigzag_shard(jnp.asarray(x), N_DEV)) for x in (q, k, v))
    want, want_lse = _jax_ring_pallas(q, k, v, dtype, causal=causal, zigzag=zigzag)
    out, lse = ring_flash_attention_pallas(*(_t(x, dtype) for x in (q, k, v)), ring=LocalRing(N_DEV),
                                           causal=causal, zigzag=zigzag, return_lse=True)
    assert out.dtype == TDT[dtype] and lse.dtype == torch.float32
    assert out.shape == q.shape and lse.shape == q.shape[:3]
    rtol, ltol = GATES[dtype]
    assert rel_err(out, want) <= rtol
    assert float((lse - _t(want_lse)).abs().max()) <= ltol


@pytest.mark.parametrize("zigzag", [False, True], ids=["causal", "zigzag"])
def test_ring_pallas_forward_takes_fp16(zigzag):
    q, k, v = _qkv(2, 2)
    if zigzag:
        q, k, v = (np.asarray(jax_zigzag_shard(jnp.asarray(x), N_DEV)) for x in (q, k, v))
    want, want_lse = _jax_ring_pallas(q, k, v, "fp16", causal=True, zigzag=zigzag)
    out, lse = ring_flash_attention_pallas(*(_t(x, "fp16") for x in (q, k, v)),
                                           ring=LocalRing(N_DEV), causal=True, zigzag=zigzag,
                                           return_lse=True)
    assert out.dtype == torch.float16 and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(), want, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-3, rtol=0)


def test_ring_pallas_forward_takes_fp32_head_dim_256():
    # B1 H2, S 128 over 4 ranks (S_loc 32), causal: the head dim the port's
    # fp32 ring kernels take since their 3xTF32 bodies have a D 256 tile.
    q, k, v = _qkv(2, 2, seq=128, d=256)
    want, want_lse = _jax_ring_pallas(q, k, v, "fp32", causal=True)
    out, lse = ring_flash_attention_pallas(*(_t(x) for x in (q, k, v)), ring=LocalRing(N_DEV),
                                           causal=True, return_lse=True)
    rtol, ltol = GATES["fp32"]
    assert rel_err(out, want) <= rtol
    assert float((lse - _t(want_lse)).abs().max()) <= ltol


def test_ring_pallas_forward_matches_unsharded_attention():
    q, k, v = _qkv(4, 2)
    tq, tk, tv = (_t(x) for x in (q, k, v))
    want = reference_attention(tq, tk, tv, causal=True)
    out = ring_flash_attention_pallas(*(zigzag_shard(x, N_DEV) for x in (tq, tk, tv)),
                                      ring=LocalRing(N_DEV), causal=True, zigzag=True)
    assert rel_err(zigzag_unshard(out, N_DEV), want) <= 2e-5


def test_merge_partials_matches_jax():
    rng = np.random.default_rng(5)
    o1, o2 = rng.normal(0, 1, (2, 2, 2, 64, 16)).astype(np.float32)
    lse1, lse2 = rng.normal(0, 3, (2, 2, 2, 64)).astype(np.float32)
    lse1[0, 0, :8] = -1e30  # a side with no key
    lse1[0, 1, :4] = lse2[0, 1, :4] = -1e30  # both sides empty
    for dtype in ("fp32", "bf16"):
        want_o, want_lse = jax_merge(jnp.asarray(o1, JDT[dtype]), jnp.asarray(lse1), jnp.asarray(o2),
                                     jnp.asarray(lse2))
        got_o, got_lse = merge_partials(_t(o1, dtype), _t(lse1), _t(o2), _t(lse2))
        assert got_o.dtype == TDT[dtype]
        np.testing.assert_allclose(got_o.float().numpy(), np.asarray(want_o, np.float32),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), rtol=1e-6, atol=1e-6)


def test_zigzag_roundtrip_and_layout():
    x = _normal(3, 1, 2, 64, 8)
    got = zigzag_shard(_t(x), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_zigzag_shard(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(zigzag_unshard(got, 4).numpy(), x)
    with pytest.raises(ValueError, match="divisible"):
        zigzag_shard(_t(x), 3)


@pytest.mark.parametrize("causal,zigzag", [(True, False), (True, True), (False, False)])
def test_ring_of_flash_calls_matches_jax(causal, zigzag):
    q, k, v = _qkv(4, 2)
    if zigzag:
        q, k, v = (np.asarray(jax_zigzag_shard(jnp.asarray(x), N_DEV)) for x in (q, k, v))
    f = shard_map(
        lambda q, k, v: jax_ring_plain(q, k, v, axis_name="sp", causal=causal, zigzag=zigzag,
                                       interpret=True),
        mesh=_mesh(), in_specs=(SP,) * 3, out_specs=SP, check_vma=False)
    want = np.asarray(jax.jit(f)(q, k, v))
    got = ring_flash_attention(*(_t(x) for x in (q, k, v)), ring=LocalRing(N_DEV), causal=causal,
                               zigzag=zigzag)
    assert rel_err(got, want) <= 2e-5


def test_ring_of_flash_calls_takes_gradients():
    """ring.py is differentiable through flash_attention and ppermute: its
    gradients equal single-device flash_attention's."""
    q, k, v = _qkv(4, 2)
    leaves = [[_t(x).requires_grad_(True) for x in (q, k, v)] for _ in range(2)]
    ring = LocalRing(N_DEV)
    out = ring_flash_attention(*(zigzag_shard(x, N_DEV) for x in leaves[0]), ring=ring,
                               causal=True, zigzag=True)
    (zigzag_unshard(out, N_DEV) ** 2).sum().backward()
    (flash_attention(*leaves[1], causal=True) ** 2).sum().backward()
    for a, b in zip(*leaves):
        assert rel_err(a.grad, b.grad) <= 1e-4
    # 3 forward rotations of K and of V (and their cotangents back), 4 ranks each.
    assert ring.hops["ppermute"] == ring.hops["ppermute_grad"] == 24


def _jax_selfloop_inputs(n, dtype, seq):
    kq, kk, kv = jax.random.split(jax.random.PRNGKey(0), 3)
    shape = (1, 2, seq, 128)
    return [np.asarray(jax.random.normal(key, shape, jnp.float32).astype(dtype), np.float32)
            for key in (kq, kk, kv)][:n]


@pytest.mark.parametrize("n_steps,causal", [(4, True), (3, False)])
def test_selfloop_check_matches_jax(n_steps, causal):
    rel, jax_out, _ = jax_selfloop(seq=512, n_steps=n_steps, causal=causal, dtype=jnp.float32,
                                   interpret=True)
    q, k, v = (_t(x) for x in _jax_selfloop_inputs(3, jnp.float32, 512))
    ring = SelfLoop(n_steps)
    out, _ = rp._ring_fwd(q, k, v, ring, rp._config(512, causal, False, 128**-0.5,
                                                    rp.BlockSizes(1024, 1024)))
    assert rel_err(out, np.asarray(jax_out)) <= 2e-5
    assert ring.hops["fwd_kv"] == n_steps - 1
    got_rel, _, _ = rp.ring_pallas_selfloop_check(seq=512, n_steps=n_steps, causal=causal,
                                                  device="cpu")
    assert rel < 5e-3 and got_rel < 5e-3


def test_selfloop_bwd_check_matches_jax():
    want = jax_selfloop_bwd(seq=512, n_steps=4, causal=True, interpret=True)
    got = rp.ring_pallas_selfloop_bwd_check(seq=512, n_steps=4, causal=True, device="cpu")
    assert want < 2e-2 and got < 2e-2
    assert rp.ring_pallas_selfloop_bwd_check(seq=512, n_steps=3, causal=False, device="cpu") < 2e-2
