"""Port parity: gradients of the ring (`parallel/ring_pallas.py`) against
JAX's jitted `jax.grad` of its `ring_flash_attention_pallas` under
`shard_map` on 4 virtual CPU devices (interpret mode), with a loss that
puts cotangents on both out and LSE; the port's two backward routes
against each other; and the launch and hop counts of the ring's plain path.

Tolerances: fp32 relerr 1e-4, the backward bound of
tests/test_flash_backward.py:32 (full fp32 on both sides, only the
summation order differs); the two backward routes within 2e-5, as
tests/test_parallel.py:386-418 holds JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from umfa_tpu.parallel.ring_pallas import ring_flash_attention_pallas as jax_ring
from umfa_tpu_torch.parallel import LocalRing, ring_flash_attention_pallas
from umfa_tpu_torch.parallel import ring_pallas as rp
from umfa_tpu_torch.utils.testing import rel_err

N_DEV, S, D = 4, 256, 64
SP = P(None, None, "sp", None)


def _inputs(hq, hkv):
    rng = np.random.default_rng(0)
    q = rng.normal(0, 1, (1, hq, S, D)).astype(np.float32)
    k = rng.normal(0, 1, (1, hkv, S, D)).astype(np.float32)
    v = rng.normal(0, 1, (1, hkv, S, D)).astype(np.float32)
    w = rng.normal(0, 1, (1, hq, S)).astype(np.float32)  # the LSE cotangent
    return q, k, v, w


def _torch_grads(q, k, v, w, ring, **kw):
    leaves = [torch.from_numpy(x.copy()).requires_grad_(True) for x in (q, k, v)]
    out, lse = ring_flash_attention_pallas(*leaves, ring=ring, return_lse=True, **kw)
    (torch.sum(out * torch.cos(out)) + torch.sum(lse * torch.from_numpy(w))).backward()
    return [x.grad for x in leaves]


@pytest.mark.parametrize("hq,hkv,zigzag", [(4, 2, False), (2, 2, True)], ids=["gqa", "zigzag"])
def test_ring_grads_match_jax(hq, hkv, zigzag):
    q, k, v, w = _inputs(hq, hkv)
    f = shard_map(
        lambda q, k, v: jax_ring(q, k, v, axis_name="sp", causal=True, zigzag=zigzag,
                                 interpret=True, return_lse=True),
        mesh=Mesh(np.array(jax.devices()[:N_DEV]), ("sp",)),
        in_specs=(SP,) * 3, out_specs=(SP, P(None, None, "sp")), check_vma=False)

    def loss(q, k, v):
        out, lse = f(q, k, v)
        return jnp.sum(out * jnp.cos(out)) + jnp.sum(lse * w)

    # jit as the reference's tests require for collective kernels.
    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    got = _torch_grads(q, k, v, w, LocalRing(N_DEV), causal=True, zigzag=zigzag)
    for name, a, b in zip("qkv", got, want):
        assert rel_err(a, np.asarray(b)) <= 1e-4, f"d{name}"


@pytest.mark.parametrize("zigzag", [False, True])
def test_backward_routes_agree(monkeypatch, zigzag):
    q, k, v, w = _inputs(4, 2)
    ring = LocalRing(N_DEV)
    got = _torch_grads(q, k, v, w, ring, causal=True, zigzag=zigzag)
    monkeypatch.setenv("UMFA_RING_BWD", "jnp")
    dense_ring = LocalRing(N_DEV)
    want = _torch_grads(q, k, v, w, dense_ring, causal=True, zigzag=zigzag)
    assert ring.hops["bwd_dkv"] == 12 and ring.hops["dense_kv"] == 0
    assert dense_ring.hops["dense_kv"] == 16 and dense_ring.hops["bwd_dkv"] == 0
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=2e-5)


def _count(monkeypatch, name, counts):
    fn = getattr(rp, name)

    def counted(*args):
        counts[name] += 1
        return fn(*args)

    monkeypatch.setattr(rp, name, counted)


# (causal, zigzag) -> launches of each kernel, forward hops, per the
# reference's skip rules: contiguous causal computes n(n+1)/2 steps and sends
# n(n-1)/2 chunks; every other layout computes n^2 and sends n(n-1).
COUNTS = {(True, False): (10, 6), (True, True): (16, 12), (False, False): (16, 12)}


@pytest.mark.parametrize("causal,zigzag", list(COUNTS))
def test_plain_path_launches_and_hops(monkeypatch, causal, zigzag):
    counts = {}
    for name in ("_fwd_step_plain", "_dkv_plain", "_dq_plain"):
        counts[name] = 0
        _count(monkeypatch, name, counts)
    q, k, v, w = _inputs(4, 2)
    ring = LocalRing(N_DEV)
    _torch_grads(q, k, v, w, ring, causal=causal, zigzag=zigzag)
    launches, fwd_hops = COUNTS[(causal, zigzag)]
    assert counts == {"_fwd_step_plain": launches, "_dkv_plain": launches,
                      "_dq_plain": launches}
    # The backward sends K/V and dK/dV on every step below n - 1 (dK/dV
    # must ride home), then one homing hop per rank.
    assert dict(ring.hops) == {"fwd_kv": fwd_hops, "bwd_kv": 12, "bwd_dkv": 12, "bwd_home": 4}


def test_ring_refuses_misaligned_tiles():
    q = torch.zeros((1, 2, 4 * 96, 64))
    with pytest.raises(ValueError, match="divisible by the tile sizes"):
        ring_flash_attention_pallas(q, q, q, ring=LocalRing(4),
                                    block_sizes=rp.BlockSizes(block_q=64, block_k=64))
    with pytest.raises(ValueError, match="not divisible by 4 ranks"):
        ring_flash_attention_pallas(q[:, :, :382], q[:, :, :382], q[:, :, :382],
                                    ring=LocalRing(4))
