"""Port parity: the mesh layer (parallel/mesh.py, sharded.py, pipeline.py)
and the MoE's ep route against the JAX package on its 8 virtual CPU
devices (tests/conftest.py), Pallas kernels in interpret mode.

The port's mesh is eight virtual ranks on the CPU (`devices=["cpu"] * 8`);
inputs are the global tensors, made with numpy from a seed, as
tests/test_parallel.py makes them for the reference.

Tolerances: the heads/batch route (the same fp32 flash calls on the same
shards) TOL["fp32"] (2e-5); the ring, its zigzag layout and its gradients
atol = rtol = 1e-4 (the reference's own, tests/test_parallel.py:41, :63;
the online-softmax merge sums in another order); int8 on the heads route
and the quantized ring: the reference's bounds against fp32 attention
(INT8_REL_ERR; ring 0.03 and at most 1.5× the single call's error + 5e-3)
and out relerr 1e-3 against JAX's (tests/test_torch_quant_fused.py: the same
operands rounded at the same points, fp32 score sums in another order);
the pipeline 1e-5 (outputs) and 1e-4 (gradients), the reference's
(tests/test_parallel.py:331, :365); the MoE ep route 1e-4, aux rtol 1e-5
(tests/test_moe.py:147-150).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from umfa_tpu.engine.config import QuantizationConfig as JQuantizationConfig
from umfa_tpu.models import moe as jmoe
from umfa_tpu.ops.attention import reference_attention
from umfa_tpu.parallel import make_mesh as jmake_mesh
from umfa_tpu.parallel import pipeline_apply as jpipeline_apply
from umfa_tpu.parallel import sharded_attention as jsharded_attention
from umfa_tpu.utils.testing import INT8_REL_ERR, TOL
from umfa_tpu_torch.engine.config import QuantizationConfig
from umfa_tpu_torch.models import moe
from umfa_tpu_torch.parallel import (Mesh, current_mesh, make_mesh, pipeline_apply,
                                     sharded_attention)
from umfa_tpu_torch.utils.testing import rel_err

CPU8 = [torch.device("cpu")] * 8
RING = dict(atol=1e-4, rtol=1e-4)


def _qkv(seed, b, hq, s, d, hkv=None):
    rng = np.random.default_rng(seed)
    hkv = hkv or hq
    return (rng.normal(0, 1, (b, hq, s, d)).astype(np.float32),
            rng.normal(0, 1, (b, hkv, s, d)).astype(np.float32),
            rng.normal(0, 1, (b, hkv, s, d)).astype(np.float32))


def _t(*xs, grad=False):
    return [torch.from_numpy(x).requires_grad_(grad) for x in xs]


# ---------------- make_mesh ----------------

@pytest.mark.parametrize("sizes", [(2, 1, -1), (1, 4, 2), (-1, 2, 2), (1, 1, 1), (8, 1, 1)])
def test_make_mesh_sizes_follow_the_reference(sizes):
    want = jmake_mesh(*sizes)
    mesh = make_mesh(*sizes, devices=CPU8)
    assert mesh.devices.shape == want.devices.shape
    assert mesh.axis_names == want.axis_names == ("dp", "sp", "tp")
    assert dict(mesh.shape) == dict(want.shape)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)


def test_make_mesh_errors(monkeypatch):
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        jmake_mesh(dp=4, tp=4)
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        make_mesh(dp=4, tp=4, devices=CPU8)
    with pytest.raises(ValueError, match="ROADMAP.md"):
        Mesh(np.array([torch.device("cpu"), torch.device("cuda", 0)], dtype=object), ("x",))
    with pytest.raises(ValueError, match="axis names"):
        Mesh(np.array(CPU8[:4], dtype=object).reshape(2, 2), ("x",))
    # devices=None means the visible CUDA devices: one card cannot hold dp=2.
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"needs {n + 1} devices, have {n}"):
        make_mesh(dp=n + 1)
    # A mesh of processes over torch.distributed waits for a multi-card machine.
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    with pytest.raises(ValueError, match="ROADMAP.md"):
        make_mesh(sp=4)


def test_mesh_is_built_like_jaxs_and_is_a_context():
    devs = jax.devices()[:4]
    jm = JMesh(np.array(devs), ("pp",))
    mesh = Mesh(np.array(CPU8[:4]), ("pp",))
    assert dict(mesh.shape) == dict(jm.shape) == {"pp": 4}
    assert current_mesh() is None
    with mesh:
        assert current_mesh() is mesh
        inner = make_mesh(dp=2, devices=CPU8)
        with inner:
            assert current_mesh() is inner
        assert current_mesh() is mesh
    assert current_mesh() is None
    assert mesh.axis_size(None) == 1
    with pytest.raises(ValueError, match="'tp'"):
        mesh.axis_size("tp")


# ---------------- sharded_attention ----------------

@pytest.mark.parametrize("hkv", [8, 4])
def test_heads_and_batch_sharded(hkv):
    # tests/test_parallel.py:23-29's shapes; with hkv 4 each tp rank holds 2
    # q heads over its one kv head.
    q, k, v = _qkv(0, 2, 8, 128, 64, hkv)
    want = jsharded_attention(jmake_mesh(dp=2, sp=1, tp=4), causal=True, interpret=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    got = sharded_attention(make_mesh(dp=2, sp=1, tp=4, devices=CPU8), causal=True)(*_t(q, k, v))
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["fp32"])
    np.testing.assert_allclose(got.numpy(), np.asarray(reference_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=True)), **TOL["fp32"])


@pytest.mark.parametrize("causal,zigzag", [(False, False), (True, False), (True, True)])
def test_ring_matches_jax(causal, zigzag):
    q, k, v = _qkv(1, 1, 2, 512, 64)
    kw = dict(seq_axis="sp", causal=causal, zigzag=zigzag)
    want = jsharded_attention(jmake_mesh(dp=1, sp=4, tp=2), interpret=True, **kw)(
        *(jnp.asarray(a) for a in (q, k, v)))
    got = sharded_attention(make_mesh(dp=1, sp=4, tp=2, devices=CPU8), **kw)(*_t(q, k, v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RING)


@pytest.mark.parametrize("zigzag", [False, True])
def test_ring_gradients_match_jax(zigzag):
    q, k, v = _qkv(2, 1, 2, 256, 64)
    kw = dict(seq_axis="sp", causal=True, zigzag=zigzag)
    jattn = jsharded_attention(jmake_mesh(dp=1, sp=4, tp=1), interpret=True, **kw)
    want = jax.grad(lambda *a: jnp.sum(jattn(*a) ** 2), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = _t(q, k, v, grad=True)
    out = sharded_attention(make_mesh(dp=1, sp=4, tp=1, devices=CPU8), **kw)(tq, tk, tv)
    (out**2).sum().backward()
    for name, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), err_msg=f"d{name}", **RING)


def test_zigzag_needs_a_ring():
    with pytest.raises(ValueError, match="zigzag"):
        sharded_attention(make_mesh(tp=8, devices=CPU8), zigzag=True)
    attn = sharded_attention(make_mesh(dp=2, tp=4, devices=CPU8))
    with pytest.raises(ValueError, match="divide"):
        attn(*_t(*_qkv(3, 2, 8, 64, 32, hkv=2)))


def test_int8_heads_route():
    # tests/test_parallel.py:68-79: each tp rank quantizes its own head.
    q, k, v = _qkv(4, 1, 8, 128, 64)
    jq = (jnp.asarray(a) for a in (q, k, v))
    want = np.asarray(jsharded_attention(jmake_mesh(dp=1, sp=1, tp=8),
                                         quantization=JQuantizationConfig(), interpret=True)(*jq))
    got = sharded_attention(make_mesh(dp=1, sp=1, tp=8, devices=CPU8),
                            quantization=QuantizationConfig())(*_t(q, k, v))
    exact = np.asarray(reference_attention(*(jnp.asarray(a) for a in (q, k, v))))
    assert rel_err(got, exact) < INT8_REL_ERR
    assert rel_err(got, want) <= 1e-3


def _structured(seed, b, h, s, d):
    """tests/test_parallel.py:268-279: four channels ×8 in Q and K, scaled to
    a score std of 0.5."""
    sr = np.random.default_rng(seed)
    qn = sr.normal(0, 1, (b, h, s, d))
    kn = sr.normal(0, 1, (b, h, s, d))
    ch = sr.choice(d, 4, replace=False)
    qn[..., ch] *= 8.0
    kn[..., ch] *= 8.0
    s_ = np.einsum("bhqd,bhkd->bhqk", qn, kn) / np.sqrt(d)
    f = np.sqrt(0.5 / s_.std())
    return ((qn * f).astype(np.float32), (kn * f).astype(np.float32),
            sr.normal(0, 1, (b, h, s, d)).astype(np.float32))


def test_quantized_ring_accuracy_and_parity():
    from umfa_tpu_torch.ops.quant_attention import quantized_flash_attention

    q, k, v = _structured(3, 1, 2, 512, 64)
    exact = np.asarray(reference_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=True))
    kw = dict(seq_axis="sp", causal=True)
    want = jsharded_attention(jmake_mesh(dp=1, sp=4, tp=2), quantization=JQuantizationConfig(),
                              interpret=True, **kw)(*(jnp.asarray(a) for a in (q, k, v)))
    got = sharded_attention(make_mesh(dp=1, sp=4, tp=2, devices=CPU8),
                            quantization=QuantizationConfig(), **kw)(*_t(q, k, v))
    err_single = rel_err(quantized_flash_attention(*_t(q, k, v), config=QuantizationConfig(),
                                                   causal=True), exact)
    err_ring = rel_err(got, exact)
    assert err_ring < 0.03, err_ring
    assert err_ring <= err_single * 1.5 + 5e-3, (err_ring, err_single)
    assert rel_err(got, want) <= 1e-3


# ---------------- pipeline_apply ----------------

def _jstacked(seed, stages, dim):
    keys = jax.random.split(jax.random.PRNGKey(seed), 2)
    return {"w": jax.random.normal(keys[0], (stages, dim, dim), jnp.float32) * dim**-0.5,
            "b": jax.random.normal(keys[1], (stages, dim), jnp.float32) * 0.1}


def _jstage(p, x):
    return jnp.tanh(x @ p["w"]) + p["b"]


def _stage(p, x):
    return torch.tanh(x @ p["w"]) + p["b"]


def _port_params(jp, grad=False):
    return {n: torch.from_numpy(np.array(a)).requires_grad_(grad) for n, a in jp.items()}


@pytest.mark.parametrize("pp,micro", [(4, 8), (8, 8), (2, 2)])
def test_pipeline_matches_jax(pp, micro):
    dim, batch = 16, 16
    jp = _jstacked(0, pp, dim)
    x = np.random.default_rng(5).normal(0, 1, (batch, dim)).astype(np.float32)
    want = jpipeline_apply(_jstage, jp, jnp.asarray(x), mesh=JMesh(np.array(jax.devices()[:pp]),
                                                                   ("pp",)),
                           axis="pp", num_microbatches=micro)
    calls = []

    def stage(p, xx):
        calls.append(1)
        return _stage(p, xx)

    got = pipeline_apply(stage, _port_params(jp), torch.from_numpy(x),
                         mesh=Mesh(np.array(CPU8[:pp]), ("pp",)), axis="pp",
                         num_microbatches=micro)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert len(calls) == pp * (pp + micro - 1)  # the reference's schedule, bubbles included


def test_pipeline_gradients_match_jax():
    pp, dim, batch = 4, 8, 8
    jp = _jstacked(1, pp, dim)
    x = np.random.default_rng(6).normal(0, 1, (batch, dim)).astype(np.float32)
    jmesh = JMesh(np.array(jax.devices()[:pp]), ("pp",))
    want = jax.grad(lambda p: jnp.sum(jpipeline_apply(_jstage, p, jnp.asarray(x), mesh=jmesh,
                                                      num_microbatches=4) ** 2))(jp)
    params = _port_params(jp, grad=True)
    y = pipeline_apply(_stage, params, torch.from_numpy(x), mesh=Mesh(np.array(CPU8[:pp]),
                                                                      ("pp",)),
                       num_microbatches=4)
    (y**2).sum().backward()
    for name in want:
        np.testing.assert_allclose(params[name].grad.numpy(), np.asarray(want[name]),
                                   atol=1e-4, rtol=1e-4, err_msg=name)


def test_pipeline_rejects_bad_microbatch():
    params = _port_params(_jstacked(0, 2, 4))
    mesh = Mesh(np.array(CPU8[:2]), ("pp",))
    with pytest.raises(ValueError, match="not divisible"):
        pipeline_apply(_stage, params, torch.zeros((6, 4)), mesh=mesh, num_microbatches=4)
    with pytest.raises(ValueError, match="stages"):
        pipeline_apply(_stage, _port_params(_jstacked(0, 4, 4)), torch.zeros((4, 4)),
                       mesh=mesh, num_microbatches=2)


# ---------------- the MoE's ep route ----------------

def test_moe_expert_parallel_matches_jax():
    # tests/test_moe.py:125-150: dense dispatch, the experts over an 8-rank ep axis.
    kw = dict(dim=32, hidden=64, num_experts=8, top_k=2, dtype="float32", dispatch="dense",
              capacity_factor=4.0)
    jcfg = jmoe.MoEConfig(**kw)
    jp = jmoe.init_params(jax.random.PRNGKey(2), jcfg)
    x = np.array(jax.random.normal(jax.random.PRNGKey(3), (2, 32, 32), jnp.float32))
    y_ref, aux_ref = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    cfg = moe.MoEConfig(**kw, ep_axis="ep")
    assert moe.ep_specs(cfg) == {"router": (), "w1": ("ep",), "w3": ("ep",), "w2": ("ep",)}
    model = moe.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu")
    with Mesh(np.array(CPU8), ("ep",)):
        y, aux = moe.moe_ffn(model, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(aux.item(), float(aux_ref), rtol=1e-5)
    y1, _ = moe.moe_ffn(model, torch.from_numpy(x), moe.MoEConfig(**kw))
    assert torch.equal(y, y1)  # each expert's products do not depend on its group
    shared = moe.MoEConfig(**kw, n_shared=1, ep_axis="ep")
    assert moe.ep_specs(shared)["ws2"] == ()
