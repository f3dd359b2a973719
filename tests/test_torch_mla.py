"""Port parity: MLA (ops/mla.py, models/mla_model.py) and the latent cache.

Inputs come from numpy seeds; JAX weights (init_params with PRNGKey(0)) are
carried into the port with `params_from_jax`. The JAX side runs its
`flash_attention` in interpret mode on the CPU; the port runs its plain
versions on the CPU.

Tolerances: the ops in fp32 atol = rtol = 1e-5 (the same fp32 products,
summed in other orders); in bf16 relerr 2e-2 (TOL["bf16"]: both packages
round the same points to bf16, and a one-ulp difference before a rounding
point moves a value by one bf16 ulp). The attention paths in fp32 atol =
rtol = 2e-5 (TOL["fp32"]); the latent-cache decode against its own
forward 2e-3, as tests/test_models.py:110-135 holds the reference's.

The sparse indexer's kept keys are compared before the outputs: a key at
the top-k edge may swap when the k-th and (k+1)-th scores lie within a
few ulps, and then only that query row may differ (`_kept_rows`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umfa_tpu.models import mla_model as jmla
from umfa_tpu.ops import mla as jops
from umfa_tpu.serving import kv_cache as jkv
from umfa_tpu_torch.models import mla_model
from umfa_tpu_torch.ops import mla
from umfa_tpu_torch.serving.kv_cache import append_latent, init_latent_cache
from umfa_tpu_torch.utils.testing import rel_err

FP32 = dict(atol=1e-5, rtol=1e-5)
MODEL = dict(atol=2e-5, rtol=2e-5)
JCFG = jmla.MLAConfig(dim=256, num_heads=4, latent_dim=32, dtype="float32", interpret=True)
CFG = mla_model.MLAConfig(dim=256, num_heads=4, latent_dim=32, dtype="float32")
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def jparams():
    return jmla.init_params(jax.random.PRNGKey(0), JCFG)


def _port(jparams, cfg=CFG):
    return mla_model.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                                     device="cpu")


def _pair(a, dtype):
    """A numpy array as (jax array, torch tensor) of the same dtype."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(np.asarray(a, np.float32)).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **FP32)
    else:
        assert rel_err(_np(got), _np(want)) <= 2e-2


def _mla_inputs(seed, dtype, b=2, s=40, lat=32, heads=4, d=16, tq=3):
    rng = np.random.default_rng(seed)
    return dict(
        q=_pair(rng.normal(0, 1, (b, heads, tq, d)), dtype),
        latent=_pair(rng.normal(0, 1, (b, s, lat)), dtype),
        w_k=_pair(rng.normal(0, lat**-0.5, (lat, heads * d)), dtype),
        w_v=_pair(rng.normal(0, lat**-0.5, (lat, heads * d)), dtype),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_heads", [None, 4])
def test_mla_decompress_matches_jax(dtype, num_heads):
    a = _mla_inputs(0, dtype)
    jk, jv = jops.mla_decompress(a["latent"][0], a["w_k"][0], a["w_v"][0], num_heads=num_heads)
    k, v = mla.mla_decompress(a["latent"][1], a["w_k"][1], a["w_v"][1], num_heads=num_heads)
    assert k.shape == jk.shape and k.dtype == a["latent"][1].dtype
    _close(k, jk, dtype)
    _close(v, jv, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparse_indexer_scores_match_jax(dtype):
    rng = np.random.default_rng(1)
    q = _pair(rng.normal(0, 1, (2, 24, 32)), dtype)
    k = _pair(rng.normal(0, 1, (2, 40, 32)), dtype)
    got = mla.sparse_indexer_scores(q[1], k[1])
    assert got.dtype == torch.float32
    _close(got, jops.sparse_indexer_scores(q[0], k[0]), dtype)
    _close(mla.sparse_indexer_scores(q[1], k[1], scale=0.3),
           jops.sparse_indexer_scores(q[0], k[0], scale=0.3), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", ["none", "length", "chunk_start", "chunk_start_per_row"])
def test_mla_absorbed_decode_matches_jax(dtype, mask):
    a = _mla_inputs(2, dtype)
    lengths = np.array([40, 23], np.int32)
    kw_j, kw_t = {}, {}
    if mask != "none":
        kw_j["length"], kw_t["length"] = jnp.asarray(lengths), torch.from_numpy(lengths)
    if mask == "chunk_start":
        kw_j["chunk_start"], kw_t["chunk_start"] = jnp.int32(20), 20
        lengths[:] = 23
        kw_j["length"], kw_t["length"] = jnp.asarray(lengths), torch.from_numpy(lengths)
    if mask == "chunk_start_per_row":
        start = lengths - 3
        kw_j["chunk_start"], kw_t["chunk_start"] = jnp.asarray(start), torch.from_numpy(start)
    want = jops.mla_absorbed_decode(a["q"][0], a["latent"][0], a["w_k"][0], a["w_v"][0], **kw_j)
    got = mla.mla_absorbed_decode(a["q"][1], a["latent"][1], a["w_k"][1], a["w_v"][1], **kw_t)
    assert got.shape == want.shape and got.dtype == a["q"][1].dtype
    _close(got, want, dtype)


def test_mla_attention_matches_jax():
    a = _mla_inputs(4, "float32", s=64, tq=64, d=64, heads=2, lat=32)
    want = jops.mla_attention(a["q"][0], a["latent"][0], a["w_k"][0], a["w_v"][0], causal=True,
                              interpret=True)
    got = mla.mla_attention(a["q"][1], a["latent"][1], a["w_k"][1], a["w_v"][1], causal=True)
    np.testing.assert_allclose(_np(got), _np(want), **MODEL)


def _kept_rows(jparams, x, topk):
    """Rows (B, S) whose kept key sets agree between JAX and the port; a
    row that differs must have its k-th and (k+1)-th scores within 4 ulps
    (fp32) of each other."""
    jx = jnp.asarray(x)
    jlat = jmla.compress_kv(jparams, jx)
    scores = np.asarray(jops.sparse_indexer_scores(jmla.compress_kv(jparams, jx), jlat))
    kth = np.sort(scores, axis=-1)[..., -topk][..., None]
    jkeep = scores >= kth
    model = _port(jparams)
    tx = torch.from_numpy(x)
    keep = (mla_model.indexer_bias(model, tx, mla_model.compress_kv(model, tx), topk)[:, 0]
            == 0).numpy()
    assert keep.sum(-1).min() >= topk
    differ = (keep != jkeep).any(-1)
    if differ.any():
        srt = -np.sort(-scores[differ], axis=-1)
        gap = srt[:, topk - 1] - srt[:, topk]
        assert (gap <= 4 * np.spacing(srt[:, topk - 1])).all(), gap
    return ~differ


@pytest.mark.parametrize("indexer", [None, 16])
@pytest.mark.parametrize("causal", [True, False])
def test_mla_forward_matches_jax(jparams, indexer, causal):
    x = np.random.default_rng(5).normal(0, 1, (2, 64, 256)).astype(np.float32)
    jcfg = dataclasses.replace(JCFG, indexer_topk=indexer, causal=causal)
    cfg = dataclasses.replace(CFG, indexer_topk=indexer, causal=causal)
    rows = np.ones((2, 64), bool) if indexer is None else _kept_rows(jparams, x, indexer)
    want = np.asarray(jmla.forward(jparams, jnp.asarray(x), jcfg))
    with torch.no_grad():
        got = mla_model.forward(_port(jparams, cfg), torch.from_numpy(x), cfg).numpy()
    assert got.shape == (2, 64, 256) and np.isfinite(got).all()
    np.testing.assert_allclose(got[rows], want[rows], **MODEL)


def test_mla_indexer_rows_whose_kept_keys_all_lie_ahead(jparams):
    # Token j is (1 + j)·v, so every query's top-4 keys are the last four:
    # under causal, rows 0-27 keep only future keys and see nothing but
    # -1e30 biases. A bias is not an index mask: such a row averages V over
    # its visible keys (LSE -1e30), in both packages, and is not 0.
    v = np.random.default_rng(13).normal(0, 1, (1, 1, 256)).astype(np.float32)
    x = v * (1.0 + np.arange(32, dtype=np.float32))[None, :, None]
    jcfg = dataclasses.replace(JCFG, indexer_topk=4)
    cfg = dataclasses.replace(CFG, indexer_topk=4)
    model = _port(jparams, cfg)
    tx = torch.from_numpy(x)
    with torch.no_grad():
        lat = mla_model.compress_kv(model, tx)
        keep = mla_model.indexer_bias(model, tx, lat, 4)[0, 0] == 0
        got = mla_model.attend(model, tx, lat, cfg).numpy()
    assert keep[:, -4:].all() and keep.sum() == 4 * 32
    jx = jnp.asarray(x)
    want = np.asarray(jmla.attend(jparams, jx, jmla.compress_kv(jparams, jx), jcfg))
    np.testing.assert_allclose(got, want, **MODEL)
    assert (np.abs(got[0, :28]).sum(-1) > 0).all()


def test_mla_sparse_indexer_changes_the_output(jparams):
    # As tests/test_models.py:95-107: the top-16 mask is not the dense path.
    x = torch.from_numpy(np.random.default_rng(6).normal(0, 1, (1, 64, 256)).astype(np.float32))
    model = _port(jparams)
    with torch.no_grad():
        sparse = mla_model.forward(model, x, dataclasses.replace(CFG, indexer_topk=16,
                                                                 causal=False))
        dense = mla_model.forward(model, x, dataclasses.replace(CFG, causal=False))
    assert torch.isfinite(sparse).all() and not torch.allclose(sparse, dense)


def test_mla_forward_takes_gradients(jparams):
    # The forward runs under autograd (flash_attention's backward); the
    # indexer's mask carries no gradient.
    cfg = dataclasses.replace(CFG, indexer_topk=16)
    model = _port(jparams, cfg)
    x = torch.from_numpy(np.random.default_rng(7).normal(0, 1, (1, 32, 256)).astype(np.float32))
    mla_model.forward(model, x, cfg).square().mean().backward()
    for name in mla_model.PARAMS:
        g = getattr(model, name).grad
        assert g is not None and torch.isfinite(g).all() and g.abs().sum() > 0, name


def _decode_runs(jparams, x, prefill):
    """Prefill `prefill` tokens as one chunk, then decode one by one, in
    both packages; returns ([(jax y, port y)], port cache)."""
    b, s, _ = x.shape
    jcache = jkv.init_latent_cache(b, s, JCFG.latent_dim, jnp.float32)
    cache = init_latent_cache(b, s, CFG.latent_dim, torch.float32, device="cpu")
    model = _port(jparams)
    out = []
    for lo, hi in [(0, prefill)] + [(t, t + 1) for t in range(prefill, s)]:
        jy, jcache = jmla.decode_step(jparams, jnp.asarray(x[:, lo:hi]), jcache, JCFG)
        y, cache = mla_model.decode_step(model, torch.from_numpy(x[:, lo:hi]), cache, CFG)
        out.append((np.asarray(jy), y.numpy()))
    np.testing.assert_array_equal(cache.length.numpy(), np.asarray(jcache.length))
    np.testing.assert_allclose(cache.latent.numpy(), np.asarray(jcache.latent), **FP32)
    return out, cache


def test_mla_decode_step_matches_jax_and_its_forward(jparams):
    x = np.random.default_rng(8).normal(0, 1, (2, 24, 256)).astype(np.float32)
    runs, _ = _decode_runs(jparams, x, 16)
    for want, got in runs:
        np.testing.assert_allclose(got, want, **MODEL)
    with torch.no_grad():
        full = mla_model.forward(_port(jparams), torch.from_numpy(x), CFG).numpy()
    got = np.concatenate([y for _, y in runs], axis=1)
    np.testing.assert_allclose(got, full, atol=2e-3, rtol=2e-3)


def _latent(rng, shape):
    return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))


def test_append_latent_uniform_pos_matches_ragged():
    # tests/test_serving.py:299-313: the in-place slice write equals the
    # ragged scatter bit for bit.
    rng = np.random.default_rng(9)
    lat, pre = _latent(rng, (2, 5, 32)), _latent(rng, (2, 10, 32))
    base = append_latent(init_latent_cache(2, 64, 32, torch.float32, device="cpu"), pre)
    fast = append_latent(dataclasses.replace(base, latent=base.latent.clone()), lat,
                         pos=int(base.length[0]))
    ragged = append_latent(dataclasses.replace(base, latent=base.latent.clone()), lat)
    assert torch.equal(fast.latent, ragged.latent) and torch.equal(fast.length, ragged.length)
    assert base.length.tolist() == [10, 10] and fast.length.tolist() == [15, 15]
    jbase = jkv.append_latent(jkv.init_latent_cache(2, 64, 32, jnp.float32),
                              jnp.asarray(pre.numpy()))
    jfast = jkv.append_latent(jbase, jnp.asarray(lat.numpy()), pos=jbase.length[0])
    np.testing.assert_array_equal(fast.latent.numpy(), np.asarray(jfast.latent))


def test_append_latent_ragged_writes_each_row_at_its_length():
    rng = np.random.default_rng(10)
    cache = append_latent(init_latent_cache(2, 16, 8, torch.float32, device="cpu"),
                          _latent(rng, (2, 6, 8)))
    cache.length = torch.tensor([6, 3], dtype=torch.int32)
    new = _latent(rng, (2, 2, 8))
    jcache = jkv.LatentKVCache(latent=jnp.asarray(cache.latent.numpy()),
                               length=jnp.asarray(cache.length.numpy()))
    append_latent(cache, new)
    jcache = jkv.append_latent(jcache, jnp.asarray(new.numpy()))
    np.testing.assert_array_equal(cache.latent.numpy(), np.asarray(jcache.latent))
    assert cache.length.tolist() == [8, 5]
    assert torch.equal(cache.latent[1, 3:5], new[1])


def test_append_latent_debug_poison_on_broken_promise(monkeypatch):
    # UMFA_DEBUG=1: pos= with ragged lengths NaN-poisons the written rows.
    monkeypatch.setenv("UMFA_DEBUG", "1")
    rng = np.random.default_rng(11)
    cache = append_latent(init_latent_cache(2, 64, 16, torch.float32, device="cpu"),
                          _latent(rng, (2, 16, 16)))
    cache.length = torch.tensor([16, 8], dtype=torch.int32)  # ragged now
    new = _latent(rng, (2, 1, 16))
    append_latent(cache, new, pos=int(cache.length[0]))
    assert torch.isnan(cache.latent[:, 16]).all()
    cache.length = torch.tensor([17, 17], dtype=torch.int32)  # the promise kept
    append_latent(cache, new, pos=int(cache.length[0]))
    assert torch.isfinite(cache.latent[:, 17]).all()


def test_mla_decode_step_ragged_path(jparams):
    # tests/test_serving.py:336-361: uniform_pos=False appends each row at
    # its own fill and equals each sequence decoded alone; and JAX's ragged
    # step on the same cache.
    cfg = mla_model.MLAConfig(dim=64, num_heads=2, latent_dim=16, dtype="float32")
    jcfg = jmla.MLAConfig(dim=64, num_heads=2, latent_dim=16, dtype="float32", interpret=True)
    jp = jmla.init_params(jax.random.PRNGKey(0), jcfg)
    model = _port(jp, cfg)
    rng = np.random.default_rng(12)
    x_fill = rng.normal(0, 1, (2, 12, 64)).astype(np.float32)
    x = rng.normal(0, 1, (2, 1, 64)).astype(np.float32)
    cache = append_latent(init_latent_cache(2, 32, 16, torch.float32, device="cpu"),
                          mla_model.compress_kv(model, torch.from_numpy(x_fill)).detach())
    cache.length = torch.tensor([12, 8], dtype=torch.int32)  # ragged
    jcache = jkv.LatentKVCache(latent=jnp.asarray(cache.latent.numpy()),
                               length=jnp.asarray(cache.length.numpy()))
    y, cache = mla_model.decode_step(model, torch.from_numpy(x), cache, cfg, uniform_pos=False)
    jy, _ = jmla.decode_step(jp, jnp.asarray(x), jcache, jcfg, uniform_pos=False)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **MODEL)
    assert cache.length.tolist() == [13, 9]
    for b, ln in enumerate([12, 8]):
        c1 = append_latent(init_latent_cache(1, 32, 16, torch.float32, device="cpu"),
                           mla_model.compress_kv(model, torch.from_numpy(x_fill[b:b + 1, :ln]))
                           .detach())
        y1, _ = mla_model.decode_step(model, torch.from_numpy(x[b:b + 1]), c1, cfg)
        np.testing.assert_allclose(y[b:b + 1].numpy(), y1.numpy(), atol=1e-4, rtol=1e-4)


def test_params_from_jax_keeps_names_layouts_and_dtype(jparams):
    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    model = _port(jparams, cfg)
    for name in mla_model.PARAMS:
        p = getattr(model, name)
        assert p.dtype == torch.bfloat16 and tuple(p.shape) == jparams[name].shape, name
    init = mla_model.init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    assert all(tuple(getattr(init, n).shape) == jparams[n].shape for n in mla_model.PARAMS)
    assert abs(float(init.wq.detach().std()) - 256**-0.5) < 0.1 * 256**-0.5
