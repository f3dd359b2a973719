"""Port parity: block-sparse masks (ops/block_mask.py) and the walked
attention through `flash_attention(block_mask=...)` and `attention()`.

The same numpy masks and inputs go through the JAX package (its Pallas
kernels in interpret mode on the CPU) and the port's plain PyTorch paths on
the CPU. The tables (block map, compacted fetch tables, fill schedule, tile
sizes, bias) must be equal, value for value: the tiling decides which keys
a row that sees no key averages over.

Tolerances: fp32 forward atol = rtol = 2e-5 and LSE 1e-5 (the reference's
forward bound, tests/test_flash_forward.py:165); gradients 1e-4 (the
backward bound of tests/test_flash_backward.py:32). Both sides compute in
full fp32; only the summation order differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import umfa_tpu
import umfa_tpu_torch
from umfa_tpu.ops import block_mask as jbm
from umfa_tpu.ops.attention import flash_attention as jax_flash_attention
from umfa_tpu.ops.flash_fwd import BlockSizes as JBlockSizes
from umfa_tpu_torch.ops import block_mask as tbm
from umfa_tpu_torch.ops.attention import flash_attention
from umfa_tpu_torch.ops.flash_fwd import BlockSizes

FWD = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _segments(b, s, seed, pad=0):
    """(B, S) int ids of uneven documents per row, the last `pad` ids -1."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((b, s), np.int32)
    for r in range(b):
        pos, doc = 0, 0
        while pos < s:
            n = int(rng.integers(16, s // 2))
            ids[r, pos:pos + n] = doc
            pos, doc = pos + n, doc + 1
        if pad:
            ids[r, s - pad:] = -1
    return ids


def _padded_segments():
    """The motivating case: S 512, documents 0-149, 150-299, 384-511, rows
    300-383 padding (id -1) that see no key inside PARTIAL tiles."""
    seg = np.zeros((1, 512), np.int32)
    seg[0, 150:300] = 1
    seg[0, 300:384] = -1
    seg[0, 384:] = 2
    return seg


def _per_head_bool(hq, s):
    """(1, Hq, S, S): causal with a per-head window, heads differ."""
    i = np.arange(s)[:, None]
    j = np.arange(s)[None, :]
    return np.stack([(j <= i) & (j >= i - 40 * (h + 1)) for h in range(hq)])[None]


def _build(kind, blocks=None):
    """(JAX BlockMask, port BlockMask) from the same numpy description."""
    jkw = {} if blocks is None else dict(block_sizes=JBlockSizes(*blocks))
    tkw = dict(device="cpu") if blocks is None else dict(block_sizes=BlockSizes(*blocks),
                                                          device="cpu")
    name, *args = kind
    if name == "causal":
        s = args[0]
        return jbm.causal_block_mask(s, s, **jkw), tbm.causal_block_mask(s, s, **tkw)
    if name == "window":
        s, left, right = args
        return (jbm.sliding_window_block_mask(s, s, left, right, **jkw),
                tbm.sliding_window_block_mask(s, s, left, right, **tkw))
    if name == "segments":
        seg, causal = args
        return (jbm.segment_block_mask(jnp.asarray(seg), causal=causal, **jkw),
                tbm.segment_block_mask(torch.from_numpy(seg), causal=causal, **tkw))
    if name == "mask_mod":
        fn, sq, sk = args
        return (jbm.make_block_mask(fn, sq, sk, **jkw), tbm.make_block_mask(fn, sq, sk, **tkw))
    if name == "bool":
        arr, sq, sk = args
        return (jbm.make_block_mask(jnp.asarray(arr), sq, sk, **jkw),
                tbm.make_block_mask(torch.from_numpy(arr), sq, sk, **tkw))
    raise ValueError(name)


def _k_lt_q_plus(q, k):
    return k <= q + 7


def _key_prefix(q, k):
    return k < 150  # depends on the key only: broadcast to (Sq, Sk)


TABLE_CASES = {
    "causal_512_auto": (("causal", 512), None),
    "causal_1024_auto": (("causal", 1024), None),
    "causal_384_explicit_128": (("causal", 384), (128, 128)),
    "window_640_100_0_auto": (("window", 640, 100, 0), None),
    "window_512_64_32_explicit": (("window", 512, 64, 32), (128, 256)),
    "segments_per_batch_auto": (("segments", _segments(3, 512, 1), False), None),
    "segments_causal_padded_explicit": (("segments", _segments(2, 512, 2, pad=70), True),
                                        (128, 128)),
    "segments_aligned_no_bias": (("segments", np.repeat(np.arange(2), 512)[None].astype(np.int32),
                                  False), None),
    "mask_mod_ragged_200": (("mask_mod", _k_lt_q_plus, 200, 200), None),
    "mask_mod_one_index": (("mask_mod", _key_prefix, 256, 300), None),
    "bool_per_head": (("bool", _per_head_bool(4, 256), 256, 256), (64, 128)),
    "bool_96x160": (("bool", _per_head_bool(2, 384)[:, :1], 384, 384), (96, 160)),
}


@pytest.mark.parametrize("case", list(TABLE_CASES))
def test_block_mask_tables_equal_the_reference(case):
    kind, blocks = TABLE_CASES[case]
    jm, tm = _build(kind, blocks)
    assert (tm.block_q, tm.block_k, tm.seq_q, tm.seq_k) == (jm.block_q, jm.block_k, jm.seq_q,
                                                            jm.seq_k)
    for field in ("block_map", "fetch_kv", "fetch_q", "hold_kv", "fill_kv"):
        got, want = getattr(tm, field), np.asarray(getattr(jm, field))
        assert got.dtype == torch.int32, field
        np.testing.assert_array_equal(got.numpy(), want, err_msg=field)
    assert (tm.bias is None) == (jm.bias is None)
    if jm.bias is not None:
        np.testing.assert_array_equal(tm.bias.numpy(), np.asarray(jm.bias))
    assert tm.sparsity == pytest.approx(float(jm.sparsity), abs=1e-7)
    if case == "segments_aligned_no_bias":
        assert tm.bias is None and (tm.block_q, tm.block_k) == (512, 512)


def _run_both(jm, tm, b, hq, hkv, s, d, causal=False, seed=0):
    """Forward and gradients of both packages' flash_attention on the
    same inputs and cotangents (LSE's only where a row sees a key)."""
    q, k, v = _normal(seed, b, hq, s, d), _normal(seed + 1, b, hkv, s, d), _normal(seed + 2, b, hkv, s, d)
    g_out = _normal(seed + 3, b, hq, s, d)
    g_lse = _normal(seed + 4, b, hq, s)

    def jax_fn(q, k, v):
        return jax_flash_attention(q, k, v, causal=causal, block_mask=jm, interpret=True,
                                   return_lse=True)

    (jo, jl), vjp = jax.vjp(jax_fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jl = np.asarray(jl)
    g_lse = np.where(jl > -1e29, g_lse, 0.0).astype(np.float32)
    jg = vjp((jnp.asarray(g_out), jnp.asarray(g_lse)))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    to, tl = flash_attention(tq, tk, tv, causal=causal, block_mask=tm, return_lse=True)
    tg = torch.autograd.grad((to, tl), (tq, tk, tv),
                             (torch.from_numpy(g_out), torch.from_numpy(g_lse)))
    return (np.asarray(jo), jl, [np.asarray(g) for g in jg]), (
        to.detach().numpy(), tl.detach().numpy(), [g.numpy() for g in tg])


def _assert_match(want, got):
    (jo, jl, jg), (to, tl, tg) = want, got
    np.testing.assert_allclose(to, jo, **FWD)
    vis = jl > -1e29
    np.testing.assert_allclose(tl[vis], jl[vis], atol=1e-5, rtol=0)
    assert (tl[~vis] == -1e30).all()
    for name, g, w in zip("qkv", tg, jg):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **GRAD)


ATTN_CASES = {
    # name: (kind, blocks, b, hq, hkv, s, d, causal)
    "padded_segments_128": (("segments", _padded_segments(), False), (128, 128),
                            1, 2, 2, 512, 32, False),
    "segments_causal_gqa_auto": (("segments", _segments(2, 512, 3, pad=40), True), None,
                                 2, 4, 2, 512, 32, False),
    "per_head_gqa": (("bool", _per_head_bool(4, 256), 256, 256), (64, 128),
                     1, 4, 2, 256, 32, False),
    "blocks_96x160": (("bool", _per_head_bool(2, 384)[:, :1], 384, 384), (96, 160),
                      1, 2, 1, 384, 32, False),
    "window_with_causal_flag": (("window", 384, 100, 0), (128, 128), 1, 2, 1, 384, 64, True),
    "aligned_documents_no_bias": (("segments", np.repeat(np.arange(2), 256)[None].astype(np.int32),
                                   False), (256, 256), 1, 2, 1, 512, 32, False),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_flash_attention_walks_the_block_mask_as_the_reference(case):
    kind, blocks, b, hq, hkv, s, d, causal = ATTN_CASES[case]
    jm, tm = _build(kind, blocks)
    want, got = _run_both(jm, tm, b, hq, hkv, s, d, causal=causal)
    _assert_match(want, got)
    if case == "padded_segments_128":
        # Rows 300-383 see no key: they average V over the keys of their
        # walked tiles (keys 128-383), with LSE at the mask value.
        v = _normal(2, b, hkv, s, d)
        np.testing.assert_allclose(got[0][0, :, 300:384], np.broadcast_to(
            v[0, :, 128:384].mean(axis=1)[:, None], (hq, 84, d)), atol=1e-5)
        assert (got[1][0, :, 300:384] == -1e30).all()
    if case == "aligned_documents_no_bias":
        assert tm.bias is None and tm.sparsity == 0.5


def test_attention_takes_a_mask_mod_and_a_block_mask():
    q, k, v = _normal(10, 1, 2, 256, 32), _normal(11, 1, 1, 256, 32), _normal(12, 1, 1, 256, 32)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    want = np.asarray(umfa_tpu.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         _k_lt_q_plus, interpret=True))
    got = umfa_tpu_torch.attention(tq, tk, tv, _k_lt_q_plus)
    np.testing.assert_allclose(got.numpy(), want, **FWD)
    seg = _segments(1, 256, 5, pad=30)
    jm = jbm.segment_block_mask(jnp.asarray(seg), causal=True)
    want, want_lse = umfa_tpu.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm,
                                        interpret=True, return_lse=True)
    got, got_lse = umfa_tpu_torch.attention(
        tq, tk, tv, umfa_tpu_torch.segment_block_mask(torch.from_numpy(seg), causal=True,
                                                      device="cpu"),
        return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    vis = np.asarray(want_lse) > -1e29
    np.testing.assert_allclose(got_lse.numpy()[vis], np.asarray(want_lse)[vis], atol=1e-5)
    assert umfa_tpu_torch.get_dispatch_stats()["fused_fwd"] >= 1


def test_flash_attention_refuses_a_bias_beside_a_block_mask():
    q = torch.zeros(1, 1, 128, 32)
    with pytest.raises(ValueError, match="either bias or block_mask"):
        flash_attention(q, q, q, torch.zeros(128, 128),
                        block_mask=tbm.causal_block_mask(128, 128, device="cpu"))


@pytest.mark.parametrize("build", [
    lambda: tbm.causal_block_mask(128, 128),
    lambda: tbm.sliding_window_block_mask(128, 128, 32, 0),
    lambda: tbm.make_block_mask(_k_lt_q_plus, 128, 128),
    lambda: tbm.segment_block_mask(np.zeros((1, 128), np.int32)),
], ids=["causal", "window", "mask_mod", "numpy_ids"])
def test_builders_without_a_tensor_default_to_the_card(build):
    """The device rule: with no tensor to follow, the tables go to the card
    (a RuntimeError where there is none), as every entry point's do."""
    if torch.cuda.is_available():
        assert build().block_map.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_builders_follow_a_tensor_mask_or_ids():
    seg = torch.zeros((1, 128), dtype=torch.int32)
    assert tbm.segment_block_mask(seg).block_map.device == seg.device
    mask = torch.ones((128, 128), dtype=torch.bool).tril()
    assert tbm.make_block_mask(mask, 128, 128).fetch_kv.device == mask.device


def test_nan_check_recomputes_a_block_mask_call_with_its_walk(monkeypatch):
    """UMFA_NAN_CHECK's naive recompute keeps the walk: the padded rows
    300-383 still average V over their walked keys, not over every key."""
    from umfa_tpu_torch import api
    from umfa_tpu_torch.engine import config as tcfg

    q, k, v = (torch.from_numpy(_normal(s, 1, 2, 512, 32)) for s in (30, 31, 32))
    mask = tbm.segment_block_mask(torch.from_numpy(_padded_segments()), causal=True,
                                  block_sizes=BlockSizes(128, 128), device="cpu")
    fused = umfa_tpu_torch.attention(q, k, v, mask)
    monkeypatch.setattr(tcfg, "NAN_CHECK", True)
    monkeypatch.setattr(api, "flash_attention",
                        lambda q, *a, **kw: (torch.full_like(q, float("nan")), None))
    before = umfa_tpu_torch.get_dispatch_stats()["naive_fallback"]
    qg = q.clone().requires_grad_(True)
    out = umfa_tpu_torch.attention(qg, k, v, mask)
    assert umfa_tpu_torch.get_dispatch_stats()["naive_fallback"] == before + 1
    np.testing.assert_allclose(out.detach().numpy(), fused.numpy(), **FWD)
    np.testing.assert_allclose(out.detach().numpy()[0, :, 300:384], np.broadcast_to(
        v.numpy()[0, :, 128:384].mean(axis=1)[:, None], (2, 84, 32)), atol=1e-5)
    out.sum().backward()  # the recompute is plain autograd
    assert torch.isfinite(qg.grad).all()


def test_lse_check_arbitrates_with_the_float64_lse():
    """`lse_check` (the card checks' LSE gate): the float64 LSE of the plain
    forward's arithmetic agrees with the plain version, and a row past the
    gate passes only where it agrees with that float64 LSE."""
    from umfa_tpu_torch.ops.flash_fwd import flash_attention_forward_plain, walked_keys
    from umfa_tpu_torch.utils.testing import lse_check, lse_f64

    q, k = torch.from_numpy(_normal(40, 1, 4, 300, 32)), torch.from_numpy(_normal(41, 1, 2, 300, 32))
    mask = tbm.segment_block_mask(torch.from_numpy(_segments(1, 300, 6, pad=20)), causal=True,
                                  device="cpu")
    _, lse = flash_attention_forward_plain(q, k, k, mask.bias, block_map=mask.block_map,
                                           block_q=mask.block_q, block_k=mask.block_k)
    keep = walked_keys(mask.walk(), 300, 300)
    rows = torch.nonzero(lse > -1e29)
    np.testing.assert_allclose(lse_f64(q, k, mask.bias, rows, keep=keep).numpy(),
                               lse[tuple(rows.T)].numpy(), atol=1e-5)
    assert lse_check(lse, lse, q, k, mask.bias, 1e-5, keep=keep)["lse_ok"]
    off = lse.clone()
    off[0, 1, 7] += 1e-4  # past the gate and off the float64 LSE
    res = lse_check(off, lse, q, k, mask.bias, 1e-5, keep=keep)
    assert res["lse_rows_over_tol"] == 1 and not res["lse_ok"]
    # The plain version one rounding off on that row: the kernel's value
    # holds against the float64 one.
    res = lse_check(lse, off, q, k, mask.bias, 1e-5, keep=keep)
    assert res["lse_rows_over_tol"] == 1 and res["lse_ok"]
