"""Port parity: block-sparse masks on the quantized routes —
`quantized_flash_attention(block_mask=...)` on the single-launch route
(table row 7) and on the two-pass route (row 5), their STE gradients (rows
8, 9, and the dense backward for ASYMMETRIC and a dense Q), and quantized
`attention()` with a BlockMask or a mask_mod — against the JAX package.

The same numpy masks and inputs go through the JAX package (its Pallas
kernels in interpret mode on the CPU) and the port's plain PyTorch paths.

Tolerances, the quantized modules' own (tests/test_torch_quant_variants.py):
out relerr <= 1e-3; LSE abs <= 1e-3 on the single-launch route (the
reference rounds P against a running max where it walks more than one
tile; with the Hadamard rotation >= 99.5 % of the rows within 1e-3 and
every row 3e-2) and <= 1e-5 on the two-pass route. A walk has rows that
cross a map tile with few keys (a document's first rows): there the two
rounding schedules can part by up to ~2e-3, so a row past 1e-3 must be
explained by them: on the port's own scores, the final-max model within
1e-5 of the port's LSE and the reference's running-max model (its walk of
the map's tiles) within 1e-5 of JAX's. q/k/v gradients relerr
<= 5e-3 for INT8 and 2e-2 for INT4 (the reference's STE contract,
tests/test_quantized_attention.py:402-409). The smoothing means qm/vm
relerr <= 1e-6; residual codes at most one apart and >= 99.9 % equal,
scales rtol 1e-6, on the tiles the reference fills (it writes no others).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import umfa_tpu
import umfa_tpu_torch
from umfa_tpu.engine.config import QuantizationConfig as JQuantizationConfig
from umfa_tpu.engine.config import QuantStrategy as JQuantStrategy
from umfa_tpu.ops import block_mask as jbm
from umfa_tpu.ops import quant_fused_attn as jqfa
from umfa_tpu.ops.flash_fwd import BlockSizes as JBlockSizes
from umfa_tpu.ops.quant_attention import quantized_flash_attention as jqflash
from umfa_tpu_torch.engine.config import QuantizationConfig, QuantStrategy
from umfa_tpu_torch.ops import block_mask as tbm
from umfa_tpu_torch.ops import quant
from umfa_tpu_torch.ops import quant_attention as qa
from umfa_tpu_torch.ops.flash_fwd import SKIP, BlockSizes
from umfa_tpu_torch.ops.quant_attention import quantized_flash_attention
from umfa_tpu_torch.ops.quant_fused_attn import fused_path_supported, fused_quantize_attend
from umfa_tpu_torch.utils.testing import rel_err


def _x(seed, shape, offset=0.0):
    return (np.random.default_rng(seed).normal(0, 1, shape) + offset).astype(np.float32)


def _left_padded(s):
    """Batch 0: ids -1 on rows 0-199, then documents of 150 and the rest;
    batch 1: uneven documents with a -1 tail. With 128-row tiles batch 0's
    first fill is key tile 1, batch 1's tile 0 (the means windows differ)."""
    seg = np.full((2, s), -1, np.int32)
    seg[0, 200:350], seg[0, 350:] = 0, 1
    seg[1, :90], seg[1, 90:250], seg[1, 250:s - 40] = 0, 1, 2
    return seg


def _per_head(hq, s):
    """(1, Hq, S, S): causal with a per-head window, heads differ."""
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    return np.stack([(j <= i) & (j >= i - 40 * (h + 1)) for h in range(hq)])[None]


def _keys_from_128(q, k):
    return k >= 128  # the key only: every slice's first fill is key tile 1


MASKS = {
    # name: (kind, args, BlockSizes or None, S)
    "causal": ("causal", (), (128, 128), 256),
    "left_padded_segments": ("segments", (_left_padded(384), True), (128, 128), 384),
    "per_head_gqa": ("bool", (_per_head(4, 256),), (64, 128), 256),
    "blocks_96x160": ("segments", (_left_padded(384), True), (96, 160), 384),
    "aligned_no_bias": ("segments", (np.repeat(np.arange(2), 128)[None].repeat(2, 0)
                                     .astype(np.int32), False), (128, 128), 256),
    "mask_mod_keys_from_128": ("mask_mod", (_keys_from_128,), (128, 128), 256),
}


def _build(name):
    """(JAX BlockMask, port BlockMask, S) from the same description."""
    kind, args, blocks, s = MASKS[name]
    jkw = dict(block_sizes=JBlockSizes(*blocks))
    tkw = dict(block_sizes=BlockSizes(*blocks), device="cpu")
    if kind == "causal":
        return jbm.causal_block_mask(s, s, **jkw), tbm.causal_block_mask(s, s, **tkw), s
    if kind == "segments":
        seg, causal = args
        return (jbm.segment_block_mask(jnp.asarray(seg), causal=causal, **jkw),
                tbm.segment_block_mask(torch.from_numpy(seg), causal=causal, **tkw), s)
    if kind == "mask_mod":
        return jbm.make_block_mask(args[0], s, s, **jkw), tbm.make_block_mask(args[0], s, s, **tkw), s
    arr = args[0]
    return (jbm.make_block_mask(jnp.asarray(arr), s, s, **jkw),
            tbm.make_block_mask(torch.from_numpy(arr), s, s, **tkw), s)


def _configs(recipe, strategy=QuantStrategy.SYMMETRIC):
    mode_string, mode = (recipe[:-6], "block") if recipe.endswith("-block") else (recipe, "row")
    jcfg = dataclasses.replace(JQuantizationConfig.from_mode_string(mode_string, mode),
                               strategy=JQuantStrategy(strategy.value))
    tcfg = dataclasses.replace(QuantizationConfig.from_mode_string(mode_string, mode),
                               strategy=strategy)
    return jcfg, tcfg


def test_mean_tiles_are_each_slices_first_fill():
    """Finding the means windows on the host: the first fill of the
    left-padded batch is key tile 1, the other batch's tile 0, and the
    fill tables still equal the reference's."""
    jm, tm, _ = _build("left_padded_segments")
    np.testing.assert_array_equal(tm.kv_mean_tile.numpy(), [[1], [0]])
    for field in ("hold_kv", "fill_kv"):
        np.testing.assert_array_equal(getattr(tm, field).numpy(), np.asarray(getattr(jm, field)))
    _, tk, _ = _build("mask_mod_keys_from_128")
    assert tk.kv_mean_tile.tolist() == [[1]]
    from umfa_tpu_torch.ops.quant_fused_attn import first_fill_tiles
    assert torch.equal(first_fill_tiles(tm.fetch_kv, tm.fill_kv), tm.kv_mean_tile)


@pytest.mark.parametrize("missing", ["fill_kv", "fetch_kv"])
def test_fused_walk_refuses_a_map_without_its_fill_schedule(missing):
    """The means window of a walk is its first filled tile: a map whose
    fill schedule is missing raises, in the wrapper and the plain version,
    rather than take the means from row 0."""
    from umfa_tpu_torch.ops.quant_fused_attn import fused_quantize_attend_plain

    _, tm, s = _build("left_padded_segments")
    q, k = torch.from_numpy(_x(1, (2, 4, s, 32))), torch.from_numpy(_x(2, (2, 2, s, 32)))
    kw = dict(block_map=tm.block_map, fetch_kv=tm.fetch_kv, hold_kv=tm.hold_kv,
              fill_kv=tm.fill_kv, block_q=tm.block_q, block_k=tm.block_k)
    kw[missing] = None
    for fn in (fused_quantize_attend, fused_quantize_attend_plain):
        with pytest.raises(ValueError, match="fetch_kv and fill_kv"):
            fn(q, k, k, tm.bias, **kw)


def _route_counts(monkeypatch):
    """Count the calls of each route's forward inside the STE route."""
    counts = {"fused": 0, "two_pass": 0}
    fused, two = qa._fused, qa._quant_forward

    def count_fused(*a, **kw):
        counts["fused"] += 1
        return fused(*a, **kw)

    def count_two(*a, **kw):
        counts["two_pass"] += 1
        return two(*a, **kw)

    monkeypatch.setattr(qa, "_fused", count_fused)
    monkeypatch.setattr(qa, "_quant_forward", count_two)
    return counts


ROUTE_CASES = [
    # id, mask, recipe, strategy, D, route, extra kwargs, env
    ("fused_int8_left_padded", "left_padded_segments", "int8", "sym", 64, "fused", {}, {}),
    ("fused_int4_left_padded", "left_padded_segments", "int4", "sym", 64, "fused", {}, {}),
    ("fused_int8_block_96x160", "blocks_96x160", "int8-block", "sym", 32, "fused", {}, {}),
    ("fused_int8_asym_causal", "causal", "int8", "asym", 64, "fused", {}, {}),
    ("fused_qdense_mask_mod", "mask_mod_keys_from_128", "int8-qdense", "sym", 32, "fused", {},
     {}),
    ("fused_int8_aligned_no_bias", "aligned_no_bias", "int8", "sym", 32, "fused", {}, {}),
    ("two_pass_per_head_gqa", "per_head_gqa", "int8", "sym", 32, "two_pass", {}, {}),
    ("two_pass_bias_grad", "left_padded_segments", "int8", "sym", 64, "two_pass",
     dict(bias_grad=True), {}),
    ("two_pass_disabled_int4", "causal", "int4", "sym", 64, "two_pass", {},
     {"UMFA_DISABLE_FUSED_QUANT": "1"}),
]


@pytest.mark.parametrize("case", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_quantized_block_mask_routes_match_jax(case, monkeypatch):
    name, mask_name, recipe, strat, d, route, kw, env = case
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    strategy = QuantStrategy.ASYMMETRIC if strat == "asym" else QuantStrategy.SYMMETRIC
    jcfg, tcfg = _configs(recipe, strategy)
    jm, tm, s = _build(mask_name)
    b, hq, hkv = 2, 4, 2
    q, k, v = _x(1, (b, hq, s, d)), _x(2, (b, hkv, s, d), 0.5), _x(3, (b, hkv, s, d), 0.3)
    w, w_lse = _x(5, q.shape), _x(6, q.shape[:3])

    def jfn(q, k, v):
        return jqflash(q, k, v, config=jcfg, block_mask=jm, interpret=True, return_lse=True, **kw)

    (j_out, j_lse), vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (q, k, v)))
    j_lse = np.asarray(j_lse)
    vis = j_lse > -1e29
    w_lse = np.where(vis, w_lse, 0.0).astype(np.float32)
    jgrads = vjp((jnp.asarray(w), jnp.asarray(w_lse)))

    counts = _route_counts(monkeypatch)
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out, lse = quantized_flash_attention(*t, config=tcfg, block_mask=tm, return_lse=True, **kw)
    torch.autograd.backward((out, lse), (torch.from_numpy(w), torch.from_numpy(w_lse)))
    assert counts == ({"fused": 1, "two_pass": 0} if route == "fused"
                      else {"fused": 0, "two_pass": 1}), counts

    assert rel_err(out.detach(), np.asarray(j_out)) <= 1e-3
    lse_err = np.abs(lse.detach().numpy()[vis] - j_lse[vis])
    if route == "two_pass":
        assert lse_err.max() <= 1e-5
    elif tcfg.hadamard:
        assert (lse_err <= 1e-3).mean() >= 0.995 and lse_err.max() <= 3e-2
    else:
        past = np.argwhere(vis)[lse_err > 1e-3]
        _explained_by_the_running_max(q, k, v, tm, tcfg, past, lse.detach().numpy(), j_lse)
    np.testing.assert_array_equal(lse.detach().numpy()[~vis], j_lse[~vis])
    gtol = 2e-2 if "int4" in recipe else 5e-3
    for gname, tg, jg in zip(("dq", "dk", "dv"), t, jgrads):
        assert rel_err(tg.grad, np.asarray(jg)) <= gtol, gname
    if mask_name in ("left_padded_segments", "blocks_96x160"):
        # Some rows see no key inside walked PARTIAL tiles (ids -1), LSE
        # -1e30, zero dQ. The single-launch kernel averages V over exactly
        # those tiles' keys (plus vm); the two-pass route's V-mean restore
        # zeroes every row at the mask value, as the reference's does
        # (quant_attention.py:867-878).
        blind = out.detach().numpy()[~vis]
        assert (~vis).any() and ((blind != 0).any() if route == "fused" else (blind == 0).all())
        assert (t[0].grad.numpy()[~vis] == 0).all()


def _explained_by_the_running_max(q, k, v, tm, tcfg, rows, t_lse, j_lse):
    """Rows whose fused-route LSE is past 1e-3 from JAX's: the port's own
    scores (from its residuals, as its plain version forms them: the exact
    sum of bf16 products rounded once, + the cc row, + the bias) through two
    models of the row sum at D < 128 (bf16(P) summed): P rounded against the
    final row max (the port) and the reference's walk of the row's map tiles
    in order, P rounded against the running max and the sum rescaled by
    exp(m_old - m_new). Each model within 1e-5 of its package."""
    if len(rows) == 0:
        return
    assert len(rows) <= 8, f"{len(rows)} rows past the gate"
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    scale = np.float32(d ** -0.5)
    res = fused_quantize_attend(
        *(torch.from_numpy(a) for a in (q, k, v)), tm.bias, smooth=tcfg.smooth,
        smooth_q=tcfg.effective_smooth_q(), hadamard=tcfg.hadamard,
        q_precision=tcfg.q_precision, k_precision=tcfg.k_precision,
        v_precision=tcfg.v_precision, strategy=tcfg.strategy, mode=tcfg.mode,
        quant_blocks=tcfg.block_sizes, block_map=tm.block_map, fetch_kv=tm.fetch_kv,
        hold_kv=tm.hold_kv, fill_kv=tm.fill_kv, block_q=tm.block_q, block_k=tm.block_k)
    _, _, qt_q, qt_k, _, qm, _ = res

    def bf16(x):
        return x.to(torch.bfloat16).double()

    k_bf = bf16(quant.dequantize(qt_k, torch.float32))
    q_deq = torch.from_numpy(q) if qt_q is None else quant.dequantize(qt_q, torch.float32)
    q_bf = bf16(q_deq * float(scale))  # a dense Q is unrotated here (no Hadamard)
    for bi, h, r in rows.tolist():
        kk = k_bf[bi, h // group]
        sc = (q_bf[bi, h, r] @ kk.T).float().numpy()
        if qm is not None:
            sc = sc + (bf16(qm[bi, h, 0]) @ kk.T).float().numpy() * scale
        if tm.bias is not None:
            sc = sc + tm.bias[min(bi, tm.bias.shape[0] - 1), 0, r].numpy()
        m_map = tm.block_map[min(bi, tm.block_map.shape[0] - 1),
                             min(h, tm.block_map.shape[1] - 1), r // tm.block_q]
        tiles = [sc[t * tm.block_k:(t + 1) * tm.block_k]
                 for t in range(m_map.shape[0]) if m_map[t] != SKIP]

        def p_sum(x, m):
            return torch.from_numpy(np.exp(x - m)).to(torch.bfloat16).float().sum().item()

        m_final = max(x.max() for x in tiles)
        final = m_final + np.log(np.float32(sum(p_sum(x, m_final) for x in tiles)))
        m_run, l_run = np.float32(-1e30), np.float32(0.0)
        for x in tiles:
            m_new = max(m_run, x.max())
            l_run = np.float32(np.exp(m_run - m_new) * l_run + p_sum(x, m_new))
            m_run = m_new
        running = m_run + np.log(l_run)
        assert abs(final - t_lse[bi, h, r]) <= 1e-5, (bi, h, r)
        assert abs(running - j_lse[bi, h, r]) <= 1e-5, (bi, h, r)


def _codes(qt):
    vals = qt.values if isinstance(qt.values, torch.Tensor) else torch.from_numpy(
        np.array(qt.values))
    return (quant.unpack_int4(vals) if qt.precision.value == "int4" else vals).to(torch.int64)


RESIDUAL_CASES = [
    # id, mask, recipe, strategy, D
    ("int8_left_padded", "left_padded_segments", "int8", "sym", 64),
    ("int4_left_padded", "left_padded_segments", "int4", "sym", 32),
    ("int8_block_96x160", "blocks_96x160", "int8-block", "sym", 32),
    ("int8_asym_mask_mod", "mask_mod_keys_from_128", "int8", "asym", 32),
    ("qdense_causal", "causal", "int8-qdense", "sym", 32),
]


@pytest.mark.parametrize("case", RESIDUAL_CASES, ids=[c[0] for c in RESIDUAL_CASES])
def test_fused_walk_means_and_residuals_match_jax(case):
    """The single-launch kernel's own results under a map: the means from
    each slice's first filled tile (batch 0's tile 1 where it is left
    padded, every slice's tile 1 under keys >= 128), the BLOCK groups
    clamped to the map's tiles, and the residuals of every filled tile."""
    _, mask_name, recipe, strat, d = case
    strategy = QuantStrategy.ASYMMETRIC if strat == "asym" else QuantStrategy.SYMMETRIC
    jcfg, tcfg = _configs(recipe, strategy)
    jm, tm, s = _build(mask_name)
    b, hq, hkv = 2, 4, 2
    q, k, v = _x(11, (b, hq, s, d)), _x(12, (b, hkv, s, d), 0.5), _x(13, (b, hkv, s, d), 0.3)

    def cfg_kw(cfg):
        return dict(smooth=cfg.smooth, smooth_q=cfg.effective_smooth_q(), hadamard=cfg.hadamard,
                    q_precision=cfg.q_precision, k_precision=cfg.k_precision,
                    v_precision=cfg.v_precision, strategy=cfg.strategy, mode=cfg.mode,
                    quant_blocks=cfg.block_sizes)

    want = jqfa.fused_quantize_attend(
        *(jnp.asarray(a) for a in (q, k, v)), jm.bias, block_map=jm.block_map,
        fetch_kv=jm.fetch_kv, hold_kv=jm.hold_kv, fill_kv=jm.fill_kv,
        block_sizes=JBlockSizes(jm.block_q, jm.block_k), out_dtype=jnp.float32, interpret=True,
        **cfg_kw(jcfg))
    got = fused_quantize_attend(
        *(torch.from_numpy(a) for a in (q, k, v)), tm.bias, block_map=tm.block_map,
        fetch_kv=tm.fetch_kv, hold_kv=tm.hold_kv, fill_kv=tm.fill_kv, block_q=tm.block_q,
        block_k=tm.block_k, out_dtype=torch.float32, **cfg_kw(tcfg))
    assert rel_err(got[0], np.asarray(want[0])) <= 1e-3
    for mname, jmean, tmean in zip(("qm", "vm"), want[5:], got[5:]):
        assert (jmean is None) == (tmean is None), mname
        if tmean is not None:
            assert rel_err(tmean, np.asarray(jmean)) <= 1e-6, mname
    # The key tiles a slice walks (the reference fills and writes only
    # those); Q's residual is written for every row.
    walked = (tm.block_map != SKIP).any(dim=2)  # (Bm, Hm, nk)
    rows = walked.repeat_interleave(tm.block_k, dim=2)[..., :s]
    rows = rows.expand(b, hkv, s) if rows.shape[1] == 1 else rows[:, :: hq // hkv]
    for oname, jt, tt in zip("qkv", want[2:5], got[2:5]):
        if jt is None:
            assert tt is None and oname == "q"
            continue
        assert tt.block_size == jt.block_size and tt.mode.value == jt.mode.value, oname
        sel = slice(None) if oname == "q" else rows
        tc, jc = _codes(tt)[sel], _codes(jt)[sel]
        diff = (tc - jc).abs()
        assert int(diff.max()) <= 1 and float((diff == 0).double().mean()) >= 0.999, oname
        np.testing.assert_allclose(tt.scales[..., 0][sel].numpy(),
                                   np.asarray(jt.scales)[..., 0][sel.numpy() if oname != "q"
                                                                 else sel],
                                   rtol=1e-6, atol=0, err_msg=oname)
        if jt.zero_points is not None:
            zd = (tt.zero_points[..., 0][sel].to(torch.int64)
                  - torch.from_numpy(np.array(jt.zero_points))[..., 0][sel].to(torch.int64))
            assert int(zd.abs().max()) <= 1, oname


def test_fused_route_rules_under_a_map():
    """The reference's rules (quant_fused_attn.py:1413-1429): the whole
    fill schedule, no bias gradient, no per-head map under GQA."""
    _, tm, s = _build("causal")
    _, th, _ = _build("per_head_gqa")
    cfg = QuantizationConfig.from_mode_string("int8")
    kw = dict(causal=False, window=None, seq_q=s, num_heads=4, num_kv_heads=2)
    full = dict(block_map=tm.block_map, fetch_kv=tm.fetch_kv, hold_kv=tm.hold_kv,
                fill_kv=tm.fill_kv)
    assert fused_path_supported(cfg, s, 64, **full, **kw)
    assert not fused_path_supported(cfg, s, 64, **dict(full, fill_kv=None), **kw)
    assert not fused_path_supported(cfg, s, 64, **full, bias_grad=True, **kw)
    assert not fused_path_supported(cfg, s, 64, fetch_kv=tm.fetch_kv, **kw)
    per_head = dict(block_map=th.block_map, fetch_kv=th.fetch_kv, hold_kv=th.hold_kv,
                    fill_kv=th.fill_kv)
    assert not fused_path_supported(cfg, 256, 64, **per_head, **kw)
    assert fused_path_supported(cfg, 256, 64, **per_head, **dict(kw, num_kv_heads=4))


def test_quantized_flash_attention_refuses_a_bias_beside_a_block_mask():
    _, tm, s = _build("causal")
    q = torch.zeros(1, 1, s, 32)
    with pytest.raises(ValueError, match="either bias or block_mask"):
        quantized_flash_attention(q, q, q, torch.zeros(s, s), block_mask=tm)


def test_quantized_attention_takes_a_mask_mod_and_a_block_mask():
    """`attention()` under use_quantization("int8"): a mask_mod (auto-tiled
    on both sides) and a BlockMask go to the quantized route and match
    `umfa_tpu.attention(..., interpret=True)`."""
    q, k, v = _x(20, (1, 4, 256, 64)), _x(21, (1, 2, 256, 64), 0.5), _x(22, (1, 2, 256, 64))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jcfg = JQuantizationConfig.from_mode_string("int8")
    before = umfa_tpu_torch.get_dispatch_stats()["quantized_autograd"]
    for mask in (lambda i, j: (j <= i) & (j >= i - 100), "segments"):
        if mask == "segments":
            seg = _left_padded(256)[:1]
            jmask = jbm.segment_block_mask(jnp.asarray(seg), causal=True)
            tmask = umfa_tpu_torch.segment_block_mask(torch.from_numpy(seg), causal=True,
                                                      device="cpu")
        else:
            jmask = tmask = mask
        want, want_lse = umfa_tpu.attention(*(jnp.asarray(a) for a in (q, k, v)), jmask,
                                            quantization=jcfg, interpret=True, return_lse=True)
        with umfa_tpu_torch.use_quantization("int8"):
            got, got_lse = umfa_tpu_torch.attention(tq, tk, tv, tmask, return_lse=True)
        assert rel_err(got, np.asarray(want)) <= 1e-3
        want_lse = np.asarray(want_lse)
        vis = want_lse > -1e29
        assert np.abs(got_lse.numpy()[vis] - want_lse[vis]).max() <= 1e-3
        np.testing.assert_array_equal(got_lse.numpy()[~vis], want_lse[~vis])
    assert umfa_tpu_torch.get_dispatch_stats()["quantized_autograd"] == before + 2


def test_nan_check_recomputes_a_quantized_block_mask_call_with_its_walk(monkeypatch):
    """UMFA_NAN_CHECK's naive recompute of a quantized block-mask call keeps
    the walk: rows 0-199 of the left-padded batch see no key and average V
    over their walked keys (the tiles of rows 128-255), not over every key."""
    from umfa_tpu_torch import api
    from umfa_tpu_torch.engine import config as tcfg

    q, k, v = (torch.from_numpy(_x(s, (1, 2, 384, 32))) for s in (30, 31, 32))
    mask = tbm.segment_block_mask(torch.from_numpy(_left_padded(384)[:1]), causal=True,
                                  block_sizes=BlockSizes(128, 128), device="cpu")
    monkeypatch.setattr(tcfg, "NAN_CHECK", True)
    monkeypatch.setattr(api, "quantized_flash_attention",
                        lambda q, *a, **kw: (torch.full_like(q, float("nan")), None))
    before = umfa_tpu_torch.get_dispatch_stats()["naive_fallback"]
    with umfa_tpu_torch.use_quantization("int8"):
        out = umfa_tpu_torch.attention(q, k, v, mask)
    assert umfa_tpu_torch.get_dispatch_stats()["naive_fallback"] == before + 1
    np.testing.assert_allclose(out.numpy()[0, :, 128:200], np.broadcast_to(
        v.numpy()[0, :, 128:256].mean(axis=1)[:, None], (2, 72, 32)), atol=1e-5)
