"""Port parity: the continuous-batching scheduler and the decode loop it
drives (port of tests/test_scheduler.py).

The port's `ContinuousBatcher` runs in lockstep with the reference's and
must make the same admissions, masks and retirements. The device work of
each round (prefill of admitted requests into their slots through one-slot
cache views, one ragged decode step for every slot, `reset_slot` after the
step for retired slots) runs in both packages on the same numpy inputs;
JAX runs its kernels in interpret mode on the CPU.

Tolerances: decode_attention relerr <= 2e-5 in fp32 (gemv and flash-decode
routes alike, as tests/test_torch_serving.py); GPT logits atol 1e-4 in fp32
(as tests/test_torch_gpt.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umfa_tpu.models import gpt as jgpt
from umfa_tpu.serving import decode as jdecode
from umfa_tpu.serving import kv_cache as jkv
from umfa_tpu.serving import scheduler as jsched
from umfa_tpu_torch.models import gpt
from umfa_tpu_torch.serving import decode as tdecode
from umfa_tpu_torch.serving import kv_cache as tkv
from umfa_tpu_torch.serving.scheduler import ContinuousBatcher, reset_slot
from umfa_tpu_torch.utils.testing import rel_err


@pytest.mark.parametrize("schedule", ["fills_and_drains", "slot_reuse_order"])
def test_batcher_schedules(schedule):
    if schedule == "fills_and_drains":
        b = ContinuousBatcher(num_slots=4)
        for _ in range(10):
            b.submit(prompt_len=8, max_new_tokens=3)
        steps = 0
        while not b.idle:
            b.step()
            steps += 1
            assert steps < 100
        assert b.stats.completed == 10 and b.stats.admitted == 10
        # 10 jobs x 3 tokens over 4 slots need >= ceil(30/4) rounds.
        assert b.stats.mean_occupancy > 0.7
        return
    b = ContinuousBatcher(num_slots=2)
    first, second, third = b.submit(4, 1), b.submit(4, 5), b.submit(4, 1)
    admitted = []
    b.step(on_admit=lambda slot, req: admitted.append((slot, req.uid)))
    assert admitted == [(0, first), (1, second)]
    # first finishes after 1 token; third takes its slot next round.
    admitted.clear()
    b.step(on_admit=lambda slot, req: admitted.append((slot, req.uid)))
    assert admitted == [(0, third)]


def test_reset_slot_in_place_for_both_caches():
    for cache in (tkv.init_cache(3, 1, 8, 4, device="cpu"),
                  tkv.init_quantized_cache(3, 1, 8, 4, device="cpu")):
        cache.length = torch.tensor([5, 6, 7], dtype=torch.int32)
        assert reset_slot(cache, 1) is cache
        assert cache.length.tolist() == [5, 0, 7]


def _lockstep_batchers(requests):
    ours, ref = ContinuousBatcher(2), jsched.ContinuousBatcher(2)
    for prompt_len, new in requests:
        assert ours.submit(prompt_len, new) == ref.submit(prompt_len, new)
    return ours, ref


def _step_both(ours, ref, on_admit, on_retire):
    """One round of both batchers; the reference's callbacks only record,
    so each admission and retirement runs once, and must agree."""
    seen = {"ours": [], "ref": []}

    def rec(name, fn=None):
        def cb(slot, req):
            seen[name].append((slot, req.uid))
            if fn is not None:
                fn(slot, req)
        return cb

    mask = ours.step(rec("ours", on_admit), on_retire)
    ref_mask = ref.step(rec("ref"))
    assert np.array_equal(mask, ref_mask) and seen["ours"] == seen["ref"]
    assert dataclasses.asdict(ours.stats) == dataclasses.asdict(ref.stats)
    return mask


def _jslot(c, s):
    """The reference cache's slot s as an empty one-slot cache."""
    children, _ = c.tree_flatten()
    return type(c)(*[x[s:s + 1] for x in children[:-1]], jnp.zeros((1,), jnp.int32))


def _jput(c, s, sub, length):
    children, _ = c.tree_flatten()
    subs, _ = sub.tree_flatten()
    new = [x.at[s].set(y[0]) for x, y in zip(children[:-1], subs[:-1])]
    return type(c)(*new, children[-1].at[s].set(length))


def _tslot(c, s):
    """A one-slot view of the port's cache (writes land in the batch
    buffers), starting empty."""
    fields = {f.name: getattr(c, f.name)[s:s + 1] for f in dataclasses.fields(c)
              if f.name != "length"}
    return type(c)(**fields, length=torch.zeros((1,), dtype=torch.int32))


REQUESTS = [(40, 2), (300, 4), (17, 3)]


@pytest.mark.parametrize("switch", [False, True], ids=["gemv", "decode_kernel"])
@pytest.mark.parametrize("kind", ["dtype", "int8"])
def test_decode_loop_with_scheduler_matches_jax(monkeypatch, kind, switch):
    # 2 slots, 3 requests; S_max 768 gives the kernel route block_k 256
    # (three tiles) when the switch is on.
    hq, hkv, d, s_max = 4, 2, 64, 768
    if switch:
        monkeypatch.setenv("UMFA_ENABLE_DECODE_KERNEL", "1")
    rng = np.random.default_rng(0)
    if kind == "int8":
        jc = jkv.init_quantized_cache(2, hkv, s_max, d)
        tc = tkv.init_quantized_cache(2, hkv, s_max, d, device="cpu")
        japp, tapp = jkv.append_quantized, tkv.append_quantized
    else:
        jc = jkv.init_cache(2, hkv, s_max, d, jnp.float32)
        tc = tkv.init_cache(2, hkv, s_max, d, torch.float32, device="cpu")
        japp, tapp = jkv.append, tkv.append
    state = {"jc": jc}
    ours, ref = _lockstep_batchers(REQUESTS)

    def on_admit(slot, req):
        k = rng.normal(0, 1, (1, hkv, req.prompt_len, d)).astype(np.float32)
        v = rng.normal(0, 1, (1, hkv, req.prompt_len, d)).astype(np.float32)
        sub = japp(_jslot(state["jc"], slot), jnp.asarray(k), jnp.asarray(v))
        state["jc"] = _jput(state["jc"], slot, sub, req.prompt_len)
        tapp(_tslot(tc, slot), torch.from_numpy(k), torch.from_numpy(v))
        tc.length[slot] = req.prompt_len

    retired = []
    rounds = 0
    while not ours.idle:
        retired.clear()
        mask = _step_both(ours, ref, on_admit, lambda slot, req: retired.append(slot))
        k = rng.normal(0, 1, (2, hkv, 1, d)).astype(np.float32)
        v = rng.normal(0, 1, (2, hkv, 1, d)).astype(np.float32)
        q = rng.normal(0, 1, (2, hq, 1, d)).astype(np.float32)
        state["jc"] = japp(state["jc"], jnp.asarray(k), jnp.asarray(v))
        tapp(tc, torch.from_numpy(k), torch.from_numpy(v))
        assert tc.length.tolist() == np.asarray(state["jc"].length).tolist()
        want = np.asarray(jdecode.decode_attention(jnp.asarray(q), state["jc"], interpret=True))
        got = tdecode.decode_attention(torch.from_numpy(q), tc)
        assert torch.isfinite(got).all()
        assert rel_err(got[mask], want[mask]) <= 2e-5, rounds
        # The retiring slot decoded its last token this round; free it now.
        for slot in retired:
            state["jc"] = jsched.reset_slot(state["jc"], slot)
            reset_slot(tc, slot)
        rounds += 1
        assert rounds < 20
    assert ours.stats.completed == ours.stats.admitted == 3


JCFG = jgpt.GPTConfig(vocab=64, dim=128, num_heads=4, num_kv_heads=2, depth=2,
                      max_seq=256, interpret=True)
CFG = gpt.GPTConfig(vocab=64, dim=128, num_heads=4, num_kv_heads=2, depth=2, max_seq=256)


@pytest.mark.parametrize("kind", ["dtype", "int8"])
def test_gpt_continuous_batching_matches_jax(monkeypatch, kind):
    """Admissions prefill one slot through one-slot cache views; each round
    decodes a teacher-forced token for both slots at ragged lengths
    (uniform_pos=False); the flash-decode switch is on (S_max 256 takes
    the kernel route for the INT8 cache)."""
    monkeypatch.setenv("UMFA_ENABLE_DECODE_KERNEL", "1")
    routed = []
    flash_decode = tdecode.quantized_flash_decode
    monkeypatch.setattr(tdecode, "quantized_flash_decode",
                        lambda *a, **kw: routed.append(kw["block_k"]) or flash_decode(*a, **kw))
    jcfg = dataclasses.replace(JCFG, kv_cache=kind)
    cfg = dataclasses.replace(CFG, kv_cache=kind)
    jparams = jgpt.init_params(jax.random.PRNGKey(0), jcfg)
    model = gpt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    rng = np.random.default_rng(1)
    state = {"jc": jgpt.init_caches(jcfg, 2)}
    tc = gpt.init_caches(cfg, 2, device="cpu")
    ours, ref = _lockstep_batchers([(24, 3), (9, 5), (37, 2)])

    def on_admit(slot, req):
        prompt = rng.integers(0, cfg.vocab, (1, req.prompt_len))
        want, subs = jgpt.forward_with_cache(
            jparams, jnp.asarray(prompt), [_jslot(c, slot) for c in state["jc"]], jcfg,
            prefill=True)
        state["jc"] = [_jput(c, slot, s, req.prompt_len) for c, s in zip(state["jc"], subs)]
        got, _ = gpt.forward_with_cache(model, torch.from_numpy(prompt),
                                        [_tslot(c, slot) for c in tc], prefill=True)
        for c in tc:
            c.length[slot] = req.prompt_len
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)

    retired = []
    rounds = 0
    while not ours.idle:
        retired.clear()
        mask = _step_both(ours, ref, on_admit, lambda slot, req: retired.append(slot))
        tokens = rng.integers(0, cfg.vocab, (2, 1))
        want, state["jc"] = jgpt.forward_with_cache(jparams, jnp.asarray(tokens), state["jc"],
                                                    jcfg, uniform_pos=False)
        got, _ = gpt.forward_with_cache(model, torch.from_numpy(tokens), tc, uniform_pos=False)
        np.testing.assert_allclose(got.numpy()[mask], np.asarray(want)[mask], atol=1e-4, rtol=0,
                                   err_msg=f"round {rounds}")
        for slot in retired:
            state["jc"] = [jsched.reset_slot(c, slot) for c in state["jc"]]
            for c in tc:
                reset_slot(c, slot)
        rounds += 1
        assert rounds < 20
    assert ours.stats.completed == 3
    # One kernel call per layer per round with the INT8 cache, none dense.
    assert routed == ([256] * cfg.depth * rounds if kind == "int8" else [])
