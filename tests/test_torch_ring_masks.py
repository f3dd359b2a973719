"""The ring kernels' view of a step (`ring_pallas._step_mask`: the band
mask plus a first visible query row and a key limit, in local indices,
which the wrappers pass to `csrc/ring_attn.cu`) against the reference's
visibility by global position (`_Step.keep`, from `ring._global_positions`),
element by element, for every (rank, step) that the ring launches; and the
arguments the wrappers pass to the C entries (a fake entry records them),
with the limits the kernels take: any local chunk the reference's tile
asserts admit, head_dim <= 256 in bf16 and fp32."""

import contextlib
from types import SimpleNamespace

import pytest
import torch

from umfa_tpu_torch.parallel import ring_pallas as rp

S_LOC = 256
LAYOUTS = {"causal": (True, False), "zigzag": (True, True), "full": (False, False),
           "full_zigzag": (False, True)}
CASES = [
    (layout, n, my, step)
    for layout, (causal, zigzag) in LAYOUTS.items()
    for n in (1, 2, 3, 4, 8)
    for my in range(n)
    for step in range(n)
    if rp._visible(SimpleNamespace(n=n, self_loop=False),
                   rp._config(S_LOC, causal, zigzag, 0.125, None), my, step)
]


def _band(m: rp.StepMask, s_loc: int) -> torch.Tensor:
    """(s_loc, s_loc) bool: key j visible to query row i under the kernels'
    rule (csrc/fwd_tc.cuh and csrc/bwd_tc.cuh, RING)."""
    i = torch.arange(s_loc)[:, None]
    j = torch.arange(s_loc)[None, :]
    vis = (i >= m.q_lo) & (j < m.k_hi)
    if m.left >= 0:
        vis &= j >= i - m.left
    if m.right >= 0:
        vis &= j <= i + m.right
    return vis


@pytest.mark.parametrize("layout,n,my,step", CASES)
def test_step_mask_matches_global_positions(layout, n, my, step):
    causal, zigzag = LAYOUTS[layout]
    cfg = rp._config(S_LOC, causal, zigzag, 0.125, None)
    ring = SimpleNamespace(n=n, self_loop=False)
    c = rp._step(ring, cfg, my, step)
    m = rp._step_mask(c, S_LOC)
    keep = c.keep(S_LOC, "cpu")
    want = torch.ones((S_LOC, S_LOC), dtype=torch.bool) if keep is None else keep
    assert torch.equal(_band(m, S_LOC), want)
    assert 0 <= m.q_lo <= S_LOC and 0 <= m.k_hi <= S_LOC and m.left >= -1 and m.right >= -1


def test_step_mask_hides_everything_a_contiguous_rank_cannot_see():
    # The host launches no contiguous causal step with src > my; the mask
    # of such a step still hides every pair.
    c = rp._Step(4, 1, 3, False, True, False, 0.125, 64)
    assert not _band(rp._step_mask(c, S_LOC), S_LOC).any()
    assert not c.keep(S_LOC, "cpu").any()


def _fake_c_entry(monkeypatch, check_launch=False):
    """Record the C entry's calls in place of launching; the device checks
    (and, unless check_launch, every check) pass for CPU tensors."""
    calls = []

    def function(lib, symbol, argtypes):
        return lambda *args: calls.append((lib, symbol, len(argtypes), args)) or 0

    if check_launch:
        monkeypatch.setattr(rp, "_check_device", lambda *args: None)
    else:
        monkeypatch.setattr(rp, "_check_launch", lambda *args: None)
    monkeypatch.setattr(rp._kernels, "function", function)
    monkeypatch.setattr(rp._kernels, "check", lambda *args: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: SimpleNamespace(cuda_stream=7))
    return calls


def _operands(kernel, s_loc=S_LOC, d=64, dtype=torch.bfloat16):
    q, do = (torch.zeros((2, 4, s_loc, d), dtype=dtype) for _ in range(2))
    k, v = (torch.zeros((2, 2, s_loc, d), dtype=dtype) for _ in range(2))
    lse, delta = torch.zeros((2, 4, s_loc)), torch.zeros((2, 4, s_loc))
    if kernel == "ring_fwd_step":
        return q, k, v, torch.zeros_like(q), lse
    out0 = torch.zeros(k.shape if kernel == "ring_bwd_dkv" else q.shape)
    out1 = torch.zeros(k.shape) if kernel == "ring_bwd_dkv" else None
    return q, do, lse, delta, k, v, out0, out1


def _launch(kernel, operands, c):
    if kernel == "ring_fwd_step":
        rp._launch_fwd(*operands, c)
    else:
        rp._launch_bwd(kernel, *operands, c)


@pytest.mark.parametrize("kernel", ["ring_fwd_step", "ring_bwd_dkv", "ring_bwd_dq"])
def test_the_wrapper_passes_the_step_mask_to_the_c_entry(monkeypatch, kernel):
    # The C entries' argument lists (csrc/ring_attn.cu): the forward's 5
    # pointers, block_k, B, Hq, Hkv, S, D, scale, then left, right, q_lo,
    # k_hi, first, dtype and the stream; the backward's 8 pointers, B, Hq,
    # Hkv, S, D, scale, then the same from left on.
    calls = _fake_c_entry(monkeypatch)
    c = rp._Step(4, 1, 3, False, True, True, 0.125, 128)  # zigzag, src > my
    _launch(kernel, _operands(kernel), c)
    (lib, symbol, nargs, args), = calls
    mask = tuple(rp._step_mask(c, S_LOC))
    assert mask == (-1, -1, S_LOC // 2, S_LOC)
    if kernel == "ring_fwd_step":
        assert (lib, symbol, nargs, len(args)) == ("ring_attn", "umfa_ring_fwd_step", 19, 19)
        assert args[5:12] == (128, 2, 4, 2, S_LOC, 64, 0.125)
        assert args[12:16] == mask
        assert args[16:] == (0, 1, 7)
    else:
        assert (lib, symbol, nargs, len(args)) == ("ring_attn", f"umfa_{kernel}", 21, 21)
        assert args[8:14] == (2, 4, 2, S_LOC, 64, 0.125)
        assert args[14:18] == mask
        assert args[18:] == (0, 1, 7)


@pytest.mark.parametrize("layout,n,my,step", [c for c in CASES if c[1] == 4])
def test_the_forward_wrapper_passes_each_step_and_group(monkeypatch, layout, n, my, step):
    # Every launched step of a 4-rank ring: its mask, first flag and the
    # ring's block_k (the local chunk, halved under zigzag) reach the C entry.
    causal, zigzag = LAYOUTS[layout]
    calls = _fake_c_entry(monkeypatch)
    c = rp._step(SimpleNamespace(n=n, self_loop=False),
                 rp._config(S_LOC, causal, zigzag, 0.125, None), my, step)
    _launch("ring_fwd_step", _operands("ring_fwd_step"), c)
    (_, _, _, args), = calls
    assert args[5] == (S_LOC // 2 if zigzag else S_LOC)
    assert args[12:17] == (*rp._step_mask(c, S_LOC), int(step == 0))


@pytest.mark.parametrize("kernel", ["ring_fwd_step", "ring_bwd_dkv", "ring_bwd_dq"])
@pytest.mark.parametrize("zigzag", [False, True])
def test_the_ring_kernels_take_a_local_chunk_of_96(monkeypatch, kernel, zigzag):
    # S 384 over 4 ranks: what the reference's tile asserts admit
    # (`_check_tiles`: block_k and block_q 96, or 48 per zigzag half).
    cfg = rp._config(96, True, zigzag, 0.125, None)
    rp._check_tiles(96, cfg)
    calls = _fake_c_entry(monkeypatch, check_launch=True)
    c = rp._step(SimpleNamespace(n=4, self_loop=False), cfg, 2, 1)
    _launch(kernel, _operands(kernel, s_loc=96), c)
    (_, _, _, args), = calls
    if kernel == "ring_fwd_step":
        assert (args[5], args[9]) == (48 if zigzag else 96, 96)  # block_k, S
    else:
        assert args[11] == 96


@pytest.mark.parametrize("kernel", ["ring_fwd_step", "ring_bwd_dkv", "ring_bwd_dq"])
def test_the_ring_kernels_take_bf16_head_dim_256(monkeypatch, kernel):
    calls = _fake_c_entry(monkeypatch, check_launch=True)
    c = rp._Step(4, 3, 2, False, True, False, 0.0625, S_LOC)
    _launch(kernel, _operands(kernel, d=256), c)
    (_, _, _, args), = calls
    assert args[10 if kernel == "ring_fwd_step" else 12] == 256


@pytest.mark.parametrize("kernel", ["ring_fwd_step", "ring_bwd_dkv", "ring_bwd_dq"])
def test_the_ring_kernels_take_fp32_head_dim_256(monkeypatch, kernel):
    calls = _fake_c_entry(monkeypatch, check_launch=True)
    c = rp._Step(4, 3, 2, False, True, False, 0.0625, S_LOC)
    for d in (160, 256):
        _launch(kernel, _operands(kernel, d=d, dtype=torch.float32), c)
    assert [args[10 if kernel == "ring_fwd_step" else 12] for _, _, _, args in calls] == [160, 256]
    assert all(args[-2] == 0 for _, _, _, args in calls)  # the fp32 dtype code


@pytest.mark.parametrize("kernel", ["ring_fwd_step", "ring_bwd_dkv", "ring_bwd_dq"])
def test_the_ring_kernels_still_refuse_what_they_do_not_take(monkeypatch, kernel):
    calls = _fake_c_entry(monkeypatch, check_launch=True)
    c = rp._Step(4, 3, 2, False, True, False, 0.125, 64)
    with pytest.raises(ValueError, match="head_dim <= 256"):
        _launch(kernel, _operands(kernel, d=320), c)
    with pytest.raises(ValueError, match="head_dim <= 256"):
        _launch(kernel, _operands(kernel, d=264, dtype=torch.float32), c)
    zig = c._replace(zigzag=True, block_k=45)
    with pytest.raises(ValueError, match="even under zigzag"):
        _launch(kernel, _operands(kernel, s_loc=91), zig)
    if kernel == "ring_fwd_step":
        with pytest.raises(ValueError, match="block_k"):
            _launch(kernel, _operands(kernel, s_loc=96), c)  # 64 does not divide 96
    assert calls == []
