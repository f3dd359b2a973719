"""The ring backward kernels' view of a step (`ring_pallas._step_mask`: the
band mask plus a first visible query row and a key limit, in local indices,
which the wrapper passes to `csrc/ring_attn.cu`) against the reference's
visibility by global position (`_Step.keep`, from `ring._global_positions`),
element by element, for every (rank, step) that the ring launches."""

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
    rule (csrc/bwd_tc.cuh, RING)."""
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


@pytest.mark.parametrize("kernel", ["ring_bwd_dkv", "ring_bwd_dq"])
def test_the_wrapper_passes_the_step_mask_to_the_c_entry(monkeypatch, kernel):
    # The C entry's argument list (csrc/ring_attn.cu UMFA_RING_BWD_ARGS):
    # 8 pointers, B, Hq, Hkv, S, D, scale, then left, right, q_lo, k_hi,
    # first, dtype and the stream.
    calls = []

    def function(lib, symbol, argtypes):
        return lambda *args: calls.append((lib, symbol, len(argtypes), args)) or 0

    monkeypatch.setattr(rp, "_check_launch", lambda *args: None)
    monkeypatch.setattr(rp._kernels, "function", function)
    monkeypatch.setattr(rp._kernels, "check", lambda *args: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: SimpleNamespace(cuda_stream=7))
    q, do = (torch.zeros((2, 4, S_LOC, 64), dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.zeros((2, 2, S_LOC, 64), dtype=torch.bfloat16) for _ in range(2))
    lse, delta = torch.zeros((2, 4, S_LOC)), torch.zeros((2, 4, S_LOC))
    out0 = torch.zeros(k.shape if kernel == "ring_bwd_dkv" else q.shape)
    out1 = torch.zeros(k.shape) if kernel == "ring_bwd_dkv" else None
    c = rp._Step(4, 1, 3, False, True, True, 0.125, 128)  # zigzag, src > my
    rp._launch_bwd(kernel, q, do, lse, delta, k, v, out0, out1, c)
    (lib, symbol, nargs, args), = calls
    assert (lib, symbol, nargs, len(args)) == ("ring_attn", f"umfa_{kernel}", 21, 21)
    assert args[8:14] == (2, 4, 2, S_LOC, 64, 0.125)
    assert args[14:18] == tuple(rp._step_mask(c, S_LOC)) == (-1, -1, S_LOC // 2, S_LOC)
    assert args[18:] == (0, 1, 7)
