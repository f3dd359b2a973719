"""Ring attention with one kernel launch per rank and ring step, forward and
backward (port of umfa_tpu/parallel/ring_pallas.py; "pallas" in the names
marks the counterpart, not the implementation).

The reference's two ring kernels keep the rotation inside the kernel
(RDMA into a double-buffered comm buffer, semaphores for arrival and
capacity). On Hopper the copies between ranks happen outside the kernels:
the host loops below launch `csrc/ring_attn.cu`'s kernels for each rank
and step, and a transport of `parallel/transport.py` carries the hops.

  * Forward (`_ring_fwd`, the counterpart of `_ring_fwd_kernel`,
    ring_pallas.py:99): each rank stages its K/V into slot 0 of a
    (2 slots, 2 (k/v), B, Hkv, S_loc, D) buffer; at step s it sends slot
    s%2 to its right neighbour's other slot and runs `ring_fwd_step` on the
    chunk it holds, merging into its running (o, lse). Contiguous causal
    skips the steps a rank cannot see and the sends no later rank needs
    (n(n+1)/2 launches, n(n-1)/2 hops).
  * Backward (`_ring_bwd`, the counterpart of `_ring_bwd_kernel`, :529):
    K/V travel with an fp32 dK/dV buffer. At step s a rank folds its dK/dV
    contribution for the chunk it holds into the travelling buffer
    (`ring_bwd_dkv`), sends both buffers on, and accumulates its fp32 dQ
    (`ring_bwd_dq`). Every step below n - 1 sends, also under causal
    masking, because dK/dV must ride home; one homing hop to the right
    returns each chunk's dK/dV after the last step.
  * `UMFA_RING_BWD` other than "pallas" (read on every call) takes the
    reference's A/B route instead: a ring of the dense backward
    (ops/flash_bwd.py, rows 2-3) with step biases (:1127-1158).

All three kernels are the dense kernels' tensor-core bodies in ring mode
(the forward `csrc/fwd_tc.cuh`, the backward `csrc/bwd_tc.cuh`):
`_step_mask` reduces what a step sees by global position to their band
mask plus a first visible query row and a key limit, in local indices;
the forward merges into (o, lse), the backward folds into the fp32
buffers. They take head_dim <= 256 (bf16 and fp32), and any local chunk
the reference's tile asserts admit (`_check_tiles`). fp16 is storage-only,
as in the dense ops: `ring_flash_attention_pallas` computes it as fp32 and
casts the output back.

Rounding points held to the reference: the forward multiplies the fp32
dot by scale (:321-326) and rounds P to V's type against the running max
of block_k tiles, sums the unrounded P into l (:338-355), and stores o in
the output type after every step (:382-395); the backward pre-scales Q and
rounds it to the input type (:693), uses the final LSE, and takes δ from
the stored output (:955-960). Masked scores are -1e30, never -inf.

On CPU tensors every step runs its kernel's plain PyTorch version
(`_fwd_step_plain`, `_dkv_plain`, `_dq_plain`); on CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional

import torch
from torch.autograd.function import once_differentiable

from umfa_tpu_torch import _kernels
from umfa_tpu_torch.engine.config import ring_bwd_route
from umfa_tpu_torch.ops.attention import flash_attention
from umfa_tpu_torch.ops.flash_bwd import flash_attention_backward
from umfa_tpu_torch.ops.flash_fwd import DEFAULT_MASK_VALUE, _DTYPE_CODE, refuse_wide
from umfa_tpu_torch.parallel.ring import _global_positions
from umfa_tpu_torch.parallel.transport import SelfLoop
from umfa_tpu_torch.utils.device import default_device
from umfa_tpu_torch.utils.testing import rel_err

_P, _I = ctypes.c_void_p, ctypes.c_int
# q, k, v, o, lse; block_k; B, Hq, Hkv, S, D; scale; left, right, q_lo,
# k_hi, first, dtype; stream.
_FWD_ARGTYPES = (_P,) * 5 + (_I,) * 6 + (ctypes.c_float,) + (_I,) * 6 + (_P,)
# q, k, v, dout, lse, delta, out0, out1; B, Hq, Hkv, S, D; scale; left,
# right, q_lo, k_hi, first, dtype; stream.
_BWD_ARGTYPES = (_P,) * 8 + (_I,) * 5 + (ctypes.c_float,) + (_I,) * 6 + (_P,)


@dataclasses.dataclass(frozen=True)
class BlockSizes:
    """Tile requests of the reference's ring (its `BlockSizes` defaults);
    both are clamped to the local chunk, and halved for zigzag."""

    block_q: int = 512
    block_k: int = 2048


class _Config(NamedTuple):
    causal: bool
    zigzag: bool
    scale: float
    block_q: int
    block_k: int


class _Step(NamedTuple):
    """One rank's view of one ring step."""

    n: int
    my: int      # ring position of the rank (its Q chunk)
    src: int     # ring position of the K/V chunk it holds
    first: bool  # step 0: write instead of merge / accumulate
    causal: bool
    zigzag: bool
    scale: float
    block_k: int

    def keep(self, s_loc: int, device) -> Optional[torch.Tensor]:
        """(S_loc, S_loc) bool, key visible to query by global position;
        None when not causal."""
        if not self.causal:
            return None
        qpos = _global_positions(self.my, self.n, s_loc, self.zigzag, device)
        kpos = _global_positions(self.src, self.n, s_loc, self.zigzag, device)
        return kpos[None, :] <= qpos[:, None]


class StepMask(NamedTuple):
    """What one ring step sees, in local indices: key j is visible to query
    row i iff q_lo <= i, j < k_hi, j >= i - left (left >= 0) and
    j <= i + right (right >= 0); -1 leaves a side of the band open."""

    left: int
    right: int
    q_lo: int
    k_hi: int


def _step_mask(c: _Step, s_loc: int) -> StepMask:
    """The ring kernels' view of step c, equal to `c.keep(s_loc)`. Local
    positions increase with global ones inside a chunk (the two zigzag
    halves sit in order), so the diagonal step is local causal. Between two
    chunks, contiguous: the earlier chunk is wholly visible, the later one
    wholly hidden; zigzag: src < my sees the first half of src's keys from
    every row, src > my sees every key from the second half of my's rows."""
    full = StepMask(-1, -1, 0, s_loc)
    if not c.causal:
        return full
    if c.src == c.my:
        return full._replace(right=0)
    if not c.zigzag:
        return full if c.src < c.my else full._replace(k_hi=0)
    half = s_loc // 2
    return full._replace(k_hi=half) if c.src < c.my else full._replace(q_lo=half)


def _visible(ring, cfg: _Config, my: int, step: int) -> bool:
    """Whether rank `my` computes at `step` (ring_pallas.py:182-199)."""
    if ring.self_loop:
        return step == 0
    if cfg.causal and not cfg.zigzag:
        return (my - step) % ring.n <= my
    return True


def _fwd_senders(ring, cfg: _Config, step: int) -> set:
    """Ring positions that send their chunk at `step` in the forward: the
    chunk held at step s is useful to the right neighbour iff it attends
    it at s + 1 (ring_pallas.py:187-194)."""
    n = ring.n
    if step >= n - 1:
        return set()
    if ring.self_loop or not (cfg.causal and not cfg.zigzag):
        return set(range(n))
    return {r for r in range(n) if step <= r < n - 1}


def _bwd_senders(ring, step: int) -> set:
    return set(range(ring.n)) if step < ring.n - 1 else set()


def _step(ring, cfg: _Config, my: int, step: int) -> _Step:
    return _Step(ring.n, my, (my - step) % ring.n, step == 0, cfg.causal, cfg.zigzag,
                 cfg.scale, cfg.block_k)


# ---- the kernels and their plain versions -------------------------------

def _fold(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """(B, Hq, S, D) → (B, Hkv, g·S, D): the GQA group folded into rows."""
    b, hq, s, d = q.shape
    return q.reshape(b, hkv, hq // hkv * s, d)


def _fwd_step_plain(q, k, v, o, lse, c: _Step) -> None:
    """One forward step in plain PyTorch: attend the held chunk in block_k
    tiles with the online softmax, then merge into (o, lse) in place."""
    b, hq, s_loc, d = q.shape
    hkv = k.shape[1]
    keep = c.keep(s_loc, q.device)
    qf = _fold(q.float(), hkv)
    m = torch.full((b, hq, s_loc), DEFAULT_MASK_VALUE, device=q.device)
    l = torch.zeros((b, hq, s_loc), device=q.device)
    acc = torch.zeros((b, hq, s_loc, d), device=q.device)
    for k0 in range(0, s_loc, c.block_k):
        kt = k[:, :, k0:k0 + c.block_k].float()
        s = torch.matmul(qf, kt.transpose(-1, -2)).reshape(b, hq, s_loc, -1) * c.scale
        hidden = None if keep is None else ~keep[:, k0:k0 + c.block_k]
        if hidden is not None:
            s.masked_fill_(hidden, DEFAULT_MASK_VALUE)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        if hidden is not None:
            p.masked_fill_(hidden, 0.0)
        l = alpha * l + p.sum(dim=-1)
        pr = _fold(p.to(v.dtype).float(), hkv)  # P rounded to V's type
        pv = torch.matmul(pr, v[:, :, k0:k0 + c.block_k].float()).reshape(b, hq, s_loc, d)
        acc = acc * alpha[..., None] + pv
        m = m_new
    empty = l == 0.0
    l_safe = torch.where(empty, torch.ones_like(l), l)
    lse_step = torch.where(empty, torch.full_like(l, DEFAULT_MASK_VALUE), m + torch.log(l_safe))
    o_step = acc / l_safe[..., None]
    if c.first:
        o.copy_(o_step)
        lse.copy_(lse_step)
        return
    m2 = torch.maximum(lse, lse_step)
    w1 = torch.exp(lse - m2)
    w2 = torch.exp(lse_step - m2)
    denom = w1 + w2
    safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    o.copy_(o.float() * (w1 / safe)[..., None] + o_step * (w2 / safe)[..., None])
    lse.copy_(m2 + torch.log(safe))


def _p_ds_plain(q, do, lse, delta, k, v, c: _Step):
    """Recomputed P and dS = P∘(dP − δ) of one step, fp32 (B, Hq, S, S)."""
    b, hq, s_loc, d = q.shape
    hkv = k.shape[1]
    keep = c.keep(s_loc, q.device)
    qs = (q.float() * c.scale).to(q.dtype).float()  # Q pre-scaled and rounded
    s = torch.matmul(_fold(qs, hkv), k.float().transpose(-1, -2)).reshape(b, hq, s_loc, s_loc)
    if keep is not None:
        s.masked_fill_(~keep, DEFAULT_MASK_VALUE)
    p = s.sub_(lse[..., None]).exp_()
    if keep is not None:
        p.masked_fill_(~keep, 0.0)
    dp = torch.matmul(_fold(do.float(), hkv), v.float().transpose(-1, -2))
    ds = dp.reshape(b, hq, s_loc, s_loc).sub_(delta[..., None]).mul_(p)
    return p, ds


def _dkv_plain(q, do, lse, delta, k, v, dk, dv, c: _Step) -> None:
    """Fold this rank's dK·scale and dV for the held chunk (GQA group
    summed) into the travelling fp32 buffers: replace at step 0, add after."""
    hkv = k.shape[1]
    p, ds = _p_ds_plain(q, do, lse, delta, k, v, c)
    pr = _fold(p.to(v.dtype).float(), hkv)
    del p
    dv_s = torch.matmul(pr.transpose(-1, -2), _fold(do.float(), hkv))
    del pr
    dsr = _fold(ds.to(q.dtype).float(), hkv)
    del ds
    dk_s = torch.matmul(dsr.transpose(-1, -2), _fold(q.float(), hkv)).mul_(c.scale)
    if c.first:
        dk.copy_(dk_s)
        dv.copy_(dv_s)
    else:
        dk.add_(dk_s)
        dv.add_(dv_s)


def _dq_plain(q, do, lse, delta, k, v, dq, c: _Step) -> None:
    """Accumulate scale·round(dS)·K for the held chunk into the fp32 dQ."""
    b, hq, s_loc, d = q.shape
    hkv = k.shape[1]
    _, ds = _p_ds_plain(q, do, lse, delta, k, v, c)
    dsr = _fold(ds.to(k.dtype).float(), hkv)
    del ds
    dq_s = torch.matmul(dsr, k.float()).mul_(c.scale).reshape(b, hq, s_loc, d)
    if c.first:
        dq.copy_(dq_s)
    else:
        dq.add_(dq_s)


def _check_device(kernel: str, tensors) -> None:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{kernel} kernel needs every operand on one CUDA device, "
                         f"got {sorted({str(t.device) for t in tensors})}")


def _check_launch(kernel: str, tensors, q: torch.Tensor, k: torch.Tensor, c: _Step) -> None:
    _check_device(kernel, tensors)
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{kernel} kernel needs contiguous operands")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype:
        raise ValueError(f"{kernel} kernel takes float32 or bfloat16 q/k/v, got {q.dtype}/{k.dtype}")
    b, hq, s_loc, d = q.shape
    hkv = k.shape[1]
    if d < 1:
        raise ValueError(f"{kernel} kernel takes head_dim >= 1, got {d}")
    refuse_wide(f"the {kernel} kernel", d)
    if hkv < 1 or hq % hkv:
        raise ValueError(f"q heads {hq} must be a multiple of kv heads {hkv}")
    if s_loc < 1 or (c.zigzag and s_loc % 2):
        raise ValueError(f"{kernel} kernel needs a local chunk ({s_loc}) of at least one row"
                         f"{', even under zigzag (two halves)' if c.zigzag else ''}")


def ring_fwd_step(q, k, v, o, lse, c: _Step) -> None:
    """One rank's forward step against the chunk (k, v) it holds, merged
    into (o, lse) in place: the `ring_fwd_step` kernel on CUDA tensors, its
    plain version on CPU tensors."""
    if q.device.type == "cpu":
        _fwd_step_plain(q, k, v, o, lse, c)
    else:
        _launch_fwd(q, k, v, o, lse, c)


def _launch_fwd(q, k, v, o, lse, c: _Step) -> None:
    _check_launch("ring_fwd_step", (q, k, v, o, lse), q, k, c)
    s_loc = q.shape[2]
    if not 1 <= c.block_k <= s_loc or s_loc % c.block_k:
        raise ValueError(f"ring_fwd_step kernel needs block_k ({c.block_k}) to divide the "
                         f"local chunk ({s_loc})")
    if o.dtype != q.dtype or lse.dtype != torch.float32:
        raise ValueError(f"ring_fwd_step kernel stores o in q's type {q.dtype} and an fp32 "
                         f"lse, got {o.dtype} and {lse.dtype}")
    fn = _kernels.function("ring_attn", "umfa_ring_fwd_step", _FWD_ARGTYPES)
    b, hq, _, d = q.shape
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                 c.block_k, b, hq, k.shape[1], s_loc, d, c.scale, *_step_mask(c, s_loc),
                 int(c.first), _DTYPE_CODE[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    _kernels.check("ring_attn", err, "ring_fwd_step")


def _launch_bwd(kernel: str, q, do, lse, delta, k, v, out0, out1, c: _Step) -> None:
    outs = (out0,) if out1 is None else (out0, out1)
    _check_launch(kernel, (q, do, lse, delta, k, v, *outs), q, k, c)
    if do.dtype != q.dtype or any(t.dtype != torch.float32 for t in (lse, delta, *outs)):
        raise ValueError(f"{kernel} kernel takes dO in q's type and fp32 lse, delta and outputs")
    fn = _kernels.function("ring_attn", f"umfa_{kernel}", _BWD_ARGTYPES)
    b, hq, s_loc, d = q.shape
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), out0.data_ptr(), 0 if out1 is None else out1.data_ptr(),
                 b, hq, k.shape[1], s_loc, d, c.scale, *_step_mask(c, s_loc), int(c.first),
                 _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _kernels.check("ring_attn", err, kernel)


def ring_bwd_dkv(q, do, lse, delta, k, v, dk, dv, c: _Step) -> None:
    """Fold one rank's dK/dV for the held chunk into the travelling fp32
    buffers (dk, dv): the `ring_bwd_dkv` kernel on CUDA tensors, its plain
    version on CPU tensors."""
    if q.device.type == "cpu":
        _dkv_plain(q, do, lse, delta, k, v, dk, dv, c)
    else:
        _launch_bwd("ring_bwd_dkv", q, do, lse, delta, k, v, dk, dv, c)


def ring_bwd_dq(q, do, lse, delta, k, v, dq, c: _Step) -> None:
    """Accumulate one rank's dQ against the held chunk into the fp32 dq:
    the `ring_bwd_dq` kernel on CUDA tensors, its plain version on CPU
    tensors."""
    if q.device.type == "cpu":
        _dq_plain(q, do, lse, delta, k, v, dq, c)
    else:
        _launch_bwd("ring_bwd_dq", q, do, lse, delta, k, v, dq, None, c)


# ---- host loops ----------------------------------------------------------

def _check_tiles(s_loc: int, cfg: _Config) -> None:
    """The reference's forward tile asserts (ring_pallas.py:446-453)."""
    if s_loc % cfg.block_k or s_loc % cfg.block_q:
        raise ValueError("the ring requires the local shard divisible by the tile sizes "
                         f"(S_loc {s_loc}, block_q {cfg.block_q}, block_k {cfg.block_k})")
    if cfg.zigzag and ((s_loc // 2) % cfg.block_q or (s_loc // 2) % cfg.block_k):
        raise ValueError("zigzag halves must align with tiles")


def _stage(ring, ks, vs) -> list:
    """Each local rank's (2 slots, 2 (k/v), B, Hkv, S_loc, D) buffer with
    its own K/V in slot 0; starts the transport."""
    kvbuf = ring.buffers((2, 2, *ks[0].shape), ks[0].dtype, ks[0].device)
    ring.start(ks[0].device)
    for i, (kc, vc) in enumerate(zip(ks, vs)):
        kvbuf[i][0, 0].copy_(kc)
        kvbuf[i][0, 1].copy_(vc)
        ring.computed(i, 0)
    return kvbuf


def _ring_fwd(q, k, v, ring, cfg: _Config, plain: bool = False):
    """Forward ring. Returns (out, lse) in the layout of q. plain=True runs
    the kernels' plain versions whatever the device."""
    qs, ks, vs = ring.shard(q), ring.shard(k), ring.shard(v)
    b, hq, s_loc, d = qs[0].shape
    _check_tiles(s_loc, cfg)
    step_fn = _fwd_step_plain if plain else ring_fwd_step
    kvbuf = _stage(ring, ks, vs)
    outs = [torch.empty_like(x) for x in qs]
    lses = [torch.empty((b, hq, s_loc), device=q.device) for _ in qs]
    for step in range(ring.n):
        cur, nxt = step % 2, (step + 1) % 2
        for i in range(len(ring.ranks)):
            ring.wait(i, cur)
        # The send starts before the step's compute, which it overlaps.
        ring.send(kvbuf, cur, nxt, _fwd_senders(ring, cfg, step), "fwd_kv")
        for i, my in enumerate(ring.ranks):
            if _visible(ring, cfg, my, step):
                step_fn(qs[i], kvbuf[i][cur, 0], kvbuf[i][cur, 1], outs[i], lses[i],
                        _step(ring, cfg, my, step))
                ring.computed(i, cur)
    ring.finish()
    return ring.unshard(outs), ring.unshard(lses)


def _delta(out, do, dlse):
    """δ = rowsum(dO∘O) − dlse in fp32 (ring_pallas.py:955-960)."""
    delta = (do.float() * out.float()).sum(dim=-1)
    return delta if dlse is None else delta - dlse.float()


def _ring_bwd(q, k, v, out, lse, do, dlse, ring, cfg: _Config, plain: bool = False):
    """Backward ring with travelling fp32 dK/dV. Returns fp32 (dq, dk, dv)
    in the layouts of q and k. plain=True runs the kernels' plain versions
    whatever the device."""
    qs, ks, vs = ring.shard(q), ring.shard(k), ring.shard(v)
    dos = ring.shard(do.to(q.dtype))
    lses = ring.shard(lse.float())
    deltas = ring.shard(_delta(out, do, dlse))
    b, hq, s_loc, d = qs[0].shape
    hkv = ks[0].shape[1]
    block = min(cfg.block_q, cfg.block_k)
    if s_loc % block:  # the reference's backward assert (ring_pallas.py:951)
        raise ValueError(f"the ring backward needs the local shard ({s_loc}) divisible by "
                         f"its block ({block})")
    dkv_fn, dq_fn = (_dkv_plain, _dq_plain) if plain else (ring_bwd_dkv, ring_bwd_dq)
    dkvbuf = ring.buffers((2, 2, b, hkv, s_loc, d), torch.float32, k.device)
    kvbuf = _stage(ring, ks, vs)
    dqs = [torch.empty((b, hq, s_loc, d), device=q.device) for _ in qs]
    for step in range(ring.n):
        cur, nxt = step % 2, (step + 1) % 2
        visible = [(i, my) for i, my in enumerate(ring.ranks) if _visible(ring, cfg, my, step)]
        for i in range(len(ring.ranks)):
            ring.wait(i, cur)
        for i, my in visible:
            kc, vc = kvbuf[i][cur, 0], kvbuf[i][cur, 1]
            dkv_fn(qs[i], dos[i], lses[i], deltas[i], kc, vc, dkvbuf[i][cur, 0],
                   dkvbuf[i][cur, 1], _step(ring, cfg, my, step))
            ring.computed(i, cur)
        # Both buffers leave after the dK/dV fold and overlap the dQ pass.
        senders = _bwd_senders(ring, step)
        ring.send(kvbuf, cur, nxt, senders, "bwd_kv")
        ring.send(dkvbuf, cur, nxt, senders, "bwd_dkv")
        for i, my in visible:
            dq_fn(qs[i], dos[i], lses[i], deltas[i], kvbuf[i][cur, 0], kvbuf[i][cur, 1], dqs[i],
                  _step(ring, cfg, my, step))
            ring.computed(i, cur)
    ring.finish()
    # After n - 1 rotations slot (n-1)%2 holds chunk (my+1)%n's dK/dV: one
    # hop to the right takes them home (none in the self-loop).
    dkv = [buf[(ring.n - 1) % 2] for buf in dkvbuf]
    if ring.n > 1 and not ring.self_loop:
        dkv = ring.shift(dkv, "bwd_home")
    dk = ring.unshard([x[0] for x in dkv])
    dv = ring.unshard([x[1] for x in dkv])
    return ring.unshard(dqs), dk, dv


def _ring_bwd_dense(q, k, v, out, lse, do, dlse, ring, cfg: _Config):
    """The reference's UMFA_RING_BWD=jnp route (ring_pallas.py:1127-1158):
    a ring of the dense backward with step biases; fp32 results."""
    n = ring.n
    qs, outs, lses, dos = (ring.shard(x) for x in (q, out, lse, do))
    dlses = ring.shard(dlse) if dlse is not None else [None] * len(qs)
    s_loc = qs[0].shape[2]
    dqs = [torch.zeros(x.shape, device=x.device) for x in qs]
    kv = [torch.stack([kc.float(), vc.float(), torch.zeros_like(kc, dtype=torch.float32),
                       torch.zeros_like(vc, dtype=torch.float32)])
          for kc, vc in zip(ring.shard(k), ring.shard(v))]
    for step in range(n):
        for i, my in enumerate(ring.ranks):
            src = (my - step) % n
            bias = None
            if cfg.causal:
                qpos = _global_positions(my, n, s_loc, cfg.zigzag, q.device)
                kpos = _global_positions(src, n, s_loc, cfg.zigzag, q.device)
                bias = torch.where(kpos[None, :] <= qpos[:, None], 0.0,
                                   DEFAULT_MASK_VALUE).float()[None, None]
            kc, vc = kv[i][0].to(k.dtype), kv[i][1].to(v.dtype)
            dq_s, dk_s, dv_s = flash_attention_backward(
                qs[i], kc, vc, outs[i], lses[i], dos[i], bias, dlses[i],
                causal=False, scale=cfg.scale)
            dqs[i] += dq_s
            kv[i][2] += dk_s
            kv[i][3] += dv_s
        if step != n - 1:
            kv = ring.shift(kv, "dense_kv")
    # dK/dV accumulated while travelling; one final hop returns them home.
    kv = ring.shift(kv, "dense_kv")
    return (ring.unshard(dqs), ring.unshard([x[2] for x in kv]),
            ring.unshard([x[3] for x in kv]))


class _RingAttention(torch.autograd.Function):
    """(q, k, v) → (out, lse) over a ring, both differentiable: a cotangent
    on LSE folds into δ."""

    @staticmethod
    def forward(ctx, q, k, v, ring, cfg):
        out, lse = _ring_fwd(q, k, v, ring, cfg)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring, ctx.cfg = ring, cfg
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    @once_differentiable
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g_out is None:  # every rank runs the same ring, cotangent or not
            g_out = torch.zeros_like(out)
        if ring_bwd_route() == "pallas":
            dq, dk, dv = _ring_bwd(q, k, v, out, lse, g_out, g_lse, ctx.ring, ctx.cfg)
        else:
            dq, dk, dv = _ring_bwd_dense(q, k, v, out, lse, g_out, g_lse, ctx.ring, ctx.cfg)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def _config(s_loc: int, causal: bool, zigzag: bool, scale, block_sizes) -> _Config:
    """The reference's tile rule (ring_pallas.py:1053-1058)."""
    bs = block_sizes or BlockSizes()
    block_q, block_k = min(bs.block_q, s_loc), min(bs.block_k, s_loc)
    if zigzag:
        block_q, block_k = min(block_q, s_loc // 2), min(block_k, s_loc // 2)
    return _Config(causal, zigzag, float(scale), block_q, block_k)


def ring_flash_attention_pallas(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    ring,
    causal: bool = False,
    zigzag: bool = False,
    scale: Optional[float] = None,
    block_sizes: Optional[BlockSizes] = None,
    return_lse: bool = False,
):
    """Differentiable ring attention over the ranks of `ring`
    (`parallel/transport.py`). q: (B, Hq, S, D); k, v: (B, Hkv, S, D), the
    sequence in contiguous ring chunks or, with zigzag=True, in
    `zigzag_shard`'s layout. With `LocalRing(n)` the tensors hold all n
    chunks, with `DistRing` this process's chunk. Returns out (q's type)
    and, with return_lse=True, the fp32 LSE (B, Hq, S). fp16 inputs are
    computed as fp32 and the output cast back (the gradients flow through
    the casts)."""
    if q.dtype == torch.float16:
        out, lse = ring_flash_attention_pallas(
            q.float(), k.float(), v.float(), ring=ring, causal=causal, zigzag=zigzag, scale=scale,
            block_sizes=block_sizes, return_lse=True)
        out = out.to(torch.float16)
        return (out, lse) if return_lse else out
    s_loc = q.shape[2] // len(ring.ranks)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    cfg = _config(s_loc, causal, zigzag, scale, block_sizes)
    out, lse = _RingAttention.apply(q, k, v, ring, cfg)
    return (out, lse) if return_lse else out


# ---- one-device protocol checks -----------------------------------------

def _selfloop_inputs(shapes, dtype, seed, device):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen).to(device, dtype) for s in shapes]


def ring_pallas_selfloop_check(
    *,
    batch: int = 1,
    heads: int = 2,
    seq: int = 1024,
    head_dim: int = 128,
    n_steps: int = 4,
    causal: bool = True,
    dtype=torch.bfloat16,
    seed: int = 0,
    device=None,
):
    """The forward ring for `n_steps` steps on one rank that sends its own
    chunk to itself (ring_pallas.py:1164-1222): only step 0 computes, so
    the output must match single-device `flash_attention`, while every step
    below n_steps - 1 makes a hop. Returns (rel_err, ring_out, dense_out);
    raises AssertionError on a parity or hop-count failure."""
    dev = default_device(device)
    shape = (batch, heads, seq, head_dim)
    q, k, v = _selfloop_inputs([shape] * 3, dtype, seed, dev)
    block = min(1024, seq)
    ring = SelfLoop(n_steps)
    out, _ = _ring_fwd(q, k, v, ring, _Config(causal, False, head_dim**-0.5, block, block))
    with torch.no_grad():
        want = flash_attention(q, k, v, causal=causal)
    rel = rel_err(out, want)
    if ring.hops["fwd_kv"] != n_steps - 1:
        raise AssertionError(f"self-loop ring made {ring.hops['fwd_kv']} hops, "
                             f"expected {n_steps - 1}")
    if not rel < 5e-3:
        raise AssertionError(f"self-loop ring parity failed: rel={rel}")
    return rel, out, want


def ring_pallas_selfloop_bwd_check(
    *,
    batch: int = 1,
    heads: int = 2,
    seq: int = 1024,
    head_dim: int = 128,
    n_steps: int = 4,
    causal: bool = True,
    dtype=torch.bfloat16,
    seed: int = 0,
    device=None,
):
    """The backward ring for `n_steps` steps on one self-sending rank
    (ring_pallas.py:1225-1293): only step 0 computes, so (dq, dk, dv) must
    match the gradients of single-device `flash_attention`, while K/V and
    dK/dV each make n_steps - 1 hops. Returns the largest rel_err of the
    three; raises AssertionError on a parity or hop-count failure."""
    dev = default_device(device)
    shape = (batch, heads, seq, head_dim)
    q, k, v, do = _selfloop_inputs([shape] * 4, dtype, seed, dev)
    with torch.no_grad():
        out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    block = min(1024, seq)
    ring = SelfLoop(n_steps)
    got = _ring_bwd(q, k, v, out, lse, do, None, ring,
                    _Config(causal, False, head_dim**-0.5, block, block))
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    dense = flash_attention(*leaves, causal=causal)
    (dense.float() * do.float()).sum().backward()
    worst = max(rel_err(a, x.grad) for a, x in zip(got, leaves))
    hops = (ring.hops["bwd_kv"], ring.hops["bwd_dkv"], ring.hops["bwd_home"])
    if hops != (n_steps - 1, n_steps - 1, 0):
        raise AssertionError(f"self-loop ring backward made (kv, dkv, home) hops {hops}, "
                             f"expected {(n_steps - 1, n_steps - 1, 0)}")
    if not worst < 2e-2:
        raise AssertionError(f"self-loop ring bwd parity failed: rel={worst}")
    return worst
