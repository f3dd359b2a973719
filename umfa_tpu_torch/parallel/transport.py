"""Ring transports: the port's counterpart of the `"sp"` mesh axis,
`jax.lax.ppermute` and the ring kernels' RDMA semaphores
(umfa_tpu/parallel/ring_pallas.py:208-265, :404-437).

On Hopper the copies between ranks happen outside the kernels: the host
loops of `ring_pallas.py` launch one kernel per rank and ring step and ask
a transport for the hops between them. Three transports share one small
interface:

  * `LocalRing(n)`: n virtual ranks in one process on one device, stepped
    in lockstep. Each rank owns its buffers; a hop is a real device copy
    into the right neighbour's other slot, issued on a side stream. CUDA
    events take the place of the receive semaphore (a rank's next step
    waits for the copy into its slot) and of the capacity semaphore (a copy
    into slot `nxt` of rank r waits until rank r's last kernel on that slot
    has finished). On CPU tensors the same code copies in program order.
  * `SelfLoop(n_steps)`: one rank whose left and right neighbour is itself,
    the counterpart of the reference's one-chip protocol check (only step 0
    computes; every step below n - 1 sends slot cur to its own slot nxt).
  * `DistRing(group)`: one rank per process through `torch.distributed`.
    A hop is a paired `isend`/`irecv` into the free slot
    (`batch_isend_irecv`), so a matched receive plays the part of the
    capacity credit. Backend-agnostic (gloo on CPU tensors, NCCL on cards).

Every rank runs the same host program in the same order, so there is no
collective-id counter (the reference's 8-slot wrap, ring_pallas.py:67-96,
has no counterpart). `hops` counts the copies by tag.
"""

from __future__ import annotations

import collections
from typing import Optional, Sequence

import torch


class _Ring:
    """What the ring host loops need of a transport. `ranks` are the
    global ring positions this process drives, in the order of the lists
    that `shard` returns and the buffer lists take."""

    n: int
    ranks: tuple
    self_loop = False

    def __init__(self):
        self.hops: collections.Counter = collections.Counter()

    def left(self, r: int) -> int:
        return (r - 1) % self.n

    def right(self, r: int) -> int:
        return (r + 1) % self.n

    def shard(self, x: torch.Tensor, dim: int = 2) -> list:
        """This process's chunks of a sequence-sharded tensor."""
        return [x]

    def unshard(self, xs: Sequence[torch.Tensor], dim: int = 2) -> torch.Tensor:
        return xs[0]

    def buffers(self, shape, dtype, device) -> list:
        """One uninitialised communication buffer per local rank."""
        return [torch.empty(shape, dtype=dtype, device=device) for _ in self.ranks]

    def start(self, device) -> None:
        """Called before a ring's first hop."""

    def send(self, bufs: list, cur: int, nxt: int, senders, tag: str) -> None:
        """Start the hops of one step: every rank in `senders` sends
        bufs[.][cur] to its right neighbour's bufs[.][nxt]."""
        raise NotImplementedError

    def wait(self, i: int, slot: int) -> None:
        """Order local rank i's next kernel after the arrival into its
        `slot`."""

    def computed(self, i: int, slot: int) -> None:
        """Local rank i has issued a kernel that reads or writes its `slot`."""

    def finish(self) -> None:
        """Join every outstanding hop."""

    def shift(self, xs: Sequence[torch.Tensor], tag: str, reverse: bool = False) -> list:
        """Each rank's tensor to its right neighbour (left with reverse),
        in new tensors: the counterpart of ppermute."""
        raise NotImplementedError


class LocalRing(_Ring):
    """n virtual ranks on one device (see the module docstring)."""

    def __init__(self, n: int):
        super().__init__()
        if n < 1:
            raise ValueError(f"a ring needs at least one rank, got {n}")
        self.n = n
        self.ranks = tuple(range(n))
        self._side: Optional[torch.cuda.Stream] = None
        self._done: list = []
        self._arrived: list = []

    def shard(self, x, dim=2):
        if x.shape[dim] % self.n:
            raise ValueError(f"sequence length {x.shape[dim]} is not divisible by {self.n} ranks")
        return [c.contiguous() for c in torch.chunk(x, self.n, dim=dim)]

    def unshard(self, xs, dim=2):
        return torch.cat(list(xs), dim=dim)

    def _index(self, r: int) -> int:
        return self.ranks.index(r)

    def start(self, device) -> None:
        device = torch.device(device)
        if device.type != "cuda":
            self._side = None
            return
        if self._side is None or self._side.device != device:
            self._side = torch.cuda.Stream(device)
        # The side stream's writes may land in memory that the compute
        # stream used for earlier tensors: order them after all of it.
        self._side.wait_stream(torch.cuda.current_stream(device))
        k = len(self.ranks)
        self._done = [[torch.cuda.Event(), torch.cuda.Event()] for _ in range(k)]
        self._arrived = [[None, None] for _ in range(k)]

    def send(self, bufs, cur, nxt, senders, tag):
        for r in self.ranks:
            if r not in senders:
                continue
            i, j = self._index(r), self._index(self.right(r))
            if self._side is None:
                bufs[j][nxt].copy_(bufs[i][cur])
            else:
                # Capacity: the receiver's last kernel on slot nxt is done;
                # the sender's slot cur holds what its kernels wrote.
                self._side.wait_event(self._done[j][nxt])
                self._side.wait_event(self._done[i][cur])
                with torch.cuda.stream(self._side):
                    bufs[j][nxt].copy_(bufs[i][cur])
                ev = torch.cuda.Event()
                ev.record(self._side)
                self._arrived[j][nxt] = ev
            self.hops[tag] += 1

    def wait(self, i, slot):
        if self._side is not None and self._arrived[i][slot] is not None:
            torch.cuda.current_stream(self._side.device).wait_event(self._arrived[i][slot])
            self._arrived[i][slot] = None

    def computed(self, i, slot):
        if self._side is not None:
            self._done[i][slot].record(torch.cuda.current_stream(self._side.device))

    def finish(self):
        if self._side is not None:
            torch.cuda.current_stream(self._side.device).wait_stream(self._side)

    def shift(self, xs, tag, reverse=False):
        src = self.right if reverse else self.left
        out = [xs[self._index(src(r))].clone() for r in self.ranks]
        self.hops[tag] += len(out)
        return out


class SelfLoop(LocalRing):
    """One rank that is its own left and right neighbour, for `n_steps`
    ring steps (ring_pallas.py:149-160)."""

    self_loop = True

    def __init__(self, n_steps: int):
        super().__init__(n_steps)
        self.ranks = (0,)

    def left(self, r):
        return r

    def right(self, r):
        return r

    def shard(self, x, dim=2):
        return [x.contiguous()]

    def unshard(self, xs, dim=2):
        return xs[0]

    def shift(self, xs, tag, reverse=False):
        self.hops[tag] += 1
        return [xs[0].clone()]


class DistRing(_Ring):
    """One rank per process of `group` (the default group when None)."""

    def __init__(self, group=None):
        super().__init__()
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("DistRing needs torch.distributed.init_process_group first")
        self._dist = dist
        self.group = group
        self.n = dist.get_world_size(group)
        self.ranks = (dist.get_rank(group),)
        self._pending: list = []

    def _peer(self, r: int) -> int:
        """The global rank of ring position r, as isend/irecv take it."""
        if self.group is None:
            return r
        return self._dist.get_global_rank(self.group, r)

    def _exchange(self, send_t, dst: Optional[int], recv_t, src: Optional[int]) -> list:
        dist = self._dist
        ops = []
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, send_t, self._peer(dst), self.group))
        if src is not None:
            ops.append(dist.P2POp(dist.irecv, recv_t, self._peer(src), self.group))
        return dist.batch_isend_irecv(ops) if ops else []

    def send(self, bufs, cur, nxt, senders, tag):
        my = self.ranks[0]
        dst = self.right(my) if my in senders else None
        src = self.left(my) if self.left(my) in senders else None
        self._pending += self._exchange(bufs[0][cur], dst, bufs[0][nxt], src)
        if dst is not None:
            self.hops[tag] += 1

    def wait(self, i, slot):
        self.finish()

    def finish(self):
        for req in self._pending:
            req.wait()
        self._pending = []

    def shift(self, xs, tag, reverse=False):
        my = self.ranks[0]
        dst, src = (self.left(my), self.right(my)) if reverse else (self.right(my), self.left(my))
        x = xs[0].contiguous()
        out = torch.empty_like(x)
        if self.n == 1:
            out.copy_(x)
        else:
            for req in self._exchange(x, dst, out, src):
                req.wait()
        self.hops[tag] += 1
        return [out]


class _PPermute(torch.autograd.Function):
    """Rotate one tensor per local rank one position to the right; the
    backward rotates the cotangents to the left, as JAX's ppermute
    transpose does."""

    @staticmethod
    def forward(ctx, ring, *xs):
        ctx.ring = ring
        return tuple(ring.shift(xs, "ppermute"))

    @staticmethod
    def backward(ctx, *gs):
        return (None, *ctx.ring.shift(gs, "ppermute_grad", reverse=True))


def ppermute(xs: Sequence[torch.Tensor], ring: _Ring) -> list:
    """Differentiable rotation of `xs` (one tensor per local rank of
    `ring`) to the right neighbours."""
    return list(_PPermute.apply(ring, *xs))
