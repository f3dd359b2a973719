"""`DistRing` (one rank per process, torch.distributed) against `LocalRing`
(four virtual ranks in one process) on the same inputs: four processes
with the gloo backend on CPU tensors run the ring forward and backward on
their own shards, contiguous causal and zigzag causal, and every rank's
out, LSE and dQ/dK/dV must equal the matching chunk of the LocalRing run.

Both run the same plain PyTorch arithmetic on the same shard shapes, so
the results are compared at relerr 1e-6 (a BLAS may split a product
differently in another process; in practice they agree bit for bit).

This module imports no JAX: the spawned workers import it.
"""

import collections
import pathlib
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from umfa_tpu_torch.parallel import DistRing, LocalRing, ring_flash_attention_pallas, zigzag_shard
from umfa_tpu_torch.utils.testing import rel_err

WORLD, S, D = 4, 256, 64
JOIN_SECONDS = 240


def _inputs(zigzag: bool):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (1, h, S, D)).astype(np.float32))
               for h in (4, 2, 2))
    w = torch.from_numpy(rng.normal(0, 1, (1, 4, S)).astype(np.float32))
    if zigzag:
        q, k, v, w = (zigzag_shard(x, WORLD) for x in (q, k, v, w))
    return q, k, v, w


def _run(q, k, v, w, ring, zigzag):
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out, lse = ring_flash_attention_pallas(*leaves, ring=ring, causal=True, zigzag=zigzag,
                                           return_lse=True)
    (torch.sum(out * torch.cos(out)) + torch.sum(lse * w)).backward()
    return {"out": out.detach(), "lse": lse.detach(), "dq": leaves[0].grad,
            "dk": leaves[1].grad, "dv": leaves[2].grad, "hops": dict(ring.hops)}


def _worker(rank: int, init_file: str, out_dir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=WORLD)
    try:
        for zigzag in (False, True):
            shard = [x.chunk(WORLD, dim=2)[rank].contiguous() for x in _inputs(zigzag)]
            res = _run(*shard, DistRing(), zigzag)
            torch.save(res, pathlib.Path(out_dir) / f"zigzag{int(zigzag)}_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_dist_ring_equals_local_ring(tmp_path):
    ctx = mp.start_processes(_worker, args=(str(tmp_path / "rendezvous"), str(tmp_path)),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_SECONDS
    done = False
    try:
        # join returns True once every worker has exited cleanly, False
        # while some still run; it raises if a worker failed.
        while not done and time.monotonic() < deadline:
            done = ctx.join(timeout=max(0.1, deadline - time.monotonic()))
    finally:
        for proc in ctx.processes:  # a deadlocked ring fails the test, not the suite
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=10)
    assert done, f"the DistRing workers did not finish in {JOIN_SECONDS} s"
    for zigzag in (False, True):
        want = _run(*_inputs(zigzag), LocalRing(WORLD), zigzag)
        for rank in range(WORLD):
            got = torch.load(tmp_path / f"zigzag{int(zigzag)}_rank{rank}.pt")
            for name in ("out", "lse", "dq", "dk", "dv"):
                chunk = want[name].chunk(WORLD, dim=2)[rank]
                assert rel_err(got[name], chunk) <= 1e-6, (zigzag, rank, name)
            # Each rank sends its own share of the LocalRing's hops.
            fwd = {False: rank + 1 if rank < WORLD - 1 else 0, True: 3}[zigzag]
            want_hops = {"fwd_kv": fwd, "bwd_kv": 3, "bwd_dkv": 3, "bwd_home": 1}
            assert collections.Counter(got["hops"]) == collections.Counter(want_hops), rank
        assert want["hops"]["fwd_kv"] == {False: 6, True: 12}[zigzag]
