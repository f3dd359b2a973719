"""Block-sparse masks, FlexAttention-style (port of umfa_tpu/ops/block_mask.py).

A mask compiles into per-tile structure: a (Bm, Hm, nq, nk) int32 block map
(SKIP 0: no row of the tile attends any key of it; PARTIAL 1: the tile
needs the mask inside it; FULL 2: every in-bounds pair attends) and, where
some tile is PARTIAL, an additive fp32 bias holding the pattern (0 where
the mask attends, -1e30 elsewhere; broadcast dimensions kept at size 1).
The compacted tables list, per query tile, its walked key tiles in order
(`fetch_kv`) and, per key tile, its walked query tiles (`fetch_q`); the
kernels walk them. `hold_kv`/`fill_kv` are the reference's cache-fill
schedule for its fused quantized kernel, built here as there; of them the
port reads only where each slice's first fill lands (`kv_mean_tile`, found
in the same pass): the reference estimates the K/V smoothing means over
that tile's rows, so the single-launch quantized route does too.

The tiling (`block_q`, `block_k`) is part of the result, not only of the
speed: a row whose walked keys all carry the -1e30 bias averages V over
exactly the keys of its walked tiles. So the tiles are the reference's:
with default `block_sizes` its candidate scoring (a cost model fitted to
TPU v5e steps) picks them per mask, as it does there; the port's kernels
keep their own tiles inside the map's.

The tables are built once per mask on the host with numpy, as the
reference builds them, and carried to `device` once: a step that reuses a
BlockMask makes no host round trip. `maybe_window_block_mask` (the
reference's auto-tiling of plain `window=` calls) is not ported: there the
kernels' band walk skips the tiles outside the band (ops/attention.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch

from umfa_tpu_torch.ops.flash_fwd import (
    DEFAULT_MASK_VALUE,
    SKIP,
    BlockSizes,
    Walk,
    _choose_block,
    _round_up,
)
from umfa_tpu_torch.utils.device import default_device

PARTIAL, FULL = 1, 2


@dataclasses.dataclass
class BlockMask:
    block_map: torch.Tensor            # (Bm, Hm, nq, nk) int32
    bias: Optional[torch.Tensor]       # fp32, broadcast dims kept at 1, or None
    block_q: int
    block_k: int
    seq_q: int
    seq_k: int
    fetch_kv: Optional[torch.Tensor] = None   # (Bm, Hm, nq, max visible kv) int32
    fetch_q: Optional[torch.Tensor] = None    # (Bm, Hm, nk, max visible q) int32
    hold_kv: Optional[torch.Tensor] = None    # (Bm, Hm, nq, max visible kv) int32
    fill_kv: Optional[torch.Tensor] = None    # (Bm, Hm, nq, max visible kv) int32
    kv_mean_tile: Optional[torch.Tensor] = None  # (Bm, Hm) int32: first filled key tile, or -1

    @property
    def sparsity(self) -> float:
        """Fraction of tiles skipped."""
        return float((self.block_map == SKIP).float().mean())

    def to(self, device) -> "BlockMask":
        """This mask with every table (and the bias) on `device`."""
        move = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        for name, t in move.items():
            if isinstance(t, torch.Tensor):
                move[name] = t.to(device)
        return BlockMask(**move)

    def walk(self) -> Walk:
        """The map and tables as the attention ops take them."""
        return Walk(self.block_map, self.fetch_kv, self.fetch_q, self.block_q, self.block_k,
                    self.hold_kv, self.fill_kv, self.kv_mean_tile)


# The reference's per-mask tile choice (block_mask.py:84-95): candidates
# scored by a cost model fitted to TPU v5e steps. Kept because the tiling
# decides which keys a row that sees none averages over.
_AUTO_TILE_CANDIDATES = (
    (512, 2048), (512, 1024), (512, 512), (256, 512), (256, 256),
)
_C0, _C1, _C1_PARTIAL = 0.7e-6, 3.0e-12, 1.0e-12
_C0_PAD = 0.2e-6


def _tile_map_np(mask_np, seq_q, seq_k, bq, bk):
    """Tile classification: (Bm, Hm, nq, nk) of SKIP/PARTIAL/FULL."""
    bm, hm = mask_np.shape[:2]
    pq, pk = _round_up(seq_q, bq), _round_up(seq_k, bk)
    padded = np.zeros((bm, hm, pq, pk), bool)
    padded[:, :, :seq_q, :seq_k] = mask_np
    counts = padded.reshape(bm, hm, pq // bq, bq, pk // bk, bk).sum(axis=(3, 5))
    q_in = np.minimum(np.arange(1, pq // bq + 1) * bq, seq_q) - np.minimum(
        np.arange(pq // bq) * bq, seq_q)
    k_in = np.minimum(np.arange(1, pk // bk + 1) * bk, seq_k) - np.minimum(
        np.arange(pk // bk) * bk, seq_k)
    in_bounds = q_in[:, None] * k_in[None, :]
    return np.where(counts >= in_bounds[None, None], FULL,
                    np.where(counts > 0, PARTIAL, SKIP))


def _predict_cost(tile_map, bq, bk) -> float:
    """The reference's predicted seconds per (batch, head) of a tiling."""
    vis = tile_map != SKIP
    slices = tile_map.shape[0] * tile_map.shape[1]
    row_counts = vis.sum(axis=-1)
    width = int(row_counts.max()) if vis.any() else 0
    nq = tile_map.shape[2]
    n_vis = float(vis.sum()) / slices
    padded_steps = nq * width - n_vis
    n_partial = float((tile_map == PARTIAL).sum()) / slices
    return (n_vis * (_C0 + _C1 * bq * bk) + padded_steps * _C0_PAD
            + n_partial * _C1_PARTIAL * bq * bk)


def _compact_ids(m):
    """Per row of the last dim, its visible tile indices in order; past a
    row's count -(last visible + 1), a fully masked row all -1. Width: the
    largest visible count (at least 1)."""
    bm, hm, no, _ = m.shape
    counts = (m > 0).sum(axis=-1)
    width = max(int(counts.max()), 1)
    ids = np.full((bm, hm, no, width), -1, np.int32)
    for b in range(bm):
        for h in range(hm):
            for o in range(no):
                vis = np.nonzero(m[b, h, o] > 0)[0]
                if vis.size == 0:
                    continue
                ids[b, h, o, : vis.size] = vis
                ids[b, h, o, vis.size:] = -(int(vis[-1]) + 1)
    return ids


def _fill_schedule(fetch):
    """The reference's cache-fill schedule of a compacted table: at each
    step the tile the K/V buffer holds, and 2 / 1 at a slice's first / a
    tile's first visit (block_mask.py:246-274); and per slice the tile of
    its first fill (flag 2), -1 where it fills none."""
    bm, hm, nq, w = fetch.shape
    hold = np.zeros_like(fetch)
    fill = np.zeros_like(fetch)
    first = np.full((bm, hm), -1, np.int32)
    for b in range(bm):
        for h in range(hm):
            seen = set()
            cur = 0
            for qi in range(nq):
                for s in range(w):
                    t = int(fetch[b, h, qi, s])
                    if t >= 0 and t not in seen:
                        seen.add(t)
                        cur = t
                        fill[b, h, qi, s] = 1 if first[b, h] >= 0 else 2
                        if first[b, h] < 0:
                            first[b, h] = t
                    hold[b, h, qi, s] = cur
    return hold, fill, first


def make_block_mask(
    mask: Union[Callable, torch.Tensor, np.ndarray],
    seq_q: int,
    seq_k: int,
    *,
    head_dim: int = 64,
    block_sizes: BlockSizes = BlockSizes(),
    device=None,
) -> BlockMask:
    """Compile a mask into block structure.

    mask: a mask_mod `(q_idx, k_idx) -> bool` (True = attend), evaluated on
    broadcast `torch.arange` grids (a result that depends on one index
    only is broadcast to (Sq, Sk)), or a bool tensor broadcastable to
    (B, H, Sq, Sk). Default `block_sizes` pick the tiling per mask by the
    reference's candidate scoring; explicit ones pin it. device: where the
    tables and the bias go (default: a mask tensor's device; for a
    mask_mod the card, as every entry point: pass device="cpu" for the
    plain path).
    """
    block_q = _choose_block(block_sizes.block_q, seq_q, head_dim)
    block_k = _choose_block(block_sizes.block_k, seq_k, head_dim)
    if callable(mask):
        q_ids = torch.arange(seq_q)[:, None]
        k_ids = torch.arange(seq_k)[None, :]
        bool_mask = torch.broadcast_to(torch.as_tensor(mask(q_ids, k_ids)).bool(),
                                       (seq_q, seq_k))[None, None]
    else:
        if device is None and isinstance(mask, torch.Tensor):
            device = mask.device
        bool_mask = torch.as_tensor(mask).bool()
        while bool_mask.dim() < 4:
            bool_mask = bool_mask[None]
    device = default_device(device)
    bm, hm, sq, sk = bool_mask.shape
    if (sq, sk) != (seq_q, seq_k):
        raise ValueError(f"mask shape {tuple(bool_mask.shape)} does not end in {(seq_q, seq_k)}")
    mask_np = bool_mask.cpu().numpy()

    if block_sizes == BlockSizes():
        best = (float("inf"), block_q, block_k)
        for bq, bk in _AUTO_TILE_CANDIDATES:
            bq = min(bq, _round_up(seq_q, 128))
            bk = min(bk, _round_up(seq_k, 128))
            cost = _predict_cost(_tile_map_np(mask_np, seq_q, seq_k, bq, bk), bq, bk)
            # Strict < keeps the earliest (largest-tile) candidate on ties.
            if cost < best[0] * 0.999:
                best = (cost, bq, bk)
        block_q, block_k = best[1], best[2]

    m = _tile_map_np(mask_np, seq_q, seq_k, block_q, block_k).astype(np.int32)
    bias = None
    if (m == PARTIAL).any():
        bias = torch.zeros((bm, hm, sq, sk), dtype=torch.float32, device=device)
        bias.masked_fill_(~bool_mask.to(device), DEFAULT_MASK_VALUE)
    fkv = _compact_ids(m)
    hold, fill, first = _fill_schedule(fkv)

    def table(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return BlockMask(
        block_map=table(m), bias=bias, block_q=block_q, block_k=block_k,
        seq_q=seq_q, seq_k=seq_k, fetch_kv=table(fkv),
        fetch_q=table(_compact_ids(np.swapaxes(m, 2, 3))),
        hold_kv=table(hold), fill_kv=table(fill), kv_mean_tile=table(first),
    )


def causal_block_mask(seq_q: int, seq_k: int, **kwargs) -> BlockMask:
    return make_block_mask(lambda q, k: k <= q, seq_q, seq_k, **kwargs)


def segment_block_mask(segment_ids_q, segment_ids_k=None, *, causal: bool = False,
                       **kwargs) -> BlockMask:
    """Packed sequences: tokens attend only within their segment.
    segment_ids_q: (B, Sq) int; negative ids attend nothing (padding). A
    per-batch block map (B, 1, nq, nk), on the ids' device when they are a
    tensor and `device` is not given, else on `device` (default the card)."""
    if kwargs.get("device") is None:
        kwargs["device"] = (segment_ids_q.device if isinstance(segment_ids_q, torch.Tensor)
                            else default_device())
    seg_q = torch.as_tensor(segment_ids_q)
    seg_k = seg_q if segment_ids_k is None else torch.as_tensor(segment_ids_k)
    mask = (seg_q[:, :, None] == seg_k[:, None, :]) & (seg_q[:, :, None] >= 0)
    sq, sk = seg_q.shape[1], seg_k.shape[1]
    if causal:
        mask = mask & (torch.arange(sk, device=mask.device)[None, None, :]
                       <= torch.arange(sq, device=mask.device)[None, :, None])
    return make_block_mask(mask[:, None], sq, sk, **kwargs)


def sliding_window_block_mask(seq_q: int, seq_k: int, left: int, right: int = 0,
                              **kwargs) -> BlockMask:
    def fn(q, k):
        keep = torch.ones(torch.broadcast_shapes(q.shape, k.shape), dtype=torch.bool)
        if left >= 0:
            keep = keep & (k >= q - left)
        if right >= 0:
            keep = keep & (k <= q + right)
        return keep

    return make_block_mask(fn, seq_q, seq_k, **kwargs)
