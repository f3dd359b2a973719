"""Continuous batching scheduler, host side (port of
umfa_tpu/serving/scheduler.py).

A slot-based scheduler that keeps a fixed-shape decode batch full: finished
sequences free their slot, queued requests claim it, and the device step
always runs over the same B slots (ragged cache lengths, one
`forward_with_cache(..., uniform_pos=False)` per round).

The device state is a KV cache (dense or quantized) whose per-slot `length`
is the single source of truth; the batcher only tracks request identity.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    uid: int
    prompt_len: int
    max_new_tokens: int
    generated: int = 0

    @property
    def done(self) -> bool:
        return self.generated >= self.max_new_tokens


@dataclasses.dataclass
class SchedulerStats:
    admitted: int = 0
    completed: int = 0
    steps: int = 0
    slot_occupancy_sum: float = 0.0

    @property
    def mean_occupancy(self) -> float:
        return self.slot_occupancy_sum / max(self.steps, 1)


class ContinuousBatcher:
    """Keeps `num_slots` decode lanes full.

    The caller owns the device work through the `on_admit(slot, request)`
    and `on_retire(slot, request)` callbacks of `step`; the batcher only
    decides which slots run, admits queued requests into free slots (lowest
    slot first, in submission order) and retires finished ones."""

    def __init__(self, num_slots: int):
        self.num_slots = num_slots
        self.slots: List[Optional[Request]] = [None] * num_slots
        self.queue: Deque[Request] = deque()
        self.stats = SchedulerStats()
        self._next_uid = 0

    def submit(self, prompt_len: int, max_new_tokens: int) -> int:
        uid = self._next_uid
        self._next_uid += 1
        self.queue.append(Request(uid, prompt_len, max_new_tokens))
        return uid

    def _admit(self, on_admit: Optional[Callable] = None):
        for slot in range(self.num_slots):
            if self.slots[slot] is None and self.queue:
                req = self.queue.popleft()
                self.slots[slot] = req
                self.stats.admitted += 1
                if on_admit is not None:
                    on_admit(slot, req)

    def active_mask(self) -> np.ndarray:
        return np.array([r is not None for r in self.slots])

    def step(
        self,
        on_admit: Optional[Callable] = None,
        on_retire: Optional[Callable] = None,
    ) -> np.ndarray:
        """One scheduling round: admit → mark progress → retire. Returns the
        active-slot mask the device decode step should use (a slot retired
        this round is in it: it still decodes its last token)."""
        self._admit(on_admit)
        mask = self.active_mask()
        self.stats.steps += 1
        self.stats.slot_occupancy_sum += mask.mean() if self.num_slots else 0.0
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            req.generated += 1
            if req.done:
                self.stats.completed += 1
                if on_retire is not None:
                    on_retire(slot, req)
                self.slots[slot] = None
        return mask

    @property
    def idle(self) -> bool:
        return not self.queue and all(r is None for r in self.slots)


def reset_slot(cache, slot: int):
    """Free a cache slot for reuse: length[slot] ← 0 (stale rows stay, masked
    by the length bias). Works on any of the port's caches IN PLACE and
    returns the same cache object, as `kv_cache.append` does; unlike the
    reference, which returns a new cache."""
    cache.length[slot] = 0
    return cache
