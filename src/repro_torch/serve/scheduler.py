"""Admission queue + slot lifecycle for the continuous-batching engine.

The scheduler owns *which request sits in which slot* and nothing else:
device-side state (caches, positions, masks) lives in
:class:`~repro_torch.serve.batch_state.BatchState`, model math in the engine.
A finished sequence frees its slot and the head of the admission queue is
prefilled into that slot mid-decode — the batch never drains.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Iterable, List, Optional, Tuple


class Scheduler:
    """FCFS admission queue over a fixed pool of batch slots."""

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = n_slots
        self.queue: Deque = deque()
        self.slots: List[Optional[object]] = [None] * n_slots
        # free-slot deque: admission pops the head in O(1) instead of
        # scanning the slot list (O(n_slots) per admit).  release appends
        # at the tail; requeue (an *undone* admission) returns the slot to
        # the head so backpressure retries the same slot it just tried.
        self._free: Deque[int] = deque(range(n_slots))
        # lifecycle counters (surfaced in benchmark summaries)
        self.n_admitted = 0
        self.n_completed = 0

    # -- queue ------------------------------------------------------------
    def submit(self, requests: Iterable, front: bool = False) -> None:
        """Append to the admission queue; ``front`` jumps the FCFS line
        (priority classes — e.g. interactive-SLO requests preempting a
        backlog of batch work).  Multiple front submissions keep their
        relative order at the head."""
        if front:
            self.queue.extendleft(reversed(list(requests)))
        else:
            self.queue.extend(requests)

    @property
    def pending(self) -> int:
        return len(self.queue)

    # -- slots ------------------------------------------------------------
    @property
    def active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is not None]

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.slots)

    def free_slot(self) -> Optional[int]:
        """Peek the next slot an admission would use (O(1))."""
        return self._free[0] if self._free else None

    def admit_next(self) -> Optional[Tuple[int, object]]:
        """Pop the queue head into the next free slot, if both exist."""
        if not self.queue or not self._free:
            return None
        slot = self._free.popleft()
        req = self.queue.popleft()
        self.slots[slot] = req
        self.n_admitted += 1
        return slot, req

    def requeue(self, slot: int):
        """Undo an admission: put the slot's request back at the *head* of
        the queue (FCFS order preserved) and free the slot.  Used by the
        paged engine's admission backpressure when the page pool cannot
        cover the request yet."""
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"slot {slot} is free; nothing to requeue")
        self.slots[slot] = None
        self.n_admitted -= 1
        self.queue.appendleft(req)
        self._free.appendleft(slot)
        return req

    def release(self, slot: int):
        """Free a slot; returns the request that occupied it."""
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"slot {slot} is already free")
        self.slots[slot] = None
        self.n_completed += 1
        self._free.append(slot)
        return req

    def done(self) -> bool:
        return not self.queue and self.n_active == 0
