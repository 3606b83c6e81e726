"""Continuous-batching slot allocator: pure host-side state machine (a copy
of `repro/serve/batcher.py`).

The service packs live sessions into the K replica slots of one batched
step.  This module owns the WHO-IS-WHERE bookkeeping and nothing else — no
arrays, no torch — so its invariants can be property-tested over arbitrary
event orderings (tests/test_torch_serve.py):

  I1  no two live sessions ever share a slot;
  I2  a slot is reused only after its previous occupant's release
      completed (an evict must finish — checkpoint durably written —
      before `release` is called, which is the only way the slot returns
      to the free pool);
  I3  conservation: admitted == live + evicted + finished, at every point.

`SlotBatcher` is deliberately dumb: FIFO admission from an explicit queue,
lowest-index-first slot choice (deterministic, so the integration harness
can predict placements).  Fancier policies belong above it.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional


class BatcherError(RuntimeError):
    """An operation that would violate a batcher invariant."""


class SlotBatcher:
    """Tracks the session <-> slot assignment for K slots.

    Sessions move through: enqueue -> admit (slot bound) -> release
    (finished or evicted; slot freed).  Evicted sessions re-enter via
    `enqueue(session_id, restore=True)` and are re-admitted like fresh
    ones — possibly into a different slot.
    """

    def __init__(self, num_slots: int):
        if num_slots <= 0:
            raise ValueError(f"num_slots must be positive: {num_slots}")
        self.num_slots = num_slots
        self._slot_of: Dict[str, int] = {}  # live sessions only
        self._occupant: List[Optional[str]] = [None] * num_slots
        self._queue: "OrderedDict[str, bool]" = OrderedDict()  # id -> restore
        # lifetime counters (I3)
        self.admitted = 0  # total admissions (restores NOT recounted)
        self.evicted = 0  # currently evicted (on disk)
        self.finished = 0  # total completed
        self._ever_seen: set = set()

    # -- queries ------------------------------------------------------------
    @property
    def live(self) -> int:
        return len(self._slot_of)

    @property
    def queued(self) -> int:
        return len(self._queue)

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._occupant) if s is None]

    def slot_of(self, session_id: str) -> Optional[int]:
        return self._slot_of.get(session_id)

    def occupant(self, slot: int) -> Optional[str]:
        return self._occupant[slot]

    def live_items(self) -> List:
        """[(session_id, slot)] sorted by slot."""
        return sorted(self._slot_of.items(), key=lambda kv: kv[1])

    # -- transitions --------------------------------------------------------
    def enqueue(self, session_id: str, restore: bool = False):
        if session_id in self._slot_of:
            raise BatcherError(f"{session_id} is already live")
        if session_id in self._queue:
            raise BatcherError(f"{session_id} is already queued")
        if restore:
            if session_id not in self._ever_seen:
                raise BatcherError(f"{session_id} was never admitted")
            self.evicted -= 1
        elif session_id in self._ever_seen:
            raise BatcherError(f"{session_id} was already submitted")
        self._queue[session_id] = restore
        self.check()

    def admit_next(self) -> Optional[tuple]:
        """Bind the oldest queued session to the lowest free slot.

        Returns (session_id, slot, is_restore), or None when the queue is
        empty or every slot is occupied.
        """
        free = self.free_slots()
        if not free or not self._queue:
            return None
        session_id, restore = next(iter(self._queue.items()))
        del self._queue[session_id]
        slot = free[0]
        self._occupant[slot] = session_id
        self._slot_of[session_id] = slot
        if not restore:
            self.admitted += 1
            self._ever_seen.add(session_id)
        self.check()
        return session_id, slot, restore

    def release(self, session_id: str, *, finished: bool):
        """Free the session's slot; the caller has already persisted (evict)
        or harvested (finish) the slot's device state."""
        slot = self._slot_of.pop(session_id, None)
        if slot is None:
            raise BatcherError(f"{session_id} is not live")
        assert self._occupant[slot] == session_id  # I1 by construction
        self._occupant[slot] = None
        if finished:
            self.finished += 1
        else:
            self.evicted += 1
        self.check()
        return slot

    # -- invariants ---------------------------------------------------------
    def check(self):
        """Assert I1-I3; called after every transition (cheap: O(K))."""
        live_slots = [s for s in self._occupant if s is not None]
        if len(live_slots) != len(set(live_slots)):
            raise BatcherError(f"slot sharing: {self._occupant}")  # I1
        for sid, slot in self._slot_of.items():
            if self._occupant[slot] != sid:
                raise BatcherError(
                    f"slot map out of sync at {slot}: " f"{sid} vs {self._occupant[slot]}"
                )  # I2
        if len(self._slot_of) != len(live_slots):
            raise BatcherError("live-count mismatch")
        queued_restores = sum(1 for r in self._queue.values() if r)
        total = (self.live + self.evicted + self.finished + queued_restores)
        if total != self.admitted:
            raise BatcherError(
                f"conservation: live={self.live} evicted={self.evicted} "
                f"finished={self.finished} requeued={queued_restores} "
                f"!= admitted={self.admitted}"
            )  # I3
