"""Slot scheduler (port of ``repro/serve/scheduler.py``).

The host mirror of the slot table: which request occupies which slot and
which slots are free. FIFO admission seats a request in the lowest free
slot; a route policy turns each step's per-slot emission into a retirement
verdict, and a retired slot is free again at once (the GNN engine keeps
no step in flight).
"""
from __future__ import annotations

import time

import numpy as np

from .feeder import PreparedAdmission
from .request import Request, RequestState


class Scheduler:
    """FIFO admission into the lowest free slot; route-policy retirement.

    ``route(req, emission) -> bool | None``: None = nothing emitted for
    this request, False = consumed and continuing, True = finished.
    """

    def __init__(self, n_slots: int, route):
        self.n_slots = n_slots
        self.route = route
        self._slots: list[Request | None] = [None] * n_slots
        self._free: list[int] = list(range(n_slots))  # kept sorted

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self._slots)

    @property
    def has_free_slot(self) -> bool:
        return bool(self._free)

    def admit(self, prep: PreparedAdmission) -> int:
        """Seat a prepared request in the lowest free slot; returns it."""
        if not self._free:
            raise RuntimeError("no free slot")
        slot = self._free.pop(0)
        req = prep.request
        req.state = RequestState.RUNNING
        req.slot = slot
        req.admit_t = time.perf_counter()
        self._slots[slot] = req
        return slot

    def process(self, emitted: np.ndarray) -> list[tuple[int, Request]]:
        """Route one step's emissions (indexed ``emitted[slot]``); return
        newly finished slots, which are free again."""
        finished: list[tuple[int, Request]] = []
        for slot, req in enumerate(self._slots):
            if req is None or req.state is RequestState.FINISHED:
                continue
            if self.route(req, emitted[slot]):
                finished.append((slot, req))
        for slot, req in finished:
            req.state = RequestState.FINISHED
            req.finish_t = time.perf_counter()
            self._slots[slot] = None
        self._free = sorted(self._free + [slot for slot, _ in finished])
        return finished
