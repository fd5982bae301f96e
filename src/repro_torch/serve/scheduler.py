"""Slot scheduler (port of ``repro/serve/scheduler.py``).

The host mirror of the slot table: which request occupies which slot and
which slots are free. FIFO admission seats a request in the lowest free
slot; a route policy turns each step's per-slot emission into a retirement
verdict.

A retired slot passes one cycle of ``cooling`` before it is free again:
the LM engine keeps one step in flight (the host routes step k - 1 while
step k runs), and step k, launched before the retirement was seen, may
still emit a token for the old occupant; re-admitting before that step is
routed would give the stale token to the new one. The next ``process``
frees the cooling slots, and ``flush_cooling`` frees them when nothing is
in flight (the GNN engine calls it after every step: it keeps no step in
flight).
"""
from __future__ import annotations

import time

import numpy as np

from .feeder import PreparedAdmission
from .request import Request, RequestState

NO_TOKEN = -1  # the emission of a slot that generated nothing this step


def lm_token_route(eos_id: int | None = None):
    """The route of greedy decode: an emission is a token id. ``NO_TOKEN``
    is nothing (prefilling or idle); ``eos_id`` retires the request
    without being recorded; any other token is appended until ``max_new``
    are out."""
    def route(req: Request, emission) -> bool | None:
        tok = int(emission)
        if tok == NO_TOKEN:
            return None
        if eos_id is not None and tok == eos_id:
            return True
        req.tokens_out.append(tok)
        return len(req.tokens_out) >= req.max_new
    return route


class Scheduler:
    """FIFO admission into the lowest free slot; route-policy retirement.

    ``route(req, emission) -> bool | None``: None = nothing emitted for
    this request, False = consumed and continuing, True = finished; the
    default is ``lm_token_route(eos_id)``.
    """

    def __init__(self, n_slots: int, eos_id: int | None = None,
                 route=None):
        self.n_slots = n_slots
        self.eos_id = eos_id
        self.route = route or lm_token_route(eos_id)
        self._slots: list[Request | None] = [None] * n_slots
        self._free: list[int] = list(range(n_slots))  # kept sorted
        self._cooling: list[int] = []

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
        newly finished slots, which start cooling. The slots that were
        cooling are free first: the step this call routes is the one that
        was in flight when they retired."""
        self.flush_cooling()
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
            self._cooling.append(slot)
        return finished

    def flush_cooling(self) -> None:
        """Free the cooling slots (no step is in flight)."""
        self._free = sorted(self._free + self._cooling)
        self._cooling = []
