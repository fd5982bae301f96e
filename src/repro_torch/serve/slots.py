"""Payload-agnostic slot-batching core (port of ``repro/serve/slots.py``).

The queue, feeder thread, FIFO lowest-slot admission, stats and the
admission/step/retire loop live here; ``gnn.GnnServeEngine`` is the
client. A client provides:

* ``_admit_many(wave)`` — seat a wave of ``[(slot, PreparedAdmission)]``
  into its slot state;
* ``_step()`` — run every slot once and return the [S, ...] emissions as
  a numpy array, routed per slot by ``route``; the client counts the step
  programs it builds in ``_step_programs`` (``step_cache_size``);
* with a control plane, ``_classify_prep(prep)`` (``"seat"`` or
  ``"apply"``) and ``_apply_control(prep)``.

Requests retire after one step (one-shot inference), so the loop runs
synchronously: emissions route right after each step and retired slots are
free at once. A control request (a streamed graph update) is held when
admission reaches it; nothing queued behind it is polled until the engine
is quiescent (no slot active) and the held request was applied, so every
later request sees its effect and no earlier one does.
"""
from __future__ import annotations

import dataclasses
import threading
import time

from .feeder import AdmissionFeeder
from .queue import RequestQueue
from .request import Request, RequestState
from .scheduler import Scheduler


@dataclasses.dataclass
class ServeStats:
    steps: int = 0
    admitted: int = 0
    retired: int = 0
    tokens_generated: int = 0  # predictions emitted


def deactivate_update(state: dict, slot: int) -> dict:
    """Clear one slot's active flag, in place, in any client's state (the
    only tensor it touches is the shared ``"active"`` [S] row)."""
    state["active"][slot] = 0
    return state


class SlotEngineBase:
    """Slot bookkeeping + the admission/step/retire loop, payload-free."""

    def __init__(self, *, n_slots: int, row_cap: int, route,
                 feeder_depth: int, pad_value: int = 0,
                 admit_window: float = 0.0):
        self.n_slots = n_slots
        self.row_cap = row_cap
        self.queue = RequestQueue()
        self.scheduler = Scheduler(n_slots, route=route)
        self.stats = ServeStats()
        self._feeder_depth = feeder_depth
        self._pad_value = pad_value
        self._admit_window = admit_window
        self._rid = 0
        self._rid_lock = threading.Lock()
        self._step_programs = 0
        # a prepared control request, held until the engine is quiescent
        self._held_prep = None

    # ----------------------------------------------------- cache discipline
    def step_cache_size(self) -> int:
        """Step programs built behind ``_step`` (the zero-recapture guard
        reads this): 1 after warm-up, whatever the seed counts since."""
        return self._step_programs

    # ------------------------------------------------------------ admission
    def _enqueue(self, prompt: list[int], max_new: int = 1,
                 payload=None) -> Request:
        """Wrap a validated payload row in a Request and queue it; the
        ``payload`` is attached before the put, so the feeder never sees a
        half-built request."""
        with self._rid_lock:
            rid = self._rid
            self._rid += 1
        req = Request(rid=rid, prompt=prompt, max_new=max_new,
                      payload=payload)
        self.queue.put(req)
        return req

    def close_submissions(self) -> None:
        self.queue.close()

    def reopen(self) -> None:
        """Start a new request stream after ``run()`` returned."""
        if not self.queue.closed:
            raise RuntimeError("reopen() is only valid after the previous "
                               "stream was closed")
        self.queue = RequestQueue()

    def _admit_many(self, wave: list) -> None:
        raise NotImplementedError

    def _step(self):
        raise NotImplementedError

    def _classify_prep(self, prep) -> str:
        """``"seat"`` (a slot admission) or ``"apply"`` (a control request
        applied between steps once the engine is quiescent). The base
        seats everything."""
        return "seat"

    def _apply_control(self, prep) -> None:
        """Apply one held control request (no slot is active)."""
        raise NotImplementedError

    def _apply_held(self, completed: list[Request]) -> None:
        """Apply the held control request and finish it, with nothing in
        ``tokens_out``."""
        prep, self._held_prep = self._held_prep, None
        req = prep.request
        req.admit_t = time.perf_counter()  # taken up: the apply starts
        self._apply_control(prep)
        req.state = RequestState.FINISHED
        req.finish_t = time.perf_counter()
        self.stats.retired += 1
        completed.append(req)

    def _try_admit(self, feeder: AdmissionFeeder,
                   timeout: float | None = None) -> int:
        """Seat prepared requests while slots are free; each poll waits up
        to ``timeout`` (None = non-blocking), stopping at the first empty
        poll. The wave is seated by one ``_admit_many`` call. A control
        request ends the wave: it is held, and nothing is polled past it
        until it was applied."""
        wave = []
        while self.scheduler.has_free_slot and self._held_prep is None:
            prep = feeder.poll(timeout=timeout)
            if prep is None:
                break
            if self._classify_prep(prep) == "apply":
                self._held_prep = prep
                break
            wave.append((self.scheduler.admit(prep), prep))
        if wave:
            self._admit_many(wave)
            self.stats.admitted += len(wave)
        return len(wave)

    def _process(self, emitted, completed: list[Request]) -> None:
        for _, req in self.scheduler.process(emitted):
            self.stats.retired += 1
            self.stats.tokens_generated += len(req.tokens_out)
            completed.append(req)

    # ------------------------------------------------------------- the loop
    def run(self) -> list[Request]:
        """Drive the engine until the request stream is closed and drained;
        returns completed requests in retirement order."""
        completed: list[Request] = []
        with AdmissionFeeder(self.queue, self.row_cap,
                             depth=self._feeder_depth,
                             pad_value=self._pad_value) as feeder:
            while True:
                self._try_admit(feeder)
                if (self._admit_window and self.scheduler.n_active
                        and self.scheduler.has_free_slot
                        and not feeder.done):
                    # give the feeder one bounded wait to fill the wave
                    self._try_admit(feeder, timeout=self._admit_window)
                if self.scheduler.n_active == 0:
                    if self._held_prep is not None:
                        # quiescent: apply the held control request, then
                        # admit what was queued behind it
                        self._apply_held(completed)
                        continue
                    if feeder.done:
                        break
                    self._try_admit(feeder, timeout=0.05)
                    continue
                emitted = self._step()
                self.stats.steps += 1
                self._process(emitted, completed)
        return completed
