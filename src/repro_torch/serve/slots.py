"""Payload-agnostic slot-batching core (port of ``repro/serve/slots.py``).

The queue, feeder thread, FIFO lowest-slot admission, stats and the
admission/step/retire loop live here; ``gnn.GnnServeEngine`` is the
client. A client provides:

* ``_admit_many(wave)`` — seat a wave of ``[(slot, PreparedAdmission)]``
  into its slot state;
* ``_step()`` — run every slot once and return the [S, ...] emissions as
  a numpy array, routed per slot by ``route``; the client counts the step
  programs it builds in ``_step_programs`` (``step_cache_size``).

Requests retire after one step (one-shot inference), so the loop runs
synchronously: emissions route right after each step and retired slots are
free at once.
"""
from __future__ import annotations

import dataclasses
import threading

from .feeder import AdmissionFeeder
from .queue import RequestQueue
from .request import Request
from .scheduler import Scheduler


@dataclasses.dataclass
class ServeStats:
    steps: int = 0
    admitted: int = 0
    retired: int = 0
    tokens_generated: int = 0  # predictions emitted


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

    # ----------------------------------------------------- cache discipline
    def step_cache_size(self) -> int:
        """Step programs built behind ``_step`` (the zero-recapture guard
        reads this): 1 after warm-up, whatever the seed counts since."""
        return self._step_programs

    # ------------------------------------------------------------ admission
    def _enqueue(self, prompt: list[int]) -> Request:
        """Wrap a validated payload row in a Request and queue it."""
        with self._rid_lock:
            rid = self._rid
            self._rid += 1
        req = Request(rid=rid, prompt=prompt)
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

    def _try_admit(self, feeder: AdmissionFeeder,
                   timeout: float | None = None) -> int:
        """Seat prepared requests while slots are free; each poll waits up
        to ``timeout`` (None = non-blocking), stopping at the first empty
        poll. The wave is seated by one ``_admit_many`` call."""
        wave = []
        while self.scheduler.has_free_slot:
            prep = feeder.poll(timeout=timeout)
            if prep is None:
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
                    if feeder.done:
                        break
                    self._try_admit(feeder, timeout=0.05)
                    continue
                emitted = self._step()
                self.stats.steps += 1
                self._process(emitted, completed)
        return completed
