"""Payload-agnostic slot-batching core (port of ``repro/serve/slots.py``).

The queue, feeder thread, FIFO lowest-slot admission, cooling, stats, the
step program and the admission/step/retire loop live here;
``gnn.GnnServeEngine`` (one-shot GNN inference) and ``engine.ServeEngine``
(greedy LM decode) are the clients. A client provides:

* ``params``, ``state`` and ``step_fn(params, state)``: one step over
  every slot, writing the state in place;
* ``_bound_tensors()``: every tensor the step reads or writes, by name;
* ``_admit_many(wave)``: seat a wave of ``[(slot, PreparedAdmission)]``
  into its slot state;
* ``_step()``: run the step program (``_run_step``) and return the [S, ...]
  emissions, routed per slot by ``route`` (or a handle that
  ``_emissions`` turns into them);
* with a control plane, ``_classify_prep(prep)`` (``"seat"`` or
  ``"apply"``) and ``_apply_control(prep)``.

The step program: on the CPU ``step_fn`` runs eagerly. On the card the
first step runs it eagerly on a side stream (the warm-up: kernel builds,
cuBLAS handles, allocator pools) with host syncs made errors, and captures
it once as a CUDA graph on a memory pool of the engine's own; every later
step replays the graph. ``step_cache_size()`` (the zero-recapture guard)
counts the programs built. A program is bound to the tensors it was built
on, and a step raises if one was rebound since (a replay would read the
old buffers): new values are written into them in place.

Two run-loop schedules, by ``pipeline_steps``. Without it (GNN: every
request retires after one step) emissions route right after each step and
retired slots are free at once. With it (LM decode) the loop keeps one
step in flight: the host routes step k - 1's emissions while step k runs,
so a retired slot cools for one cycle (``scheduler.Scheduler``). A control
request (a streamed graph update) is held when admission reaches it;
nothing queued behind it is polled until the engine is quiescent (no slot
active, nothing in flight) and the held request was applied, so every
later request sees its effect and no earlier one does.

On a mesh of several ranks every rank runs the loop over the same
request stream, and every rank must take the same steps (each step
issues the same collectives): rank 0 admits as above and broadcasts how
many it seated and whether the stream is over
(``AdmissionAgreement``); the other ranks seat as many from their own
feeders and follow its word.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels import add_launch_counts, launch_counts

from .feeder import AdmissionFeeder
from .queue import RequestQueue
from .request import Request, RequestState
from .scheduler import Scheduler


@dataclasses.dataclass
class ServeStats:
    steps: int = 0
    admitted: int = 0
    retired: int = 0
    tokens_processed: int = 0  # active slots summed over the steps
    tokens_generated: int = 0  # tokens (LM) / predictions (GNN) emitted


def deactivate_update(state: dict, slot: int) -> dict:
    """Clear one slot's active flag, in place, in any client's state (the
    only tensor it touches is the shared ``"active"`` [S] row)."""
    state["active"][slot] = 0
    return state


class AdmissionAgreement:
    """Rank 0's admission decisions over the world: ``agree(n, done)``
    broadcasts rank 0's (n, done) and returns it on every rank (a tensor
    on ``device``, whose type the backend takes)."""

    def __init__(self, device):
        self.lead = dist.get_rank() == 0
        self.device = device

    def __call__(self, n: int, done: bool) -> tuple[int, bool]:
        t = torch.tensor([n, int(done)], dtype=torch.int64,
                         device=self.device)
        dist.broadcast(t, src=0)
        n, done = t.tolist()
        return n, bool(done)


class SlotEngineBase:
    """Slot bookkeeping, the step program and the admission/step/retire
    loop, payload-free."""

    def __init__(self, *, n_slots: int, row_cap: int, device,
                 feeder_depth: int, route=None, eos_id: int | None = None,
                 pipeline_steps: bool = False, pad_value: int = 0,
                 admit_window: float = 0.0):
        self.n_slots = n_slots
        self.row_cap = row_cap
        self.device = device
        self.queue = RequestQueue()
        self.scheduler = Scheduler(n_slots, eos_id=eos_id, route=route)
        self.stats = ServeStats()
        self._feeder_depth = feeder_depth
        self._pipeline_steps = pipeline_steps
        self._pad_value = pad_value
        self._admit_window = admit_window
        self._rid = 0
        self._rid_lock = threading.Lock()
        self._step_programs = 0
        self._graph = None  # the captured step (card only)
        self._graph_out = None  # what the captured step_fn returned
        self._graph_launches: dict[str, int] = {}
        self._bound: dict[str, int] | None = None  # the program's tensors
        # a prepared control request, held until the engine is quiescent
        self._held_prep = None
        # on a mesh of several ranks: rank 0's admissions, which every rank
        # takes (AdmissionAgreement), and its stream-over flag
        self._agree = None
        self._stream_done = False

    # ----------------------------------------------------- cache discipline
    def step_cache_size(self) -> int:
        """Step programs built behind ``_step`` (the zero-recapture guard
        reads this): 1 after warm-up, whatever the traffic since."""
        return self._step_programs

    def _bound_tensors(self) -> dict[str, torch.Tensor]:
        raise NotImplementedError

    def _bindings(self) -> dict[str, int]:
        """{name: data_ptr} of every tensor the step reads or writes."""
        return {k: t.data_ptr() for k, t in self._bound_tensors().items()}

    def _capture(self):
        """The first step on the card: run ``step_fn`` eagerly on a side
        stream (the warm-up) with ``torch.cuda.set_sync_debug_mode
        ("error")``, so a host read that would break the capture raises
        here; then capture it once into a CUDA graph on the engine's own
        pool. Returns what the eager run returned. Capturing launches
        nothing, so the kernel launches the wrappers counted meanwhile are
        taken off the counters and kept as the graph's per-replay counts. A
        prefetch producer thread launching meanwhile would put its launches
        in that count, so a running one is refused."""
        from repro_torch.engine.prefetch import active_producers
        if active_producers():
            raise RuntimeError(
                "a prefetch producer is running: close it before the serve "
                "step is captured")
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = self.step_fn(self.params, self.state)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        with torch.cuda.graph(graph, pool=torch.cuda.graph_pool_handle(),
                              stream=side, capture_error_mode="thread_local"):
            self._graph_out = self.step_fn(self.params, self.state)
        after = launch_counts()
        self._graph_launches = {k: after[k] - before[k] for k in after
                                if after[k] != before[k]}
        add_launch_counts({k: -n for k, n in self._graph_launches.items()})
        self._graph = graph
        return out

    def captured_launches(self) -> dict[str, int]:
        """Kernel launches of one replay of the captured step (empty before
        the capture and on the CPU)."""
        return dict(self._graph_launches)

    def _run_step(self):
        """Run every slot once; returns what ``step_fn`` returned (after a
        replay: the captured call's outputs, rewritten by the replay). The
        first step builds the step program (on the card its capture);
        every later one runs it on the same tensors, or raises."""
        if self._bound is None:
            self._bound = self._bindings()
            self._step_programs += 1
            if self.device.type == "cuda":
                return self._capture()
        else:
            now = self._bindings()
            moved = sorted(k for k in self._bound.keys() | now.keys()
                           if self._bound.get(k) != now.get(k))
            if moved:
                raise RuntimeError(
                    f"the step program reads {moved} at the addresses it "
                    "was built on, and they were rebound since; write new "
                    "values into those tensors in place")
        if self._graph is None:
            return self.step_fn(self.params, self.state)
        self._graph.replay()
        add_launch_counts(self._graph_launches)
        return self._graph_out

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

    def _emissions(self, out) -> np.ndarray:
        """The [S, ...] emissions of what ``_step`` returned."""
        return out

    def _retired(self, slot: int) -> None:
        """A request in ``slot`` retired (routed): the LM engine clears its
        active flag; the GNN step clears every flag itself."""

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
        lead = self._agree is None or self._agree.lead
        while lead and self.scheduler.has_free_slot \
                and self._held_prep is None:
            prep = feeder.poll(timeout=timeout)
            if prep is None:
                break
            if self._classify_prep(prep) == "apply":
                self._held_prep = prep
                break
            wave.append((self.scheduler.admit(prep), prep))
        if self._agree is not None:
            n, self._stream_done = self._agree(len(wave), feeder.done)
            while len(wave) < n:  # rank 0 seated n: take the same n
                prep = feeder.poll(timeout=1.0)
                if prep is not None:
                    wave.append((self.scheduler.admit(prep), prep))
                elif feeder.done:
                    raise RuntimeError(
                        f"rank 0 seated {n} requests, this rank's stream "
                        f"ended after {len(wave)}: the ranks' request "
                        "streams differ")
        if wave:
            self._admit_many(wave)
            self.stats.admitted += len(wave)
        return len(wave)

    def _process(self, emitted, completed: list[Request]) -> None:
        for slot, req in self.scheduler.process(self._emissions(emitted)):
            self._retired(slot)
            self.stats.retired += 1
            self.stats.tokens_generated += len(req.tokens_out)
            completed.append(req)

    def _feeder_done(self, feeder: AdmissionFeeder) -> bool:
        """The stream is over (on a mesh of several ranks: rank 0's word at
        the last admission)."""
        return feeder.done if self._agree is None else self._stream_done

    # ------------------------------------------------------------- the loop
    def run(self) -> list[Request]:
        """Drive the engine until the request stream is closed and drained;
        returns completed requests in retirement order. With
        ``pipeline_steps`` one step stays in flight: step k is launched
        before step k - 1's emissions are routed."""
        completed: list[Request] = []
        pending = None  # step k - 1's emissions, not routed yet
        with AdmissionFeeder(self.queue, self.row_cap,
                             depth=self._feeder_depth,
                             pad_value=self._pad_value) as feeder:
            while True:
                self._try_admit(feeder)
                if (self._admit_window and self.scheduler.n_active
                        and self.scheduler.has_free_slot
                        and not self._feeder_done(feeder)):
                    # give the feeder one bounded wait to fill the wave
                    self._try_admit(feeder, timeout=self._admit_window)
                if self.scheduler.n_active == 0:
                    if pending is not None:
                        self._process(pending, completed)
                        pending = None
                        continue  # routing may have freed cooling slots
                    self.scheduler.flush_cooling()
                    if self._held_prep is not None:
                        # quiescent: apply the held control request, then
                        # admit what was queued behind it
                        self._apply_held(completed)
                        continue
                    if self._feeder_done(feeder):
                        break
                    self._try_admit(feeder, timeout=0.05)
                    continue
                emitted = self._step()
                self.stats.steps += 1
                self.stats.tokens_processed += self.scheduler.n_active
                if self._pipeline_steps:
                    if pending is not None:
                        self._process(pending, completed)
                    pending = emitted
                else:
                    self._process(emitted, completed)
                    self.scheduler.flush_cooling()
        return completed
