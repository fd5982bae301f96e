"""The one traffic generator. A mix is a JSON file under ``traffic/``; its
``loop`` picks how it is offered:

* ``closed``: ``clients`` callers, each sending its next request as soon
  as its last one was answered;
* ``open``: requests due on a schedule of ``rate_per_s`` whatever the
  answers do, Poisson arrivals (``arrivals: "poisson"``);
* ``convert``: back-to-back conversions of ``versions`` graph versions,
  cycled.

A serve request's size comes from ``seeds``: ``{"dist": "fixed", "n": k}``
or ``{"dist": "log_uniform", "lo": a, "hi": b}``; its node ids from
``nodes``: ``permutation`` (consecutive chunks of one seeded permutation of
all nodes) or ``uniform`` (distinct, uniform). The set of open-loop gaps
and sizes is drawn from the mix's ``shape_seed`` and only their order from
the run's seed, so every seed offers the same work in another order.

Time is the benchmark's own: a request is due when its schedule says (the
closed loop: when its client sends it), and answered when the driver sees
its predictions, polling every ``POLL_S``. A traced slice (``tracer``, a
``tracing.Slice``) is driven by the same loop, after the measured window:
the serve loop's as a window of its own, with the profiler started before
the engine's thread and stopped after it ended; the convert loop's past
the window's close.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time

import numpy as np

POLL_S = 1e-3
WAIT_S = 60.0  # how long past the window's close a due answer is awaited
TAIL_S = 10.0  # open-loop arrivals scheduled for a traced slice


@dataclasses.dataclass
class Record:
    """One request as the driver saw it."""

    seeds: list
    due: float
    submit: float = 0.0
    done: float | None = None
    handle: object = None

    @property
    def n_seeds(self) -> int:
        return len(self.seeds)


@dataclasses.dataclass
class Window:
    """What one measured window did."""

    t0: float
    t_end: float
    records: list  # the requests due in the window
    steps: int = 0
    converts: int = 0
    convert_s: float = 0.0
    failed: int = 0
    late_p99_ms: float = 0.0
    tail: list = dataclasses.field(default_factory=list)  # due past it


class RequestPlan:
    """The requests of one run, drawn from its seed: sizes and node ids."""

    def __init__(self, mix: dict, n_nodes: int, seed_cap: int, seed: int):
        self.mix = mix
        self.n_nodes = n_nodes
        self.seed_cap = seed_cap
        self.rng = np.random.default_rng([int(seed), 4])
        self.shape_rng = np.random.default_rng(int(mix.get("shape_seed", 0)))
        self._perm = None
        self._cursor = 0

    def sizes(self, n: int) -> np.ndarray:
        """``n`` request sizes: the shape stream's set, in the run's order."""
        spec = self.mix["seeds"]
        if spec["dist"] == "fixed":
            out = np.full(n, int(spec["n"]), dtype=np.int64)
        elif spec["dist"] == "log_uniform":
            lo, hi = int(spec["lo"]), int(spec["hi"])
            u = self.shape_rng.uniform(math.log(lo), math.log(hi + 1), n)
            out = np.clip(np.exp(u).astype(np.int64), lo, hi)
        else:
            raise ValueError(f"unknown size distribution {spec['dist']!r}")
        if out.max() > self.seed_cap:
            raise ValueError(f"a request of {out.max()} seeds exceeds the "
                             f"engine's seed_cap {self.seed_cap}")
        return self.rng.permutation(out)

    def nodes(self, k: int) -> list:
        """The distinct node ids of one request of ``k`` seeds."""
        how = self.mix["nodes"]
        if how == "permutation":
            if self._perm is None:
                self._perm = self.rng.permutation(self.n_nodes)
            if self._cursor + k > self.n_nodes:
                self._perm = self.rng.permutation(self.n_nodes)
                self._cursor = 0
            out = self._perm[self._cursor:self._cursor + k]
            self._cursor += k
            return out.tolist()
        if how == "uniform":
            return self.rng.choice(self.n_nodes, k, replace=False).tolist()
        raise ValueError(f"unknown node choice {how!r}")


def arrivals(mix: dict, n: int, seconds: float, rng, shape_rng) -> np.ndarray:
    """Due offsets in [0, seconds) of ``n`` open-loop requests."""
    if mix.get("arrivals", "poisson") != "poisson":
        raise ValueError(f"unknown arrivals {mix['arrivals']!r}")
    gaps = rng.permutation(shape_rng.exponential(1.0, n))
    return (np.cumsum(gaps) - gaps) * (seconds / gaps.sum())


class EngineThread:
    """``engine.run()`` on a thread of its own, its error kept."""

    def __init__(self, engine):
        self.engine = engine
        self.error = None
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="portbench-engine")
        self.thread.start()

    def _run(self):
        try:
            self.engine.run()
        except BaseException as exc:  # noqa: BLE001 — re-raised by join()
            self.error = exc

    def join(self, timeout: float) -> None:
        self.thread.join(timeout)
        if self.error is not None:
            raise self.error


def warm_up(engine, plan: RequestPlan, n_requests: int) -> None:
    """Serve ``n_requests`` full requests once: the step's first, eager
    run and its capture, then a replay."""
    for _ in range(n_requests):
        engine.submit(plan.nodes(plan.seed_cap))
    engine.close_submissions()
    engine.run()
    engine.reopen()


def _poll(outstanding: list, now: float) -> list:
    still = []
    for rec in outstanding:
        if rec.handle.finish_t is not None:
            rec.done = now
        else:
            still.append(rec)
    return still


def _drain(engine, runner: EngineThread, outstanding: list,
           deadline: float) -> int:
    """Close the stream and wait for the answers due; returns how many
    never came."""
    engine.close_submissions()
    while outstanding and time.perf_counter() < deadline \
            and runner.thread.is_alive():
        time.sleep(POLL_S)
        outstanding = _poll(outstanding, time.perf_counter())
    runner.join(max(0.0, deadline - time.perf_counter()))
    outstanding = _poll(outstanding, time.perf_counter())
    return len(outstanding)


def _open_requests(plan: RequestPlan, seconds: float, offset: float
                   ) -> list:
    n = round(float(plan.mix["rate_per_s"]) * seconds)
    if not n:
        return []
    due = offset + arrivals(plan.mix, n, seconds, plan.rng, plan.shape_rng)
    return [Record(plan.nodes(int(k)), float(d))
            for k, d in zip(plan.sizes(n), due)]


def serve_window(engine, plan: RequestPlan, seconds: float,
                 tracer=None) -> Window:
    """Offer the mix to a warmed engine for ``seconds``; with ``tracer`` (a
    ``tracing.Slice``) go on offering it until the slice has been traced,
    what is offered past ``seconds`` kept in the window's ``tail``."""
    mix = plan.mix
    closed = mix["loop"] == "closed"
    if not closed and mix["loop"] != "open":
        raise ValueError(f"unknown serve loop {mix['loop']!r}")
    if tracer is not None:
        tracer.start()  # before the engine's thread launches anything
    runner = EngineThread(engine)
    records, tail, outstanding = [], [], []
    if closed:
        sizes = iter(np.resize(plan.sizes(int(mix["clients"])), 1 << 20))
    else:
        todo = _open_requests(plan, seconds, 0.0)
        if tracer is not None:
            todo += _open_requests(plan, TAIL_S, seconds)

    t0 = time.perf_counter()
    t_end = t0 + seconds

    def send(rec: Record, now: float) -> None:
        rec.submit = now
        rec.handle = engine.submit(rec.seeds)
        (records if rec.due < t_end else tail).append(rec)
        outstanding.append(rec)

    steps0 = engine.stats.steps
    if closed:
        for _ in range(int(mix["clients"])):
            send(Record(plan.nodes(int(next(sizes))), t0), t0)
    i, steps = 0, None
    while True:
        now = time.perf_counter()
        answered = len(outstanding)
        outstanding = _poll(outstanding, now)
        answered -= len(outstanding)
        if closed:
            if now < t_end or tracer is not None:
                for _ in range(answered):
                    send(Record(plan.nodes(int(next(sizes))), now), now)
        else:
            while i < len(todo) and now >= t0 + todo[i].due:
                todo[i].due += t0
                send(todo[i], now)
                i += 1
        traced = tracer is not None and tracer.tick(now)
        if now >= t_end:
            if steps is None:
                steps = engine.stats.steps - steps0
            if tracer is None or traced:
                break
        wait = POLL_S
        if not closed and i < len(todo):
            wait = min(POLL_S, max(0.0, t0 + todo[i].due - now))
        time.sleep(wait)
    failed = _drain(engine, runner, outstanding,
                    time.perf_counter() + WAIT_S)
    if tracer is not None:
        tracer.finish()  # the engine's thread has ended
    late = [r.submit - r.due for r in records]
    return Window(t0=t0, t_end=t_end, records=records, steps=steps,
                  failed=failed,
                  late_p99_ms=float(np.percentile(late, 99)) * 1e3
                  if late else 0.0, tail=tail)


def convert_window(convert, versions: list, seconds: float, sync,
                   tracer=None) -> tuple[Window, list]:
    """Convert the versions back to back, cycled, each synchronised at its
    end, for ``seconds`` (with ``tracer``, on past the close until the slice
    has been traced); returns the window and each version's latest
    output."""
    outs = [None] * len(versions)
    n, n_window, elapsed = 0, 0, None
    t0 = time.perf_counter()
    t_end = t0 + seconds
    while True:
        now = time.perf_counter()
        if now >= t_end:
            if elapsed is None:
                elapsed, n_window = now - t0, n
                if tracer is not None:
                    tracer.start()
            if tracer is None or tracer.tick(time.perf_counter()):
                break
        v = n % len(versions)
        outs[v] = convert(versions[v])
        sync()
        n += 1
    if tracer is not None:
        tracer.finish()
    return Window(t0=t0, t_end=t_end, records=[], converts=n_window,
                  convert_s=elapsed), outs
