"""Device traces for the per-layer metrics.

* ``device_ms(fn)``: ``fn()`` once under ``torch.profiler``, the device
  time of the operations it ran (kernels, copies, fills). Kernel records
  next to either end of a trace can go missing, so each trace starts and
  ends with 256 short spin kernels and one of ~50 ms next to the call,
  which are left out of the sum.
* ``Slice``: a slice of the cell's traffic, after the measured window,
  traced from the thread that drives the traffic; ``summary()`` gives the
  device's busy seconds over the slice (the union of every device
  operation's interval), the slice's length, the operations that took
  most device time, and the longest idle gaps, each named by the innermost
  host operation that was running at its middle. The slice is a span of
  the benchmark's own, ``portbench.slice``, held for its full length.
"""
from __future__ import annotations

import time

import torch

SPIN_KERNEL = "spin_kernel"
SPINS = 256
SPIN_CYCLES = 100_000_000
SETTLE_S = 0.5  # traffic offered before the traced slice opens
SLICE_SPAN = "portbench.slice"
SLICE_SLACK = 1e-3  # the profiler's clock against the host's


def _profile(record_threads: bool):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if record_threads:
        try:
            from torch._C._profiler import _ExperimentalConfig
            return profile(activities=acts, experimental_config=(
                _ExperimentalConfig(profile_all_threads=True)))
        except TypeError:
            pass
    return profile(activities=acts)


def _rows(events) -> list:
    """(on_device, name, start_ns, end_ns) of every recorded operation;
    the device-side copies of user annotations (a span's extent on the
    device, not an operation) are left out."""
    from torch.autograd import DeviceType
    rows = []
    for e in events:
        dev = e.device_type() == DeviceType.CUDA
        if dev and (e.name().startswith("portbench.")
                    or getattr(e, "is_user_annotation", bool)()):
            continue
        rows.append((dev, e.name(), e.start_ns(), e.end_ns()))
    return rows


def device_ms(fn, span: str) -> float:
    """Device milliseconds of the operations ``fn()`` runs, inside a
    ``record_function`` span named ``span``."""
    from torch.profiler import record_function
    with _profile(False) as prof:
        for _ in range(SPINS):
            torch.cuda._sleep(1000)
        torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
        with record_function(span):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        for _ in range(SPINS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    return sum(b - a for dev, name, a, b in
               _rows(prof.profiler.kineto_results.events())
               if dev and SPIN_KERNEL not in name) / 1e6


class Slice:
    """``seconds`` of the cell's traffic traced after the measured window,
    which no profiler runs in. The driver calls ``start()`` before it
    starts the engine's thread (or, with no other thread, once the window
    has closed), then ``tick(now)`` as it drives the traffic, until
    ``tick`` returns True, and ``finish()`` once every thread it started
    has ended: no other thread launches work on the device while the
    profiler starts or stops. The span opens ``SETTLE_S`` after the first
    tick, once the traffic has settled, and closes at the first tick
    ``seconds`` after it opened."""

    def __init__(self, seconds: float):
        from torch.profiler import record_function
        self.seconds = seconds
        self.prof = None
        self.span = record_function(SLICE_SPAN)
        self.opens = self.closes = None  # perf_counter times
        self.closed = False
        self.rows = None

    def start(self) -> None:
        self.prof = _profile(True)
        self.prof.__enter__()

    def tick(self, now: float) -> bool:
        """Open or close the span at ``now``; True once it has closed."""
        if self.opens is None:
            self.opens = now + SETTLE_S
        if self.closes is None:
            if now >= self.opens:
                self.span.__enter__()
                self.closes = time.perf_counter() + self.seconds
        elif not self.closed and now >= self.closes:
            self.span.__exit__(None, None, None)
            self.closed = True
        return self.closed

    def finish(self) -> None:
        if self.closes is not None and not self.closed:
            self.span.__exit__(None, None, None)
            self.closed = True
        if self.prof is not None and self.rows is None:
            self.prof.__exit__(None, None, None)
            self.rows = _rows(self.prof.profiler.kineto_results.events())

    def summary(self, top: int = 10) -> dict:
        return summarize(self.rows or [], self.seconds, top)


def summarize(rows: list, seconds: float, top: int = 10) -> dict:
    """busy_s, window_s and the breakdown of the slice in ``rows``
    (``_rows``'s tuples). A slice whose span is missing, is shorter than
    ``seconds``, or holds no device operation fails the run: its idle
    share would read a trace that did not happen."""
    spans = [(a, b) for dev, name, a, b in rows
             if not dev and name == SLICE_SPAN]
    if len(spans) != 1:
        raise RuntimeError(f"the trace holds {len(spans)} {SLICE_SPAN} "
                           "spans, not one")
    s0, s1 = spans[0]
    if (s1 - s0) / 1e9 < seconds * (1 - SLICE_SLACK):
        raise RuntimeError(f"the traced slice spans {(s1 - s0) / 1e9:.4f} s, "
                           f"less than its {seconds} s")
    dev_iv, host, by_name = [], [], {}
    for on_dev, name, a, b in rows:
        if on_dev:
            a, b = max(a, s0), min(b, s1)
            if b > a:
                dev_iv.append((a, b))
                by_name[name] = by_name.get(name, 0) + (b - a)
        elif name != SLICE_SPAN and b > s0 and a < s1:
            host.append((a, b, name))
    dev_iv.sort()
    busy, gaps, cur = 0, [], s0
    for a, b in dev_iv:
        if a > cur:
            gaps.append((a - cur, cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if s1 > cur:
        gaps.append((s1 - cur, cur, s1))
    gaps.sort(reverse=True)

    def doing(mid):
        over = [(b - a, n) for a, b, n in host if a <= mid <= b]
        return min(over)[1] if over else "no host operation recorded"

    if not busy:
        raise RuntimeError("no device operation ran in the traced slice")
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return dict(busy_s=busy / 1e9, window_s=(s1 - s0) / 1e9,
                device_ops=[[n[:120], t / 1e9] for n, t in ops],
                idle_gaps=[[doing((a + b) // 2)[:120], g / 1e9]
                           for g, a, b in gaps[:top]])
