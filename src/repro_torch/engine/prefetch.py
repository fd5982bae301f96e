"""Double-buffered prefetch: preprocessing off the critical path (port of
``repro/engine/prefetch.py``).

The paper's dataflow computes the next subgraph in the preprocessing
engine while the accelerator consumes the current one. Here a producer
thread evaluates ``batch_fn(i + 1)`` while the consumer works on batch
``i``, through a queue ``depth`` deep.

On the card the producer runs ``batch_fn`` under ``torch.cuda.stream`` of
a side stream of its own, so its kernels overlap the consumer's on the
main stream. It records a ``torch.cuda.Event`` after each batch;
``__next__`` makes the consumer's current stream wait on that event, then
calls ``record_stream`` on every CUDA tensor of the batch, so the caching
allocator cannot hand a batch's memory to the producer's next batch while
the consumer's stream still reads it. ``device=`` moves host tensors of a
batch there (``non_blocking``, on the side stream). On the CPU there are
no streams, and the producer is the reference's thread.

Determinism: ``batch_fn(step)`` must be a pure function of the step index
(the train loop's restart contract), so prefetching changes when batches
are computed, never what they contain. No CUDA graph may be captured while
a producer runs: a capture in global mode breaks on another thread's CUDA
call (``active_producers``).
"""
from __future__ import annotations

import dataclasses
import queue
import sys
import threading
from contextlib import nullcontext
from typing import Any, Callable, Iterator

import torch

_DONE = object()
_LIVE_LOCK = threading.Lock()
_LIVE = [0]  # producer threads running now


class _Failure:
    """A producer exception, relayed to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def active_producers() -> int:
    """Producer threads that are running (a CUDA graph capture must wait
    until there are none)."""
    with _LIVE_LOCK:
        return _LIVE[0]


def _map_tensors(obj, fn):
    """``obj`` with ``fn`` applied to every tensor in it (tensors inside
    NamedTuples, dataclasses, tuples, lists and dicts)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_map_tensors(x, fn) for x in obj))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _map_tensors(getattr(obj, f.name), fn)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map_tensors(x, fn) for x in obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    return obj


def _tensors(obj) -> list[torch.Tensor]:
    out = []
    _map_tensors(obj, out.append)
    return out


def _side_stream(device) -> torch.cuda.Stream | None:
    """The producer's side stream: on ``device`` when it is a CUDA device;
    with no device, on the current card when there is one."""
    if device is not None:
        dev = torch.device(device)
        return torch.cuda.Stream(dev) if dev.type == "cuda" else None
    if torch.cuda.is_available():
        return torch.cuda.Stream(torch.cuda.current_device())
    return None


def _safe_put(q: queue.Queue, stop_evt: threading.Event, item) -> bool:
    """Queue.put that gives up (returns False) once the stop event is set,
    so a full queue can never deadlock the producer."""
    while not stop_evt.is_set():
        try:
            q.put(item, timeout=0.05)
            return True
        except queue.Full:
            continue
    return False


def _produce(batch_fn, q: queue.Queue, stop_evt: threading.Event, device,
             stream, start: int, stop: int | None) -> None:
    """The producer loop. A module-level function on purpose: the thread
    must hold no reference to its Prefetcher, or an abandoned iterator
    could never be collected and closed."""
    step = start
    move = None
    if device is not None:
        dev = torch.device(device)
        move = (lambda t: t.to(dev, non_blocking=dev.type == "cuda"))
    ctx = (torch.cuda.stream(stream) if stream is not None else nullcontext())
    try:
        with ctx:
            while stop is None or step < stop:
                if stop_evt.is_set():
                    return
                batch = batch_fn(step)
                if move is not None:
                    batch = _map_tensors(batch, move)
                ready = None
                if stream is not None:
                    ready = torch.cuda.Event()
                    ready.record(stream)
                if not _safe_put(q, stop_evt, (step, batch, ready)):
                    return
                step += 1
        _safe_put(q, stop_evt, _DONE)
    except BaseException as exc:  # noqa: BLE001 — relayed to the consumer
        _safe_put(q, stop_evt, _Failure(exc))
    finally:
        with _LIVE_LOCK:
            _LIVE[0] -= 1


class Prefetcher:
    """Iterator over ``(step, batch)`` with a producer thread ``depth``
    batches ahead at most (1: the classic double buffer).

    ``device`` moves the batch's tensors there; without it the batch stays
    where ``batch_fn`` made it. The producer runs on a side CUDA stream
    when ``device`` is a CUDA device, or, with no ``device``, whenever a
    card is present.
    """

    def __init__(self, batch_fn: Callable[[int], Any], start: int = 0,
                 stop: int | None = None, depth: int = 1, device=None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop_evt = threading.Event()
        self._stream = _side_stream(device)
        self._thread = threading.Thread(
            target=_produce,
            args=(batch_fn, self._q, self._stop_evt, device, self._stream,
                  start, stop),
            daemon=True, name="repro-torch-prefetch")
        with _LIVE_LOCK:
            _LIVE[0] += 1
        self._thread.start()

    @property
    def stream(self) -> torch.cuda.Stream | None:
        """The producer's side stream (None on the CPU)."""
        return self._stream

    def __iter__(self) -> "Prefetcher":
        return self

    def __next__(self) -> tuple[int, Any]:
        if self._stop_evt.is_set():
            raise StopIteration
        item = self._q.get()
        if item is _DONE:
            self._stop_evt.set()  # sticky: every later next() stops too
            raise StopIteration
        if isinstance(item, _Failure):
            self.close()
            raise item.exc
        step, batch, ready = item
        if ready is not None:
            torch.cuda.current_stream(self._stream.device).wait_event(ready)
            for t in _tensors(batch):
                if t.is_cuda:
                    t.record_stream(torch.cuda.current_stream(t.device))
        return step, batch

    def close(self, _empty=queue.Empty) -> None:
        """Stop the producer and join its thread (idempotent; safe on a
        partly built instance from ``__del__``, and at interpreter exit:
        ``_empty`` is bound when the class is made)."""
        evt = getattr(self, "_stop_evt", None)
        if evt is None:
            return
        evt.set()

        def drain():
            try:
                while True:
                    self._q.get_nowait()
            except _empty:
                pass

        drain()  # unblock a producer waiting on a full queue
        thread = getattr(self, "_thread", None)
        if thread is not None and thread.is_alive():
            thread.join(timeout=5.0)
        drain()  # a put in flight during the first drain may have landed

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self, _finalizing=sys.is_finalizing):
        # an abandoned iterator must not leak its producer; at interpreter
        # exit the daemon thread dies with the process
        if not _finalizing():
            self.close()


class SyncBatches:
    """The synchronous twin of ``Prefetcher``: the same ``(step, batch)``
    iterator and context-manager protocol, no producer thread."""

    def __init__(self, batch_fn: Callable[[int], Any], start: int = 0,
                 stop: int | None = None):
        self._batch_fn = batch_fn
        self._step = start
        self._stop = stop

    def __iter__(self) -> "SyncBatches":
        return self

    def __next__(self) -> tuple[int, Any]:
        if self._stop is not None and self._step >= self._stop:
            raise StopIteration
        step = self._step
        self._step += 1
        return step, self._batch_fn(step)

    def close(self) -> None:
        self._stop = self._step

    def __enter__(self) -> "SyncBatches":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def prefetch_batches(batch_fn: Callable[[int], Any], start: int = 0,
                     stop: int | None = None, depth: int = 1,
                     device=None) -> Iterator[tuple[int, Any]]:
    """Generator form: yields ``(step, batch)`` in step order with the
    producer ahead; closes the producer on generator exit."""
    pf = Prefetcher(batch_fn, start=start, stop=stop, depth=depth,
                    device=device)
    try:
        yield from pf
    finally:
        pf.close()
