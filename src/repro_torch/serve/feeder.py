"""Admission feeder (port of ``repro/serve/feeder.py``): a producer thread
drains the :class:`RequestQueue` and pads each payload row to the engine's
pow2 row bucket off the step's critical path. ``depth`` bounds the
lookahead. End-of-stream and producer errors travel out of band (a
finished event and an error box), so a full item queue can never swallow
the shutdown signal.
"""
from __future__ import annotations

import dataclasses
import queue as _queue
import threading

import numpy as np

from .queue import RequestQueue
from .request import Request, RequestState


@dataclasses.dataclass
class PreparedAdmission:
    """A request whose row is padded and ready to seat."""

    request: Request
    row: np.ndarray  # int32 [row_cap], pad_value tail


def _produce(rq: RequestQueue, out: _queue.Queue, stop: threading.Event,
             row_cap: int, err_box: list, finished: threading.Event,
             pad_value: int) -> None:
    """Producer loop (module-level so the thread does not pin the feeder)."""
    try:
        while not stop.is_set():
            req = rq.get(timeout=0.05)
            if req is None:
                if rq.closed and len(rq) == 0:
                    return
                continue
            row = np.full((row_cap,), pad_value, np.int32)
            row[:len(req.prompt)] = np.asarray(req.prompt, np.int32)
            req.state = RequestState.PREPARED
            item = PreparedAdmission(req, row)
            while not stop.is_set():
                try:
                    out.put(item, timeout=0.05)
                    break
                except _queue.Full:
                    continue
            else:
                return
    except BaseException as exc:  # noqa: BLE001 — relayed via the err box
        err_box.append(exc)
    finally:
        finished.set()


class AdmissionFeeder:
    """Bounded admission pipeline over a :class:`RequestQueue`.

    ``poll()`` returns the next :class:`PreparedAdmission` or ``None``;
    once the stream is closed and drained, ``done`` flips. A producer error
    re-raises out of ``poll()``.
    """

    def __init__(self, rq: RequestQueue, row_cap: int, depth: int = 2,
                 pad_value: int = 0):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._out: _queue.Queue = _queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._finished = threading.Event()
        self._err_box: list[BaseException] = []
        self._done = False
        self._thread = threading.Thread(
            target=_produce, args=(rq, self._out, self._stop, row_cap,
                                   self._err_box, self._finished, pad_value),
            daemon=True, name="repro-torch-serve-feeder")
        self._thread.start()

    @property
    def done(self) -> bool:
        return self._done

    def poll(self, timeout: float | None = None) -> PreparedAdmission | None:
        """Next prepared admission, or None (not ready / stream over)."""
        if self._done:
            return None
        try:
            return (self._out.get(timeout=timeout) if timeout
                    else self._out.get_nowait())
        except _queue.Empty:
            if self._err_box:
                self._done = True
                self.close()
                raise self._err_box[0]
            if self._finished.is_set() and self._out.empty():
                self._done = True
            return None

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._out.get_nowait()
        except _queue.Empty:
            pass
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)

    def __enter__(self) -> "AdmissionFeeder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
