"""Thread-safe FIFO request queue (port of ``repro/serve/queue.py``).

Producers ``put`` requests; the ``AdmissionFeeder`` thread drains it.
``close()`` marks the end of the stream: pending items still drain, then
consumers see ``None``.
"""
from __future__ import annotations

import collections
import threading

from .request import Request


class RequestQueue:
    """Unbounded FIFO of :class:`Request` with a close() end-of-stream."""

    def __init__(self):
        self._items: collections.deque[Request] = collections.deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._closed = False

    def put(self, req: Request) -> None:
        with self._lock:
            if self._closed:
                raise RuntimeError("RequestQueue is closed")
            self._items.append(req)
            self._not_empty.notify()

    def get(self, timeout: float | None = None) -> Request | None:
        """Pop the oldest request; None when closed-and-empty or timed out."""
        with self._not_empty:
            while not self._items:
                if self._closed:
                    return None
                if not self._not_empty.wait(timeout=timeout):
                    return None
            return self._items.popleft()

    def close(self) -> None:
        """End the stream: queued items still drain, then get() yields None."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)
