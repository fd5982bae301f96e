"""Request lifecycle containers (port of ``repro/serve/request.py``).

A ``Request`` is the unit the serve path admits, runs and retires:
``QUEUED`` (in ``RequestQueue``) → ``PREPARED`` (the feeder padded its row)
→ ``RUNNING`` (owns a slot) → ``FINISHED`` (slot released). Timestamps at
admission and retirement give request latency without instrumenting the
engine loop.
"""
from __future__ import annotations

import dataclasses
import enum
import time


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREPARED = "prepared"
    RUNNING = "running"
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    """One serve request: a payload row (a prompt's token ids for the LM
    engine, seed node ids for the GNN engine) and what it may emit
    (``max_new``: the new tokens' budget, 1 for a prediction, 0 for a
    control request); ``tokens_out`` collects what the engine emits (the
    generated tokens, or one class id per seed). A control request (a streamed graph update) rides the same
    FIFO with its ``payload`` (an ``EdgeDelta``); its row is a marker the
    feeder pads like any other and nothing reads."""

    rid: int
    prompt: list[int]
    max_new: int = 1
    payload: object | None = None
    state: RequestState = RequestState.QUEUED
    slot: int | None = None
    tokens_out: list[int] = dataclasses.field(default_factory=list)
    enqueue_t: float = dataclasses.field(default_factory=time.perf_counter)
    admit_t: float | None = None
    finish_t: float | None = None

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def admission_latency_s(self) -> float | None:
        """Queue-to-slot latency (None until admitted)."""
        if self.admit_t is None:
            return None
        return self.admit_t - self.enqueue_t

    @property
    def total_latency_s(self) -> float | None:
        """Queue-to-retirement latency (None until finished)."""
        if self.finish_t is None:
            return None
        return self.finish_t - self.enqueue_t
