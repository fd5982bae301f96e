"""Fault-tolerant training loop: checkpoint / restart, deterministic data
skipping, the straggler watchdog and simulated failures (port of
``repro/train/loop.py``).

Contract:
* every ``ckpt_every`` steps the parameters and the optimizer state
  commit atomically; a crash resumes from the last commit with identical
  results (data order is a function of (seed, step), never of live
  state);
* stragglers: ``step_timeout_s`` is the watchdog. It synchronises the
  card before it reads the clock (PyTorch returns before the card is
  done) and raises; a launcher restarts the job from the last commit;
* ``FailureInjector`` crashes the loop at a chosen step, so tests prove
  restart-equivalence end to end;
* ``prefetch`` double-buffers the batches (``engine.prefetch.Prefetcher``:
  batch i + 1 is made while step i runs, on a side CUDA stream on the
  card); ``batch_fn`` is pure, so restart determinism is unchanged.

The parameters are an ``nn.Module`` or a dictionary name → tensor, and
the step function updates them and the optimizer state in place; a
restore copies the checkpoint into the same tensors.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable

import torch
from torch import nn

from . import checkpoint as ckpt


def default_ckpt_dir() -> str:
    """``repro_torch_ckpt`` under the temporary directory (``$TMPDIR``)."""
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 50
    ckpt_dir: str = dataclasses.field(default_factory=default_ckpt_dir)
    keep: int = 3
    log_every: int = 10
    step_timeout_s: float | None = None  # straggler watchdog
    # double-buffer batches (repro_torch.engine.prefetch): batch i + 1 is
    # made while step i runs
    prefetch: bool = False


class FailureInjector:
    """Deterministic crash at a given step (tests / chaos drills)."""

    def __init__(self, fail_at_step: int | None = None):
        self.fail_at_step = fail_at_step

    def maybe_fail(self, step: int) -> None:
        if self.fail_at_step is not None and step == self.fail_at_step:
            raise RuntimeError(f"injected failure at step {step}")


def state_tensors(params, opt_state: dict) -> dict[str, torch.Tensor]:
    """The flat name → tensor view of (params, AdamW state) that a
    checkpoint holds: parameter names, ``m.<name>``, ``v.<name>``,
    ``step``."""
    named = (dict(params.named_parameters()) if isinstance(params, nn.Module)
             else dict(params))
    return {**named, **{f"m.{n}": t for n, t in opt_state["m"].items()},
            **{f"v.{n}": t for n, t in opt_state["v"].items()},
            "step": opt_state["step"]}


def _synchronize(metrics: dict) -> None:
    for v in metrics.values():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            torch.cuda.synchronize(v.device)


def train(cfg: LoopConfig, step_fn: Callable, params, opt_state: dict,
          batch_fn: Callable[[int], Any],
          failure: FailureInjector | None = None
          ) -> tuple[Any, dict, list[dict]]:
    """Run the loop from the latest commit in ``cfg.ckpt_dir`` (from step
    0 when there is none); returns (params, opt_state, metrics history).

    ``batch_fn(step)`` must be a pure function of the step index (plus a
    fixed seed): that is what makes a restart deterministic.
    ``step_fn(params, opt_state, batch) -> (params, opt_state, metrics)``
    updates in place and returns the same objects.
    """
    start_step = 0
    latest = ckpt.latest_step(cfg.ckpt_dir)
    if latest is not None:
        like = state_tensors(params, opt_state)
        saved, meta = ckpt.restore(cfg.ckpt_dir, latest, like)
        with torch.no_grad():
            for key, t in like.items():
                t.copy_(saved[key])
        start_step = meta["step"]

    prefetcher = None
    if cfg.prefetch:
        from repro_torch.engine.prefetch import Prefetcher
        prefetcher = Prefetcher(batch_fn, start=start_step,
                                stop=cfg.total_steps)

    history: list[dict] = []
    try:
        for step in range(start_step, cfg.total_steps):
            if failure is not None:
                failure.maybe_fail(step)
            t0 = time.perf_counter()
            if prefetcher is not None:
                got_step, batch = next(prefetcher)
                if got_step != step:  # data order is the restart contract
                    raise RuntimeError(
                        f"prefetcher yielded step {got_step}, loop expected "
                        f"{step}")
            else:
                batch = batch_fn(step)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if cfg.step_timeout_s is not None:
                _synchronize(metrics)
                dt = time.perf_counter() - t0
                if dt > cfg.step_timeout_s:
                    raise TimeoutError(
                        f"step {step} took {dt:.1f}s > {cfg.step_timeout_s}s"
                        " — straggler watchdog (the launcher restarts from "
                        "the last commit)")
            if step % cfg.log_every == 0 or step == cfg.total_steps - 1:
                history.append({"step": step,
                                **{k: float(v) for k, v in metrics.items()}})
            if (step + 1) % cfg.ckpt_every == 0 \
                    or step == cfg.total_steps - 1:
                ckpt.save(cfg.ckpt_dir, step + 1,
                          state_tensors(params, opt_state), keep=cfg.keep)
    finally:
        if prefetcher is not None:
            prefetcher.close()
    return params, opt_state, history
