"""The check catches what it is there for. A run on the CPU at a tiny size
(the harness's look for a card skipped), with the timed path broken
underneath the window, comes out not correct, once for each fault a cell
can have: an answer altered where it is produced, half of the batch left
out, a step that leaves its state unchanged. (One chip: no exchange
between chips to leave out.) And the control, the reference one precision
below the configuration's in the program's place, fails the limits."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import pytest  # noqa: E402
import torch  # noqa: E402

from portbench import harness, traffic  # noqa: E402
from portbench.tests.test_portbench_runs import (  # noqa: E402,F401
    SEED, few_threads, tiny)

CLASSES = 41


def _serve_fault(kind):
    def wrap(engine):
        step = engine._step
        if kind == "state_unchanged":
            engine._run_step = lambda: None
            return
        cap = engine.seed_cap

        def broken():
            em = step().copy()
            if kind == "answer_altered":
                em[:, 1] = (em[:, 1] + 1) % CLASSES
            else:  # half of each request's seeds left out
                em[:, 1 + cap // 2:] = (em[:, 1:1 + cap - cap // 2] + 1) \
                    % CLASSES
            return em
        engine._step = broken
    return wrap


@pytest.mark.parametrize("kind", ["answer_altered", "half_batch",
                                  "state_unchanged"])
def test_a_broken_serve_step_is_not_correct(kind, monkeypatch):
    window = traffic.serve_window

    def broken_window(engine, plan, seconds, tracer=None):
        _serve_fault(kind)(engine)
        return window(engine, plan, seconds, tracer)

    monkeypatch.setattr(traffic, "serve_window", broken_window)
    monkeypatch.setattr(traffic, "WAIT_S", 3.0)
    out = harness.run_cell(tiny("sage_reddit.bulk"), SEED, 1.0, False, "cpu")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("kind", ["answer_altered", "half_batch",
                                  "state_unchanged"])
def test_a_broken_convert_is_not_correct(kind, monkeypatch):
    window = traffic.convert_window

    def broken_window(convert, versions, seconds, sync, tracer=None):
        first = []

        def broken(coo):
            if kind == "half_batch":
                half = coo.dst.shape[0] // 2
                dst, src = coo.dst.clone(), coo.src.clone()
                dst[half:] = harness.SENTINEL
                src[half:] = harness.SENTINEL
                coo = type(coo)(dst=dst, src=src, n_edges=coo.n_edges,
                                n_nodes=coo.n_nodes)
            out = convert(coo)
            if kind == "answer_altered":
                out.idx = out.idx.clone()
                out.idx[0] += 1
            if kind == "state_unchanged":
                first.append(out)
                return first[0]
            return out
        return window(broken, versions, seconds, sync, tracer)

    monkeypatch.setattr(traffic, "convert_window", broken_window)
    out = harness.run_cell(tiny("sage_reddit.convert"), SEED, 0.5, False,
                           "cpu")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", ["sage_reddit.bulk", "sage_reddit.convert"])
def test_the_control_fails_the_limits(name):
    cell = tiny(name)
    out = harness.run_cell(cell, SEED + 1, 0.5, False, "cpu", control=True)
    limits = cell.limits["limits"]
    assert any(v > limits[k] for k, v in out["control"].items()), \
        (out["control"], limits)
    assert torch.backends.cuda.matmul.allow_tf32 is False
