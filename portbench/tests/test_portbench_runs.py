"""Each traffic mix driven end to end on the CPU at a tiny size through
the harness (the port's plain-torch twins in place of its kernels), ending
in a well-formed result; the command itself refuses to run without a
card."""
import json
import os
import queue
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from portbench import harness, traffic  # noqa: E402

# a tiny graph and engine: the published widths, a small node count
TINY = {"graph": {"n_nodes": 2000, "n_edges": 20000, "capacity": 32768},
        "engine": {"seed_cap": 8}, "fanouts": [4, 3]}
MIXES = {"bulk": {"seeds": {"n": 8}},
         "open": {"seeds": {"hi": 8}, "rate_per_s": 6},
         "convert": {"versions": 2}}
SEED = 2 ** 31 + 77  # past 32 signed bits, as the driver's are


@pytest.fixture(autouse=True)
def few_threads():
    """Keep a CPU run to two threads: the suite runs beside others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny(name: str) -> harness.Cell:
    cell = harness.load_cell(name)
    cell = cell.with_overrides(TINY, MIXES[cell.traffic.get("loop") == "closed"
                                         and "bulk" or cell.traffic["loop"]])
    cell.limits = dict(cell.limits, sample_requests=4)
    return cell


def _well_formed(cell, out):
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    json.loads(json.dumps(out, allow_nan=False))
    want = {m["name"]: m["unit"] for m in cell.end_to_end}
    assert {k: v["unit"] for k, v in out["metrics"].items()
            if k in want} == want
    # a loaded CPU may answer nothing inside a tiny window: a rate of 0 is
    # a reading there, never on the card
    assert all(v["value"] >= 0 for v in out["metrics"].values())
    assert out["metrics"]["setup_s"]["value"] > 0
    assert out["device"]["count"] == 1
    for line in harness.check_lines(out):
        assert line.startswith("check ") and " limit " in line


@pytest.mark.parametrize("name", ["sage_reddit.bulk", "gatedgcn_reddit.bulk",
                                  "sage_reddit.convert", "sage_reddit.open"])
def test_a_run_on_the_cpu_is_correct_and_well_formed(name):
    cell = tiny(name)
    out = harness.run_cell(cell, SEED, 2.0, False, "cpu")
    _well_formed(cell, out)
    assert out["attempted"] > 0 and out["failed"] == 0
    checks = {k: c["value"] for k, c in out["checks"].items()}
    # every exact comparison holds on the CPU; the logits only within the
    # CPU twins' rounding: their span sums are differences of a float32
    # cumsum, far coarser than the card's kernel (the limits are the card's)
    assert all(v == 0 for k, v in checks.items()
               if k not in ("logit_err", "served_gap")), checks
    assert checks.get("logit_err", 0) < 1e-2 and \
        checks.get("served_gap", 0) < 1e-2, checks


def test_open_arrivals_are_one_set_in_another_order():
    mix = {"rate_per_s": 50}
    a = traffic.arrivals(mix, 200, 4.0, np.random.default_rng(1),
                         np.random.default_rng(9))
    b = traffic.arrivals(mix, 200, 4.0, np.random.default_rng(2),
                         np.random.default_rng(9))
    assert a[0] == 0 and a[-1] < 4.0 and np.all(np.diff(a) >= 0)
    assert np.allclose(np.sort(np.diff(a, append=4.0)),
                       np.sort(np.diff(b, append=4.0)))
    assert not np.allclose(a, b)


def test_request_sizes_and_nodes():
    plan = traffic.RequestPlan({"seeds": {"dist": "log_uniform", "lo": 1,
                                          "hi": 1024}, "nodes": "uniform",
                                "shape_seed": 3}, 5000, 1024, SEED)
    sizes = plan.sizes(500)
    assert sizes.min() >= 1 and sizes.max() <= 1024
    nodes = plan.nodes(1024)
    assert len(set(nodes)) == 1024 and max(nodes) < 5000
    perm = traffic.RequestPlan({"seeds": {"dist": "fixed", "n": 100},
                                "nodes": "permutation"}, 250, 128, SEED)
    got = [perm.nodes(100) for _ in range(3)]
    assert all(len(set(g)) == 100 for g in got)
    assert not set(got[0]) & set(got[1])


class _Engine:
    """Answers each request 2 ms after it was submitted, one at a time."""

    def __init__(self):
        self.stats = types.SimpleNamespace(steps=0)
        self.queue = queue.Queue()
        self.closed = False
        self.ended = None

    def submit(self, seeds):
        h = types.SimpleNamespace(admit_t=None, finish_t=None)
        self.queue.put(h)
        return h

    def run(self):
        while True:
            try:
                h = self.queue.get(timeout=0.01)
            except queue.Empty:
                if self.closed:
                    self.ended = time.perf_counter()
                    return
                continue
            time.sleep(0.002)
            h.admit_t = h.finish_t = time.perf_counter()
            self.stats.steps += 1

    def close_submissions(self):
        self.closed = True


class _Slice:
    """Traced for 0.3 s from its first tick; keeps when it started and
    finished."""

    def __init__(self):
        self.started = self.first = self.finished = None

    def start(self):
        self.started = time.perf_counter()

    def tick(self, now):
        self.first = self.first or now
        return now >= self.first + 0.3

    def finish(self):
        self.finished = time.perf_counter()


@pytest.mark.parametrize("mix", [
    {"loop": "closed", "clients": 2, "seeds": {"dist": "fixed", "n": 4},
     "nodes": "permutation"},
    {"loop": "open", "rate_per_s": 200, "seeds": {"dist": "fixed", "n": 4},
     "nodes": "uniform"}], ids=["closed", "open"])
def test_a_traced_slice_runs_past_the_window(mix):
    """The profiler starts before the engine's thread and stops after it
    has ended, the mix goes on being offered until the slice has been
    traced, and what is offered past the window is kept apart from the
    window's requests."""
    plan = traffic.RequestPlan(mix, 5000, 8, SEED)
    engine, tracer = _Engine(), _Slice()
    win = traffic.serve_window(engine, plan, 0.1, tracer)
    assert tracer.started <= win.t0 and tracer.finished >= engine.ended
    assert engine.ended >= tracer.first + 0.3 > win.t_end
    assert win.records and win.tail and win.failed == 0
    assert all(r.due < win.t_end for r in win.records)
    assert all(r.due >= win.t_end for r in win.tail)
    assert 0 < win.steps <= len(win.records) + len(win.tail)


def test_the_command_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "sage_reddit.bulk", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA" in r.stderr
