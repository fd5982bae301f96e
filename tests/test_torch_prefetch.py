"""repro_torch engine.prefetch: the cases of tests/test_engine_prefetch.py
but the sampler's (the port has no data/sampler.py yet, ROADMAP.md A.5):
batches in step order, the producer at most ``depth`` ahead, sticky
exhaustion, a producer exception relayed to the consumer, the generator
closing its producer, the train loop with prefetch equal to the
synchronous loop and deterministic across a crash and resume. Also the
batch walk (NamedTuples, dataclasses, tuples, lists, dicts), ``device=``,
the live-producer count a serve capture checks, and the launch counters
bumped from many threads. On the CPU there are no streams; the side-stream
behaviour is a ``gpu`` test."""
import threading
import time
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.engine import prefetch as tpf  # noqa: E402
from repro_torch.engine.prefetch import (Prefetcher, SyncBatches,  # noqa: E402
                                         prefetch_batches)
from repro_torch.kernels import count_launch  # noqa: E402
from repro_torch.kernels import merge as tm  # noqa: E402
from repro_torch.train import optim as to  # noqa: E402
from repro_torch.train.loop import FailureInjector, LoopConfig, train  # noqa: E402


# ------------------------------------------------------------------ ordering
def test_prefetch_yields_batches_in_step_order():
    with Prefetcher(lambda s: s * 10, start=3, stop=9) as pf:
        got = list(pf)
    assert got == [(s, s * 10) for s in range(3, 9)]
    with SyncBatches(lambda s: s * 10, start=3, stop=9) as it:
        assert list(it) == got


def test_prefetch_overlaps_producer_with_consumer():
    """The producer is at most ``depth`` ahead, never behind."""
    produced = []

    def batch_fn(s):
        produced.append(s)
        return s

    with Prefetcher(batch_fn, start=0, stop=32, depth=1) as pf:
        step0 = next(pf)
        time.sleep(0.05)
        ahead = len(produced)
        assert step0 == (0, 0)
        assert ahead <= 3, produced
        rest = list(pf)
    assert [s for s, _ in [step0] + rest] == list(range(32))


def test_prefetch_exhaustion_is_sticky():
    pf = Prefetcher(lambda s: s, start=0, stop=3)
    assert list(pf) == [(0, 0), (1, 1), (2, 2)]
    for _ in range(3):
        with pytest.raises(StopIteration):
            next(pf)
    pf.close()


def test_prefetch_error_propagates_and_closes():
    def bad(s):
        if s == 2:
            raise RuntimeError("boom at 2")
        return s

    pf = Prefetcher(bad, start=0, stop=10)
    out = []
    with pytest.raises(RuntimeError, match="boom at 2"):
        for s, _ in pf:
            out.append(s)
    assert out == [0, 1]
    pf.close()  # idempotent
    assert tpf.active_producers() == 0


def test_prefetch_generator_form_closes_producer():
    gen = prefetch_batches(lambda s: s, start=0, stop=100)
    assert next(gen) == (0, 0)
    gen.close()  # must not hang on the full queue
    assert tpf.active_producers() == 0
    assert threading.active_count() < 50


# ------------------------------------------------------------- batch walk
class Pair(NamedTuple):
    a: torch.Tensor
    b: object


def test_batches_of_nested_tensors_move_to_the_device_whole():
    """``device=`` maps every tensor of a NamedTuple, a dataclass (a COO),
    a dict and a list, and leaves the rest as it is."""
    def batch_fn(s):
        coo = tg.COO(dst=torch.full((4,), s, dtype=torch.int32),
                     src=torch.zeros(4, dtype=torch.int32),
                     n_edges=torch.tensor(4, dtype=torch.int32), n_nodes=9)
        return {"pair": Pair(torch.tensor([s]), "tag"), "coo": coo,
                "list": [torch.ones(2) * s, 3]}

    with Prefetcher(batch_fn, stop=3, device="cpu") as pf:
        got = list(pf)
    for s, batch in got:
        assert isinstance(batch["pair"], Pair) and batch["pair"].b == "tag"
        assert isinstance(batch["coo"], tg.COO) and batch["coo"].n_nodes == 9
        assert torch.equal(batch["coo"].dst, torch.full((4,), s,
                                                        dtype=torch.int32))
        assert batch["list"][1] == 3
    assert len(tpf._tensors(got[0][1])) == 5
    assert tpf._side_stream("cpu") is None


def test_live_producers_are_counted_until_closed():
    """A serve step's CUDA graph capture refuses to run beside a producer
    (its launch count would take the producer's launches)."""
    release = threading.Event()

    def batch_fn(s):
        release.wait(5.0)
        return s

    pf = Prefetcher(batch_fn, stop=4)
    assert tpf.active_producers() == 1
    release.set()
    assert [s for s, _ in pf] == [0, 1, 2, 3]
    pf.close()
    assert tpf.active_producers() == 0


def test_launch_counters_are_exact_under_many_threads():
    """More threads than cores, switching every microsecond, bump one
    counter through count_launch 5,000 times each: the count is exact."""
    import os
    import sys
    n = (os.cpu_count() or 2) + 2
    before = tm.merge_rung.launches

    def bump():
        for _ in range(5_000):
            count_launch(tm.merge_rung)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert tm.merge_rung.launches - before == 5_000 * n
    tm.merge_rung.launches = before


# ------------------------------------------------------------- train loop
def _toy_problem():
    params = {"w": torch.tensor([4.0])}
    opt = to.adamw_init(params)
    cfg = to.AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=1)

    def step_fn(p, o, batch):
        w = p["w"].detach().requires_grad_()
        loss = torch.sum((w - batch) ** 2)
        loss.backward()
        m = to.adamw_update(cfg, {"w": w.grad}, o, p)
        return p, o, {"loss": loss.detach(), **m}

    def batch_fn(step):
        return torch.tensor(float(step + 1))  # pure f(step)

    return params, opt, step_fn, batch_fn


def test_train_loop_prefetch_equals_sync(tmp_path):
    runs = []
    for prefetch in (False, True):
        params, opt, step_fn, batch_fn = _toy_problem()
        cfg = LoopConfig(total_steps=17, ckpt_every=100, log_every=1,
                         ckpt_dir=str(tmp_path / str(prefetch)),
                         prefetch=prefetch)
        runs.append(train(cfg, step_fn, params, opt, batch_fn))
    (p1, _, h1), (p2, _, h2) = runs
    assert torch.equal(p1["w"], p2["w"]) and h1 == h2
    assert tpf.active_producers() == 0


def test_train_loop_prefetch_resume_determinism(tmp_path):
    """Crash and resume with prefetch on: the final state of a run that
    never crashed."""
    params, opt, step_fn, batch_fn = _toy_problem()
    cfg = LoopConfig(total_steps=12, ckpt_every=4, ckpt_dir=str(tmp_path / "a"),
                     log_every=100, prefetch=True)
    with pytest.raises(RuntimeError, match="injected failure"):
        train(cfg, step_fn, params, opt, batch_fn,
              failure=FailureInjector(fail_at_step=9))
    assert tpf.active_producers() == 0
    p, _, _ = train(cfg, step_fn, params, opt, batch_fn)
    params2, opt2, step_fn2, batch_fn2 = _toy_problem()
    clean = LoopConfig(total_steps=12, ckpt_every=4, log_every=100,
                       ckpt_dir=str(tmp_path / "b"))
    p2, _, _ = train(clean, step_fn2, params2, opt2, batch_fn2)
    assert torch.equal(p["w"], p2["w"])
    assert np.isfinite(float(p["w"]))


def test_run_lm_with_prefetch_equals_without(tmp_path):
    """``launch/train.run_lm`` on the gemma2-9b smoke config, 3 steps,
    with and without prefetch: the same history and weights."""
    from repro_torch.launch.train import run_lm
    runs = [run_lm("gemma2-9b", 3, True, str(tmp_path / str(p)), None,
                   device="cpu", prefetch=p) for p in (False, True)]
    (m0, _, h0), (m1, _, h1) = runs
    assert h0 == h1 and len(h0) == 2
    for (n, p), q in zip(m0.named_parameters(), m1.parameters()):
        assert torch.equal(p, q), n
