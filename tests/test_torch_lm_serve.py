"""repro_torch ServeEngine (continuous-batching greedy decode) against the
JAX reference, ports of tests/test_serve.py on the gemma2 smoke config
with the reference's ``lm_init`` weights carried over: on the reference
test's streams the engine's tokens equal the port's own batch-1
``lm_decode_step`` loop and the reference's batch-1 loop, bf16 and int8
caches; FIFO admission into the lowest free slot; retirement frees slots;
one step program over mixed lengths; the scheduler's cooling blocks
immediate reuse; a pipelined run routes step k - 1 after step k was
launched and gives no token to a slot's next occupant; EOS retires early
(taken from the port's own sequential tokens); the step reads no tensor
value on the host and refuses rebound tensors; the CLI serves the smoke
config on the CPU. The other LM configs: granite-moe's smoke engine (MoE
blocks, whose expert capacity couples a step's slots, in the reference
too) gives the reference ``ServeEngine``'s tokens on one stream, both
admitting synchronously; codeqwen's (MHA, qkv_bias) equals its batch-1
loop and the reference's; the MoE step reads no tensor value on the host;
the CLI serves every LM smoke config. Tokens are compared exactly: greedy
argmax over float32 logits, the same function on both sides."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.gemma2_9b import smoke_config as j_smoke  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.serve import feeder as j_feeder  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.serve import feeder as t_feeder  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.serve.feeder import PreparedAdmission  # noqa: E402
from repro_torch.serve.request import Request  # noqa: E402
from repro_torch.serve.scheduler import NO_TOKEN, Scheduler  # noqa: E402

from test_torch_lm import _port_cfg  # noqa: E402
from test_torch_lm_configs import randomized  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J_CFGS = {kv: dataclasses.replace(j_smoke(), kv_cache_dtype=kv)
          for kv in ("bf16", "int8")}
J_PARAMS = jt.lm_init(J_CFGS["bf16"], jax.random.PRNGKey(0))
CFG = _port_cfg(J_CFGS["bf16"])


def _model(kv="bf16"):
    model = tt.LM(_port_cfg(J_CFGS[kv]), seed=0, device="cpu")
    return tt.load_reference_lm_params(
        model, jax.tree.map(np.asarray, J_PARAMS))


MODELS = {kv: _model(kv) for kv in J_CFGS}


def _engine(kv="bf16", **kw):
    kw = {"n_slots": 2, "max_len": 32, "prompt_cap": 8, **kw}
    m = MODELS[kv]
    return ServeEngine(m.cfg, m, device="cpu", **kw)


def _requests(n, rng, prompt_cap=8, gen_cap=6):
    return [(rng.integers(0, CFG.vocab,
                          int(rng.integers(1, prompt_cap + 1))).tolist(),
             int(rng.integers(1, gen_cap + 1))) for _ in range(n)]


def _sequential(reqs, kv="bf16", max_len=32):
    """The port's batch-1 loop: teacher-forced prefill, then greedy."""
    model = MODELS[kv]
    outs = []
    for prompt, max_new in reqs:
        cache = tt.make_cache(model.cfg, batch=1, max_len=max_len,
                              device="cpu")
        for i, t in enumerate(prompt):
            tok = tt.lm_decode_step(model, cache, torch.tensor(
                [[t]], dtype=torch.int32), i)
        out = [int(tok[0, 0])]
        for i in range(max_new - 1):
            tok = tt.lm_decode_step(model, cache, tok, len(prompt) + i)
            out.append(int(tok[0, 0]))
        outs.append(out)
    return outs


def _reference(reqs, kv="bf16", max_len=32):
    """tests/test_serve.py's ``_sequential_reference``, on the reference."""
    cfg = J_CFGS[kv]
    dec = jax.jit(lambda p, c, t, pos: jt.lm_decode_step(cfg, p, c, t, pos))
    outs = []
    for prompt, max_new in reqs:
        cache = jt.make_cache(cfg, batch=1, max_len=max_len)
        for i, t in enumerate(prompt):
            tok, cache = dec(J_PARAMS, cache, jnp.array([[t]], jnp.int32),
                             jnp.int32(i))
        out = [int(tok[0, 0])]
        for i in range(max_new - 1):
            tok, cache = dec(J_PARAMS, cache, tok,
                             jnp.int32(len(prompt) + i))
            out.append(int(tok[0, 0]))
        outs.append(out)
    return outs


def _serve(eng, reqs):
    handles = [eng.submit(p, g) for p, g in reqs]
    eng.close_submissions()
    return handles, eng.run()


# ------------------------------------------------------- end-to-end decode
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_batched_serve_matches_sequential_loop_and_reference(kv):
    """Slot independence: every request's tokens are the batch-1 loop's,
    whatever its slot neighbours do, and the reference's."""
    reqs = _requests(6, np.random.default_rng(0))
    eng = _engine(kv)
    _, completed = _serve(eng, reqs)
    assert len(completed) == len(reqs)
    want = _sequential(reqs, kv)
    assert want == _reference(reqs, kv)
    for req in completed:
        assert req.tokens_out == want[req.rid], req.rid
    assert eng.stats.tokens_generated == sum(g for _, g in reqs)


# ----------------------------------------------------- admission/retirement
def test_admission_is_fifo_and_slots_fill_lowest_first():
    reqs = _requests(7, np.random.default_rng(1), gen_cap=4)
    eng = _engine(n_slots=4)
    handles, completed = _serve(eng, reqs)
    assert len(completed) == len(reqs)
    admits = [h.admit_t for h in handles]
    assert all(a is not None for a in admits)
    assert admits == sorted(admits)
    assert [h.slot for h in handles[:4]] == [0, 1, 2, 3]
    assert all(h.admission_latency_s >= 0 for h in handles)


def test_retirement_frees_slots_for_later_requests():
    reqs = _requests(9, np.random.default_rng(2), gen_cap=5)
    eng = _engine()
    _, completed = _serve(eng, reqs)
    assert sorted(r.rid for r in completed) == list(range(9))
    for r in completed:
        assert len(r.tokens_out) == reqs[r.rid][1]
        assert all(0 <= t < CFG.vocab for t in r.tokens_out)
    assert eng.stats.admitted == eng.stats.retired == 9
    # every step counts its active slots: a request is active for its
    # prompt and its new tokens less one, and for the step that was in
    # flight when it retired
    assert eng.stats.tokens_processed == sum(len(p) + g for p, g in reqs)


def test_bucket_reuse_zero_recaptures_for_mixed_lengths():
    eng = _engine(n_slots=4)
    assert eng.step_cache_size() == 0
    eng.submit([1, 2, 3], 2)
    eng.close_submissions()
    eng.run()
    assert eng.step_cache_size() == 1
    eng.reopen()
    _, completed = _serve(eng, _requests(8, np.random.default_rng(3)))
    assert len(completed) == 8
    assert eng.step_cache_size() == 1


# ------------------------------------------------------------------- eos
def test_eos_retires_early():
    """EOS from the port's own sequential tokens: the first fresh token
    value after the first (so the cut point is unambiguous), on the first
    prompt drawn from seed 4 whose sequence has one."""
    rng = np.random.default_rng(4)
    for _ in range(50):
        prompt = rng.integers(0, CFG.vocab, 5).tolist()
        [ref] = _sequential([(prompt, 6)])
        fresh = [i for i in range(1, len(ref)) if ref[i] not in ref[:i]]
        if fresh:
            break
    else:
        pytest.fail("no drawn prompt decodes to a fresh token")
    j = fresh[0]
    eng = _engine(eos_id=ref[j])
    eng.submit(prompt, 6)
    eng.close_submissions()
    [req] = eng.run()
    assert req.tokens_out == ref[:j]  # stopped at (and without) the eos


# ------------------------------------------------- scheduler unit behavior
def _prep(rid, plen=3, max_new=2):
    req = Request(rid=rid, prompt=list(range(1, plen + 1)), max_new=max_new)
    return PreparedAdmission(req, np.zeros(8, np.int32))


def test_scheduler_cooling_blocks_immediate_slot_reuse():
    """A retired slot survives one more process() cycle before reuse: the
    step in flight at retirement may still emit a stale token for the old
    request, which must not go to a new occupant."""
    s = Scheduler(n_slots=1)
    s.admit(_prep(0, max_new=1))
    finished = s.process(np.array([7]))
    assert [r.rid for _, r in finished] == [0]
    assert not s.has_free_slot
    assert s.process(np.array([9])) == []  # the stale token, ignored
    assert s.has_free_slot
    assert s.admit(_prep(1, max_new=2)) == 0
    s.process(np.array([NO_TOKEN]))
    assert s._slots[0].tokens_out == []
    s.process(np.array([4]))
    assert s._slots[0].tokens_out == [4]
    # an engine that keeps no step in flight frees at once
    s2 = Scheduler(n_slots=1, route=lambda req, e: True)
    s2.admit(_prep(2))
    s2.process(np.array([0]))
    s2.flush_cooling()
    assert s2.has_free_slot


def test_pipelined_run_routes_the_previous_step_while_the_next_is_queued():
    """With one slot and three requests: step k's tokens are routed only
    after step k + 1 was launched (one step in flight), except in the
    drain right after a retirement, when nothing is active; the step in
    flight when a request retired emits a stale token that goes to nobody,
    so each request's tokens are its batch-1 loop's."""
    reqs = _requests(3, np.random.default_rng(5), gen_cap=4)
    eng = _engine(n_slots=1)
    events = []  # ("step", launched so far) / ("route", retired by it)
    step, process = eng._step, eng._process

    def traced_step():
        events.append(("step", None))
        return step()

    def traced_process(emitted, completed):
        n = len(completed)
        process(emitted, completed)
        events.append(("route", len(completed) - n))
    eng._step, eng._process = traced_step, traced_process
    _, completed = _serve(eng, reqs)
    want = _sequential(reqs)
    assert {r.rid: r.tokens_out for r in completed} == dict(enumerate(want))
    launched = routed = 0
    retired_before = False
    for kind, n in events:
        if kind == "step":
            launched += 1
            continue
        # routing step `routed`: the next step was launched, or this is
        # the drain after a retirement
        assert launched == routed + 2 or (launched == routed + 1
                                          and retired_before), events
        retired_before = n > 0
        routed += 1
    assert routed == launched
    # a request is active for its prompt, its new tokens less one, and the
    # step in flight when it retired
    assert eng.stats.steps == sum(len(p) + g for p, g in reqs)


# ------------------------------------------------------------ step guards
def test_step_reads_no_tensor_value_on_the_host(monkeypatch):
    """The step function never brings a tensor value to the host nor
    builds a tensor from host data: on the card either would break the
    CUDA graph capture."""
    eng = _engine("int8")
    eng._admit_many([(0, _prep(0, plen=3)), (1, _prep(1, plen=1))])

    def refuse(*a, **k):
        raise AssertionError("host read of a tensor value inside the step")
    for name in ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
                 "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "tensor", refuse)
    eng.step_fn(eng.params, eng.state)
    monkeypatch.undo()
    assert eng.state["pos"].tolist() == [1, 1]
    assert eng.state["emitted"].tolist()[0] == NO_TOKEN  # still prefilling
    assert eng.state["emitted"].tolist()[1] != NO_TOKEN


@pytest.mark.parametrize("what", ["state.pos", "cache.local.k", "model."])
def test_step_refuses_tensors_rebound_since_it_was_built(what):
    eng = _engine()
    eng.submit([1, 2], 1)
    eng.close_submissions()
    eng.run()
    if what == "state.pos":
        eng.state["pos"] = eng.state["pos"].clone()
    elif what == "cache.local.k":
        eng.state["cache"]["local"]["k"] = (
            eng.state["cache"]["local"]["k"].clone())
    else:
        w = next(eng.params.parameters())
        w.data = w.data.clone()
    eng.reopen()
    eng.submit([3], 1)
    eng.close_submissions()
    with pytest.raises(RuntimeError, match=what.replace(".", r"\.")):
        eng.run()
    assert eng.step_cache_size() == 1


def test_submit_guards_and_unported_mesh():
    eng = _engine()
    with pytest.raises(ValueError, match="prompt length"):
        eng.submit([], 1)
    with pytest.raises(ValueError, match="prompt length"):
        eng.submit(list(range(9)), 1)
    with pytest.raises(ValueError, match="exceeds KV bucket"):
        eng.submit([1] * 8, 25)
    with pytest.raises(ValueError, match="out of range"):
        eng.submit([CFG.vocab], 1)
    m = MODELS["bf16"]
    with pytest.raises(TypeError, match="DeviceMesh"):
        ServeEngine(m.cfg, m, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="prompt_cap"):
        ServeEngine(m.cfg, m, max_len=8, prompt_cap=16, device="cpu")
    assert eng.max_len == 32 and eng.prompt_cap == 8 and eng.n_slots == 2


# ------------------------------------------------------------------- CLI
def test_cli_serves_the_smoke_config_on_the_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gemma2-9b", "--smoke", "--device", "cpu", "--requests", "6"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert sum(line.startswith("req") for line in lines) == 6
    assert any("tok/s" in line and "1 step program" in line
               for line in lines), r.stdout
    assert any(line.startswith("admission latency p50=") for line in lines)


# ------------------------------------------------- the other LM configs
def _other(arch, seed=0):
    """(reference config, its params with seeded biases and norm scales,
    the port's model of them)."""
    jcfg = jconfigs.get_config(arch, smoke=True)
    params = randomized(jcfg, jt.lm_init(jcfg, jax.random.PRNGKey(seed)),
                        seed)
    model = tt.LM(_port_cfg(jcfg), seed=seed, device="cpu")
    tt.load_reference_lm_params(model, jax.tree.map(np.asarray, params))
    return jcfg, params, model


def _synchronous_polls(monkeypatch):
    """Both packages' admission feeders made synchronous: a poll waits for
    the next prepared request until the stream is over, so a run admits
    whenever a slot is free, whatever the threads' timing, and two engines
    see the same slots at every step."""
    for mod in (j_feeder, t_feeder):
        poll = mod.AdmissionFeeder.poll

        def synchronous(self, timeout=None, poll=poll):
            while not self.done:
                got = poll(self, timeout=0.01)
                if got is not None:
                    return got
            return None
        monkeypatch.setattr(mod.AdmissionFeeder, "poll", synchronous)


def test_moe_engine_gives_the_reference_engines_tokens(monkeypatch):
    """granite-moe's smoke config (8 experts, top-4): a step's slots share
    the experts' capacity (cap = int(1.25 * 4 * 4 / 8 + 0.5) = 3 at 4
    slots), so a request's tokens depend on its neighbours, idle slots
    included, in the reference as here: the port's engine is held against
    the reference's ServeEngine on the same stream and slot count, not
    against a batch-1 loop."""
    _synchronous_polls(monkeypatch)
    jcfg, params, model = _other("granite-moe-1b-a400m")
    rng = np.random.default_rng(11)
    reqs = [(rng.integers(0, jcfg.vocab,
                          int(rng.integers(1, 9))).tolist(),
             int(rng.integers(1, 7))) for _ in range(7)]
    kw = dict(n_slots=4, max_len=32, prompt_cap=8)
    eng = ServeEngine(model.cfg, model, device="cpu", **kw)
    _, completed = _serve(eng, reqs)
    jeng = JServeEngine(jcfg, params, **kw)
    _, jcompleted = _serve(jeng, reqs)
    got = {r.rid: r.tokens_out for r in completed}
    want = {r.rid: r.tokens_out for r in jcompleted}
    assert got == want
    assert [len(got[i]) for i in range(len(reqs))] == [g for _, g in reqs]
    assert eng.stats.steps == jeng.stats.steps
    assert eng.step_cache_size() == 1


def _sequential_model(model, reqs, max_len=32):
    """The port's batch-1 loop on ``model``."""
    outs = []
    for prompt, max_new in reqs:
        cache = tt.make_cache(model.cfg, batch=1, max_len=max_len,
                              device="cpu")
        for i, t in enumerate(prompt):
            tok = tt.lm_decode_step(model, cache, torch.tensor(
                [[t]], dtype=torch.int32), i)
        out = [int(tok[0, 0])]
        for i in range(max_new - 1):
            tok = tt.lm_decode_step(model, cache, tok, len(prompt) + i)
            out.append(int(tok[0, 0]))
        outs.append(out)
    return outs


def _reference_model(jcfg, params, reqs, max_len=32):
    """The reference's batch-1 loop."""
    dec = jax.jit(lambda p, c, t, pos: jt.lm_decode_step(jcfg, p, c, t,
                                                         pos))
    outs = []
    for prompt, max_new in reqs:
        cache = jt.make_cache(jcfg, batch=1, max_len=max_len)
        for i, t in enumerate(prompt):
            tok, cache = dec(params, cache, jnp.array([[t]], jnp.int32),
                             jnp.int32(i))
        out = [int(tok[0, 0])]
        for i in range(max_new - 1):
            tok, cache = dec(params, cache, tok, jnp.int32(len(prompt) + i))
            out.append(int(tok[0, 0]))
        outs.append(out)
    return outs


def test_dense_engine_of_another_config_equals_its_batch1_loop():
    """codeqwen's smoke config (MHA, qkv_bias, the stacked cache): every
    request's tokens are the port's batch-1 loop's and the reference's,
    whatever its slot neighbours do."""
    jcfg, params, model = _other("codeqwen1.5-7b", seed=1)
    rng = np.random.default_rng(12)
    reqs = [(rng.integers(0, jcfg.vocab,
                          int(rng.integers(1, 9))).tolist(),
             int(rng.integers(1, 7))) for _ in range(6)]
    eng = ServeEngine(model.cfg, model, n_slots=2, max_len=32,
                      prompt_cap=8, device="cpu")
    assert list(eng.state["cache"]) == ["blocks"]
    _, completed = _serve(eng, reqs)
    want = _sequential_model(model, reqs)
    assert want == _reference_model(jcfg, params, reqs)
    assert {r.rid: r.tokens_out for r in completed} == dict(enumerate(want))


def test_moe_step_reads_no_tensor_value_on_the_host(monkeypatch):
    """granite-moe's step (the MoE dispatch included) brings no tensor
    value to the host and builds no tensor from host data."""
    _, _, model = _other("granite-moe-1b-a400m")
    eng = ServeEngine(model.cfg, model, n_slots=2, max_len=32,
                      prompt_cap=8, device="cpu")
    eng._admit_many([(0, _prep(0, plen=3)), (1, _prep(1, plen=1))])

    def refuse(*a, **k):
        raise AssertionError("host read of a tensor value inside the step")
    for name in ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
                 "__float__", "__index__", "nonzero"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "nonzero", refuse)
    eng.step_fn(eng.params, eng.state)
    monkeypatch.undo()
    assert eng.state["pos"].tolist() == [1, 1]
    assert eng.state["emitted"].tolist()[1] != NO_TOKEN


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "codeqwen1.5-7b",
                                  "qwen1.5-32b", "grok-1-314b"])
def test_cli_serves_each_lm_smoke_config(arch):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", "--device", "cpu", "--requests", "3", "--gen", "4"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert sum(line.startswith("req") for line in lines) == 3
    assert any("tok/s" in line and "1 step program" in line
               for line in lines), r.stdout
