"""repro_torch LM training path against the JAX reference, on gemma2-9b's
smoke configuration (4 layers, d 64, window 8, both softcaps, tied head)
with the reference's ``lm_init`` weights carried over by
``load_reference_lm_params``:

* ``lm_loss`` and every parameter's gradient against
  ``jax.value_and_grad(lm_loss)``: loss within 1e-5, each gradient within
  rtol 1e-4 / atol 1e-6 of the reference's (float32; the two frameworks
  round the same sums in other orders: the largest error read is 3.4e-7,
  the worst relative L2 error of a parameter 2.0e-6), and the same with
  remat on (equal bits to remat off);
* ``cross_entropy`` with and without a mask, ``global_norm``, and
  ``adamw_update`` from a carried non-zero state
  (``load_reference_opt_state``) with clipping, warmup and float32 or
  bf16 moments: parameters within 1e-6, moments within 1e-6 relative and
  1e-7 absolute (float32) or one bf16 ulp;
* ``lm_batch`` bit-equal; the train cell's step against the reference
  ``_lm_cell`` train step on the smoke config;
* the checkpoint and loop cases of ``tests/test_train_substrate.py``
  (roundtrip, keep-k, a partial write ignored, restart-equivalence after
  an injected failure, the straggler watchdog) and the ``launch/train``
  CLI's fail-and-resume.

Inputs are numpy arrays from a seed, handed to both packages."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import LM_SHAPES as J_LM_SHAPES  # noqa: E402
from repro.configs.gemma2_9b import smoke_config as j_smoke  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import common as jc  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.train import optim as jo  # noqa: E402
from repro_torch.configs import LM_SHAPES  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import common as tc  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optim as to  # noqa: E402
from repro_torch.train.loop import (FailureInjector, LoopConfig,  # noqa: E402
                                    state_tensors, train)

SEQ = 32
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def _port_cfg(jcfg, **over):
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    fields["dtype"] = (torch.bfloat16 if jcfg.dtype == jnp.bfloat16
                       else torch.float32)
    return tt.LMConfig(**{**fields, **over})


def _pair(jcfg, seed=0, **over):
    """(reference params, port model with those params)."""
    params = jt.lm_init(jcfg, jax.random.PRNGKey(seed))
    model = tt.LM(_port_cfg(jcfg, **over), seed=seed, device="cpu")
    tt.load_reference_lm_params(model, jax.tree.map(np.asarray, params))
    return params, model


def _tokens(vocab, b=2, s=SEQ, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _port_loss_grads(model, toks):
    for p in model.parameters():
        p.grad = None
    loss = tt.lm_loss(model, torch.from_numpy(toks))
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in model.named_parameters()}


def _assert_grads_close(model, got, want_tree):
    for name, g in got.items():
        want = tt.reference_leaf(model, want_tree, name)
        np.testing.assert_allclose(g.numpy(), want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


# ------------------------------------------------------------------ model
def test_train_shape_equals_reference():
    assert LM_SHAPES["train_4k"] == J_LM_SHAPES["train_4k"]


@pytest.mark.parametrize("remat", [False, True])
def test_lm_loss_and_grads_match_reference(remat):
    jcfg = j_smoke()
    params, model = _pair(jcfg, remat=remat)
    toks = _tokens(jcfg.vocab)
    want_loss, want = jax.value_and_grad(
        lambda p: jt.lm_loss(jcfg, p, jnp.asarray(toks)))(params)
    loss, got = _port_loss_grads(model, toks)
    assert abs(float(loss) - float(want_loss)) <= 1e-5
    assert len(got) == len(list(model.parameters()))
    _assert_grads_close(model, got, jax.tree.map(np.asarray, want))


def test_remat_on_and_off_give_equal_grads():
    jcfg = j_smoke()
    toks = _tokens(jcfg.vocab, seed=1)
    runs = []
    for remat in (False, True):
        _, model = _pair(jcfg, remat=remat)
        runs.append(_port_loss_grads(model, toks))
    assert torch.equal(runs[0][0], runs[1][0])
    for name, g in runs[0][1].items():
        assert torch.equal(g, runs[1][1][name]), name


def test_remat_recomputes_each_pair_in_the_backward(monkeypatch):
    """With remat the attention runs twice per layer (forward and the
    backward's recompute), without it once; prefill never recomputes."""
    jcfg = j_smoke()
    calls = []
    real = tt.flash_attention_bhsd

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(tt, "flash_attention_bhsd", counted)
    toks = _tokens(jcfg.vocab)
    for remat, want in ((False, 4), (True, 8)):
        _, model = _pair(jcfg, remat=remat)
        calls.clear()
        _port_loss_grads(model, toks)
        assert len(calls) == want
    calls.clear()
    tt.lm_prefill(model, torch.from_numpy(toks))
    assert len(calls) == 4


@pytest.mark.parametrize("with_mask", [False, True])
def test_cross_entropy_matches_reference(with_mask):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(3, 7, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if with_mask \
        else None
    want = jc.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            None if mask is None else jnp.asarray(mask))
    got = tc.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                           None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_cross_entropy_all_masked_is_zero():
    got = tc.cross_entropy(torch.zeros(2, 5), torch.zeros(2, dtype=torch.int32),
                           torch.zeros(2))
    assert float(got) == 0.0


# -------------------------------------------------------------- optimizer
def _random_tree(tree, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: jnp.asarray(
        (rng.normal(size=a.shape) * scale).astype(np.float32)), tree)


def test_global_norm_matches_reference():
    tree = _random_tree(jt.lm_init(j_smoke(), jax.random.PRNGKey(0)), 3)
    want = jo.global_norm(tree)
    got = to.global_norm({str(i): torch.from_numpy(np.array(a))
                          for i, a in enumerate(jax.tree.leaves(tree))})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(to.global_norm({"a": torch.tensor([3.0]),
                                 "b": torch.tensor([4.0])})) == 5.0


@pytest.mark.parametrize("mom", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip,grad_scale", [(1.0, 1.0), (1.0, 1e-3),
                                             (0.0, 1.0)])
def test_adamw_update_matches_reference(mom, clip, grad_scale):
    """Two reference updates build a non-zero state (step 2, inside the
    warmup); the port, carried to that state, takes the third."""
    jcfg = j_smoke()
    params, model = _pair(jcfg)
    jdt = jnp.bfloat16 if mom == "bfloat16" else jnp.float32
    tdt = getattr(torch, mom)
    jcfg_o = jo.AdamWConfig(lr=1e-2, grad_clip=clip, warmup_steps=5,
                            mom_dtype=jdt)
    tcfg_o = to.AdamWConfig(lr=1e-2, grad_clip=clip, warmup_steps=5,
                            mom_dtype=tdt)
    state = jo.adamw_init(params, jdt)
    for s in (4, 5):
        params, state, _ = jo.adamw_update(
            jcfg_o, _random_tree(params, s, grad_scale), state, params)
    tt.load_reference_lm_params(model, jax.tree.map(np.asarray, params))
    named = dict(model.named_parameters())
    tstate = tt.load_reference_opt_state(
        model, to.adamw_init(named, tdt), jax.tree.map(np.asarray, state))
    assert int(tstate["step"]) == 2
    grads = _random_tree(params, 6, grad_scale)
    want_p, want_s, want_m = jo.adamw_update(jcfg_o, grads, state, params)
    got_m = to.adamw_update(
        tcfg_o, {n: torch.from_numpy(np.array(tt.reference_leaf(
            model, jax.tree.map(np.asarray, grads), n))) for n in named},
        tstate, named)
    np.testing.assert_allclose(float(got_m["grad_norm"]),
                               float(want_m["grad_norm"]), rtol=1e-6)
    assert got_m["lr"] == float(want_m["lr"])
    assert int(tstate["step"]) == int(want_s["step"]) == 3
    want_p = jax.tree.map(np.asarray, want_p)
    want_s = jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), want_s)
    # one bf16 ulp; in float32 the port fuses b1·m + (1 - b1)·g into one
    # rounding where the reference rounds twice: 1e-6 relative, and 1e-7
    # absolute where the two terms cancel (an ulp of terms up to ~1)
    mom_tol = 2 ** -7 if mom == "bfloat16" else 1e-6
    for n, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   tt.reference_leaf(model, want_p, n),
                                   rtol=1e-6, atol=1e-6, err_msg=n)
        for key in ("m", "v"):
            assert tstate[key][n].dtype == tdt
            np.testing.assert_allclose(
                tstate[key][n].float().numpy(),
                tt.reference_leaf(model, want_s[key], n), rtol=mom_tol,
                atol=1e-7, err_msg=f"{key}.{n}")


def test_grad_clip_bounds_update():
    params = {"w": torch.zeros(4)}
    cfg = to.AdamWConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0,
                         warmup_steps=1)
    m = to.adamw_update(cfg, {"w": torch.full((4,), 1e6)},
                        to.adamw_init(params), params)
    assert float(m["grad_norm"]) == pytest.approx(2e6)
    assert bool((params["w"].abs() < 1.5).all())


# ------------------------------------------------------------------ data
def test_lm_batch_bit_equal_to_reference():
    for seed, step in ((0, 0), (3, 17)):
        want = jsyn.lm_batch(seed, step, 4, 64, 256000)
        got = tsyn.lm_batch(seed, step, 4, 64, 256000)
        assert got.dtype == want.dtype and np.array_equal(got, want)


# -------------------------------------------------------------- the cell
def test_train_cell_step_matches_reference_cell(monkeypatch):
    """The port's ``lm_train_cell`` (smoke) against the reference
    ``_lm_cell("gemma2-9b", "train_4k")`` train step on a 1 × 1 mesh with
    the smoke config: loss, grad norm, lr, and the updated parameters."""
    import repro.launch.steps as jsteps
    monkeypatch.setattr(jsteps, "get_config",
                        lambda arch, smoke=False: j_smoke())
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jcell = jsteps._lm_cell("gemma2-9b", "train_4k", mesh)
    cell = tsteps.lm_train_cell("gemma2-9b", seq_len=SEQ, batch=2,
                                device="cpu", smoke=True)
    assert cell.opt_cfg == to.AdamWConfig()  # float32 moments, as gemma2's
    params = jt.lm_init(j_smoke(), jax.random.PRNGKey(0))
    tt.load_reference_lm_params(cell.model, jax.tree.map(np.asarray, params))
    toks = cell.tokens.numpy()
    np.testing.assert_array_equal(toks, jsyn.lm_batch(0, 0, 2, SEQ, 256))
    with mesh:
        want_p, want_s, want_m = jax.jit(jcell.fn)(
            params, jo.adamw_init(params), jnp.asarray(toks))
    got = cell.step()
    assert set(got) == {"loss", "grad_norm", "lr"}
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(got[key]), float(want_m[key]),
                                   rtol=1e-5, err_msg=key)
    assert got["lr"] == float(want_m["lr"])
    want_p = jax.tree.map(np.asarray, want_p)
    for n, p in cell.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   tt.reference_leaf(cell.model, want_p, n),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
        assert p.grad is None


def test_train_cell_cuts_depth_and_keeps_widths():
    cell = tsteps.lm_train_cell("gemma2-9b", n_layers=2, seq_len=64, batch=1,
                                device="cpu", smoke=True)
    assert len(cell.model.layers) == 2
    assert cell.model.cfg.d_model == j_smoke().d_model
    assert tuple(cell.tokens.shape) == (1, 64)
    assert set(cell.opt_state["m"]) == {
        n for n, _ in cell.model.named_parameters()}


# ------------------------------------------------------------ checkpoint
def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(5, dtype=torch.float32),
            "b.c": torch.randn(2, 3).to(torch.bfloat16),
            "step": torch.tensor(7, dtype=torch.int32)}
    ckpt.save(str(tmp_path), 7, tree)
    restored, meta = ckpt.restore(str(tmp_path), 7, tree)
    assert meta["step"] == 7 and meta["dtypes"][1] == "bfloat16"
    for k, t in tree.items():
        assert restored[k].dtype == t.dtype and torch.equal(restored[k], t)
    with np.load(tmp_path / "step_000000007" / "arrays.npz") as data:
        assert data["a1"].dtype == np.uint16
    with pytest.raises(ValueError, match="mismatch"):
        ckpt.restore(str(tmp_path), 7, {"a": tree["a"]})


def test_checkpoint_keep_k_and_latest(tmp_path):
    tree = {"x": torch.zeros(1)}
    for s in [10, 20, 30, 40]:
        ckpt.save(str(tmp_path), s, tree, keep=2)
    assert ckpt.all_steps(str(tmp_path)) == [30, 40]
    assert ckpt.latest_step(str(tmp_path)) == 40


def test_checkpoint_partial_write_ignored(tmp_path):
    ckpt.save(str(tmp_path), 5, {"x": torch.zeros(3)})
    os.makedirs(tmp_path / "step_000000009.tmp")  # a crash mid-write
    assert ckpt.latest_step(str(tmp_path)) == 5


# --------------------------------------------------------- fault tolerance
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
        return torch.tensor(float(step % 3))  # pure f(step)

    return params, opt, step_fn, batch_fn


def test_restart_equivalence_after_injected_failure(tmp_path):
    """Crash at step 12, restart, final params equal a clean run's."""
    params, opt, step_fn, batch_fn = _toy_problem()
    cfg = LoopConfig(total_steps=20, ckpt_every=5, ckpt_dir=str(tmp_path),
                     log_every=1)
    with pytest.raises(RuntimeError, match="injected failure"):
        train(cfg, step_fn, params, opt, batch_fn,
              failure=FailureInjector(12))
    params, opt, step_fn, batch_fn = _toy_problem()  # a fresh process
    p1, o1, hist = train(cfg, step_fn, params, opt, batch_fn)
    assert hist[0]["step"] == 10  # resumed, not restarted
    assert int(o1["step"]) == 20

    params2, opt2, step_fn2, batch_fn2 = _toy_problem()
    cfg2 = LoopConfig(total_steps=20, ckpt_every=5,
                      ckpt_dir=str(tmp_path) + "_clean", log_every=1)
    p2, o2, hist2 = train(cfg2, step_fn2, params2, opt2, batch_fn2)
    assert torch.equal(p1["w"], p2["w"])
    assert hist == hist2[10:]
    assert set(state_tensors(p2, o2)) == {"w", "m.w", "v.w", "step"}


def test_straggler_watchdog_fires(tmp_path):
    params, opt, step_fn, batch_fn = _toy_problem()

    def slow_step(p, o, b):
        import time
        time.sleep(0.2)
        return step_fn(p, o, b)

    cfg = LoopConfig(total_steps=3, ckpt_every=100, ckpt_dir=str(tmp_path),
                     step_timeout_s=0.05)
    with pytest.raises(TimeoutError, match="straggler"):
        train(cfg, slow_step, params, opt, batch_fn)


def test_prefetch_names_the_unported_engine_service(tmp_path):
    """The engine service's Prefetcher is ported: ``prefetch=True`` no
    longer raises, and it trains what the synchronous loop trains."""
    params, opt, step_fn, batch_fn = _toy_problem()
    cfg = LoopConfig(total_steps=7, ckpt_dir=str(tmp_path / "p"),
                     log_every=1, prefetch=True)
    p1, _, h1 = train(cfg, step_fn, params, opt, batch_fn)
    params, opt, step_fn, batch_fn = _toy_problem()
    cfg = LoopConfig(total_steps=7, ckpt_dir=str(tmp_path / "s"),
                     log_every=1)
    p2, _, h2 = train(cfg, step_fn, params, opt, batch_fn)
    assert torch.equal(p1["w"], p2["w"]) and h1 == h2


def test_run_lm_resumes_after_injected_failure(tmp_path):
    """``launch/train.run_lm`` on the smoke config (a checkpoint every 10
    steps): a run that crashes at step 13 and resumes from its step-10
    checkpoint ends where an uninterrupted run ends, with the same
    history after the resume."""
    steps = 24
    kw = dict(arch="gemma2-9b", steps=steps, smoke=True, device="cpu")
    with pytest.raises(RuntimeError, match="injected failure"):
        tlaunch.run_lm(ckpt_dir=str(tmp_path / "a"), fail_at=13, **kw)
    m1, o1, h1 = tlaunch.run_lm(ckpt_dir=str(tmp_path / "a"), fail_at=None,
                                **kw)
    m2, o2, h2 = tlaunch.run_lm(ckpt_dir=str(tmp_path / "b"), fail_at=None,
                                **kw)
    assert int(o1["step"]) == int(o2["step"]) == steps
    assert h1[0]["step"] == 10
    assert h1 == [h for h in h2 if h["step"] >= 10]
    for (n, p), q in zip(m1.named_parameters(), m2.parameters()):
        assert torch.equal(p, q), n


def test_gnn_and_recsys_training_name_their_roadmap_items(tmp_path,
                                                          capsys):
    """GNN and recommender training are ported: ``main`` runs ``run_gnn``
    and ``run_recsys`` (dlrm-rm2's smoke config, its default 50 steps)."""
    tlaunch.main(["--arch", "graphsage-reddit", "--smoke", "--steps", "2",
                  "--device", "cpu", "--ckpt-dir", str(tmp_path / "g")])
    assert "'step': 1" in capsys.readouterr().out
    tlaunch.main(["--arch", "dlrm-rm2", "--smoke", "--device", "cpu",
                  "--ckpt-dir", str(tmp_path / "r")])
    out = capsys.readouterr().out
    assert "'step': 0" in out and "'step': 49" in out
