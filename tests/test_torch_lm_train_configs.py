"""LM training of the configs beyond gemma2 against the JAX reference, on
the CPU at smoke size: granite-moe-1b-a400m (MoE 8 experts top-4, GQA,
tied), codeqwen1.5-7b (MHA, qkv_bias), qwen1.5-32b (MHA, qkv_bias) and
grok-1-314b (MoE 4 experts top-2, GQA), with the reference's ``lm_init``
weights (biases and norm scales drawn from a seed,
``test_torch_lm_configs.randomized``) carried over under both layer
layouts (the stacked ``blocks`` and the unrolled ``blocks_list``):

* ``lm_loss`` and every gradient leaf against ``jax.value_and_grad`` of
  the reference's ``lm_loss``, remat on and off; remat on and off give
  equal bits, and remat runs each layer's attention and MoE twice (the
  forward and the backward's recompute), once without;
* the MoE layer's gradients (x, router and the three expert weights)
  against the reference's ``moe_apply`` with capacity factors that drop
  pairs and with planted router ties; ``lm_loss`` and its gradients with
  a dropping capacity in both models;
* one step of ``lm_train_cell`` against the reference ``_lm_cell``
  train step on a 1 × 1 mesh (loss, grad norm, lr, updated parameters);
* ``run_lm`` crashed and resumed against a clean run.

Tolerances are ``test_torch_train.py``'s: the loss within 1e-5, each
gradient within rtol ``GRAD_RTOL`` = 1e-4 and atol ``GRAD_ATOL`` = 1e-6 of
the reference's (float32 sums in other orders; measured at most 3.2e-6 of
a leaf's largest value, codeqwen's ``layers.1.bk``, on a CPU); the
cell's parameters within 1e-6 after a step."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.launch import steps as jsteps  # noqa: E402
from repro.models import moe as jm  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.train import optim as jo  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import moe as tm  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.train import optim as to  # noqa: E402

from test_torch_lm_configs import ARCHS, _jcfg, _pair, _tokens  # noqa: E402
from test_torch_moe import _weights, _x  # noqa: E402
from test_torch_train import GRAD_ATOL, GRAD_RTOL  # noqa: E402

MOE_ARCHS = ["granite-moe-1b-a400m", "grok-1-314b"]
DROPPING = 0.5


def _port_loss_grads(model, toks):
    for p in model.parameters():
        p.grad = None
    loss = tt.lm_loss(model, torch.from_numpy(toks))
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in model.named_parameters()}


def _check_against_reference(jcfg, params, model, toks):
    want_loss, want = jax.value_and_grad(
        lambda p: jt.lm_loss(jcfg, p, jnp.asarray(toks)))(params)
    loss, got = _port_loss_grads(model, toks)
    assert abs(float(loss) - float(want_loss)) <= 1e-5
    assert len(got) == len(list(model.parameters()))
    want = jax.tree.map(np.asarray, want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(),
                                   tt.reference_leaf(model, want, name),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
    return loss, got


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("scan", [True, False], ids=["blocks",
                                                     "blocks_list"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_reference(arch, scan, remat):
    jcfg = _jcfg(arch, scan, remat=remat)
    params, model = _pair(jcfg, seed=1)
    assert model.cfg.remat == remat
    _check_against_reference(jcfg, params, model,
                             _tokens(jcfg.vocab, seed=1))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_equal_bits_and_recomputes_each_layer_once(
        arch, monkeypatch):
    """With remat each layer's attention (and MoE) runs twice in a loss
    and its backward, without it once; the gradients are equal bits."""
    calls = {"attn": 0, "moe": 0}

    def counted(fn, key):
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(tt, "flash_attention_bhsd",
                        counted(tt.flash_attention_bhsd, "attn"))
    monkeypatch.setattr(tt, "moe_apply_local",
                        counted(tt.moe_apply_local, "moe"))
    toks = _tokens(256, seed=2)
    runs = []
    for remat in (False, True):
        jcfg = _jcfg(arch, remat=remat)
        _, model = _pair(jcfg, seed=2)
        calls.update(attn=0, moe=0)
        runs.append(_port_loss_grads(model, toks % jcfg.vocab))
        n = jcfg.n_layers * (2 if remat else 1)
        assert calls == {"attn": n, "moe": n if jcfg.moe_experts else 0}
    assert torch.equal(runs[0][0], runs[1][0])
    for name, g in runs[0][1].items():
        assert torch.equal(g, runs[1][1][name]), name


# --------------------------------------------------------------------- MoE
@pytest.mark.parametrize("tie", [False, True], ids=["distinct", "tied"])
@pytest.mark.parametrize("factor", [DROPPING, 1.25])
@pytest.mark.parametrize("t,d,f,e,k", [(16, 32, 24, 8, 2),
                                       (40, 48, 32, 32, 8)])
def test_moe_gradients_match_the_reference(t, d, f, e, k, factor, tie):
    """The gradients of Σ y · r + aux through ``moe_apply`` (x, the float32
    router, the expert weights), the pairs past an expert's capacity
    dropped: a dropped pair gives its token, its weight and its expert
    nothing, as in the reference."""
    w = _weights(d, f, e, seed=t + e, tie=tie)
    x = _x(t, d, seed=t)
    r = np.random.default_rng(7).normal(size=(t, d)).astype(np.float32)

    def j_obj(x, p):
        y, aux = jm.moe_apply(p, x, top_k=k, capacity_factor=factor)
        return jnp.sum(y * r) + 3.0 * aux
    want = jax.grad(j_obj, argnums=(0, 1))(
        jnp.asarray(x), {n: jnp.asarray(a) for n, a in w.items()})

    xt = torch.from_numpy(x).requires_grad_()
    p = {n: torch.from_numpy(a).requires_grad_() for n, a in w.items()}
    cap = tm.capacity(t, k, e, factor)
    route = tm.moe_route(p["router"].detach(), xt.detach(), top_k=k, cap=cap)
    if factor == DROPPING:
        assert not bool(route["keep"].all())
    y, aux = tm.moe_apply(type("P", (), p), xt, top_k=k,
                          capacity_factor=factor)
    (torch.sum(y * torch.from_numpy(r)) + 3.0 * aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want[0]),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    for n in w:
        np.testing.assert_allclose(p[n].grad.numpy(), np.asarray(want[1][n]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=n)
    # an expert whose every pair was dropped past its capacity still has
    # the pairs it kept; a dropped pair's output row takes no gradient
    kept = torch.zeros(e, dtype=torch.bool)
    kept[route["top_e"].reshape(-1)[route["keep"]]] = True
    assert bool((p["w_out"].grad[~kept] == 0).all())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_lm_loss_with_dropped_pairs_matches_the_reference(arch, monkeypatch):
    """Both models' MoE layers at a capacity factor of 0.5 (pairs dropped
    in every layer): ``lm_loss`` and every gradient."""
    monkeypatch.setattr(jt, "moe_apply_local", functools.partial(
        jm.moe_apply_local, capacity_factor=DROPPING))
    monkeypatch.setattr(tt, "moe_apply_local", functools.partial(
        tm.moe_apply_local, capacity_factor=DROPPING))
    jcfg = _jcfg(arch, remat=True)
    params, model = _pair(jcfg, seed=3)
    _check_against_reference(jcfg, params, model, _tokens(jcfg.vocab,
                                                           seed=3))


# -------------------------------------------------------------- the cell
@pytest.mark.parametrize("arch", ARCHS)
def test_train_cell_step_matches_reference_cell(arch, monkeypatch):
    """``lm_train_cell`` (smoke) against the reference ``_lm_cell(arch,
    "train_4k")`` train step on a 1 × 1 mesh with the smoke config: loss,
    grad norm, lr and the updated parameters; the moments' dtype as the
    reference reckons it."""
    jcfg = _jcfg(arch)
    monkeypatch.setattr(jsteps, "get_config",
                        lambda a, smoke=False: jcfg)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jcell = jsteps._lm_cell(arch, "train_4k", mesh)
    cell = tsteps.lm_train_cell(arch, seq_len=32, batch=2, device="cpu",
                                seed=4, smoke=True)
    assert cell.opt_cfg == to.AdamWConfig()  # float32 moments at smoke size
    params, _ = _pair(jcfg, seed=4)
    tt.load_reference_lm_params(cell.model, jax.tree.map(np.asarray, params))
    toks = cell.tokens.numpy()
    with mesh:
        want_p, _, want_m = jax.jit(jcell.fn)(
            params, jo.adamw_init(params), jnp.asarray(toks))
    got = cell.step()
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(got[key]), float(want_m[key]),
                                   rtol=1e-5, err_msg=key)
    assert got["lr"] == float(want_m["lr"])
    want_p = jax.tree.map(np.asarray, want_p)
    for n, p in cell.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   tt.reference_leaf(cell.model, want_p, n),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


@pytest.mark.parametrize("arch,mom", [
    ("granite-moe-1b-a400m", torch.bfloat16),  # dp_only
    ("codeqwen1.5-7b", torch.float32), ("qwen1.5-32b", torch.bfloat16),
    ("grok-1-314b", torch.bfloat16), ("gemma2-9b", torch.float32)])
def test_train_cell_moments_follow_the_published_config(arch, mom):
    """The full cell's moments, reckoned on the published config as the
    reference's ``_lm_cell`` reckons them (n_layers · d_model > 200,000
    or ``dp_only``)."""
    cfg = tsteps.get_config(arch)
    assert tsteps.train_moments_dtype(cfg) == mom
    jcfg = jsteps.get_config(arch)
    big = jcfg.n_layers * jcfg.d_model > 200_000
    assert (mom == torch.bfloat16) == (big or jcfg.train_layout == "dp_only")


def test_run_lm_resumes_after_injected_failure(tmp_path):
    """``run_lm`` on granite-moe's smoke config: a run that crashes at step
    13 and resumes from its step-10 checkpoint ends with the bits of an
    uninterrupted run and the same history after the resume."""
    kw = dict(arch="granite-moe-1b-a400m", steps=16, smoke=True,
              device="cpu")
    with pytest.raises(RuntimeError, match="injected failure"):
        tlaunch.run_lm(ckpt_dir=str(tmp_path / "a"), fail_at=13, **kw)
    m1, o1, h1 = tlaunch.run_lm(ckpt_dir=str(tmp_path / "a"), fail_at=None,
                                **kw)
    m2, o2, h2 = tlaunch.run_lm(ckpt_dir=str(tmp_path / "b"), fail_at=None,
                                **kw)
    assert int(o1["step"]) == int(o2["step"]) == 16
    assert h1[0]["step"] == 10
    assert h1 == [h for h in h2 if h["step"] >= 10]
    for (n, p), q in zip(m1.named_parameters(), m2.parameters()):
        assert torch.equal(p, q), n
