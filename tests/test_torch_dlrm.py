"""The port's recommender substrate against the JAX reference, on the CPU
at smoke sizes: the dlrm-rm2 configs; ``dlrm_batch`` bit for bit;
``dlrm_forward``, ``dlrm_loss`` and every gradient, with the reference's
``dlrm_init`` weights carried over by ``load_reference_dlrm_params``,
against ``jax.value_and_grad`` of the reference's ``dlrm_loss`` on a
power-law batch with repeated rows (hot 1 and 2, the plain and the dedup
lookup); the dedup integers (each field's live unique rows, ranks and
inverse) bit for bit against the reference's own lines; the lookup's
transposed layout under ``SLICE_CFG`` and ``MERGE_CFG`` (their CPU
routes) against a stable ``torch.sort``; retrieval's top-k with planted
ties; ``quantize_ef`` bit for bit; each ``_recsys_cell`` step against the
reference ``_recsys_cell`` on a 1 × 1 mesh; ``run_recsys`` crashed and
resumed against a clean run; and the table gradient's summation order.

Tolerances (float32): logits and loss within 1e-5 relative plus 1e-6
(the MLPs' and the interaction's sums in another order: measured at most
3.8e-7 of the largest logit, 1.8e-7 of the loss); each gradient within
``GRAD_TOL`` = 1e-5 of its tensor's largest |reference value| (the
table's rows summed over their lookups in key order, where the reference
scatter-adds: measured at most 4.9e-7, on a CPU). The
cell's updated parameters within 1e-6: AdamW moves a parameter by about
lr a step, whatever a gradient's last bits."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.set_partition import prefix_sum as j_prefix_sum  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import dlrm as jd  # noqa: E402
from repro.train import compress as jcomp  # noqa: E402
from repro.train import optim as jopt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.costmodel import MERGE_CFG, SLICE_CFG  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import dlrm as td  # noqa: E402
from repro_torch.train import compress as tcomp  # noqa: E402

GRAD_TOL = 1e-5
ARCH = "dlrm-rm2"


def _np(t):
    return t.detach().cpu().numpy()


def _port_cfg(jcfg, **over):
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    fields["dtype"] = torch.float32
    return td.DLRMConfig(**{**fields, **over})


def _pair(jcfg, seed=0):
    """(reference params, port model with those params)."""
    params = jd.dlrm_init(jcfg, jax.random.PRNGKey(seed))
    model = td.DLRM(_port_cfg(jcfg), seed=seed, device="cpu")
    td.load_reference_dlrm_params(model, jax.tree.map(np.asarray, params))
    return params, model


def _batch(jcfg, b=48, seed=0, step=0):
    return jsyn.dlrm_batch(seed, step, b, jcfg.n_dense, jcfg.n_sparse,
                           jcfg.hot, jcfg.vocab_size)


def _t(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _smoke(**change):
    return dataclasses.replace(j_get_config(ARCH, smoke=True), **change)


def _assert_tree_close(model, got, want, tol=GRAD_TOL):
    flat = {"tables": want["tables"],
            **{f"bot.{k}": v for k, v in want["bot"].items()},
            **{f"top.{k}": v for k, v in want["top"].items()}}
    assert set(got) == set(flat)
    for name, g in got.items():
        w = np.asarray(flat[name])
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(_np(g) - w).max())
        assert err <= tol * scale, (name, err / scale)


# ------------------------------------------------------------ config, data
@pytest.mark.parametrize("smoke", [False, True])
def test_config_equals_the_reference(smoke):
    got = get_config(ARCH, smoke=smoke)
    want = j_get_config(ARCH, smoke=smoke)
    assert [f.name for f in dataclasses.fields(got)] == [
        f.name for f in dataclasses.fields(want)]
    assert got == _port_cfg(want)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 7)])
def test_dlrm_batch_bit_identical(seed, step):
    got = tsyn.dlrm_batch(seed, step, 300, 13, 26, 2, 1000)
    want = jsyn.dlrm_batch(seed, step, 300, 13, 26, 2, 1000)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_power_law_batch_repeats_rows():
    """The batch the gradient tests use hits row 0 of each table many
    times (the Zipf law's head), so a row's gradient sums many lookups."""
    _, idx, _ = _batch(_smoke(), b=256)
    assert (idx == 0).mean() > 0.3


# ------------------------------------------------------- forward and grads
@pytest.mark.parametrize("dedup", [False, True], ids=["plain", "dedup"])
@pytest.mark.parametrize("hot", [1, 2])
def test_forward_loss_and_grads_match_the_reference(hot, dedup):
    jcfg = _smoke(hot=hot, dedup=dedup)
    params, model = _pair(jcfg, seed=hot)
    dense, idx, labels = _batch(jcfg, seed=hot)
    want_logits = jd.dlrm_forward(jcfg, params, jnp.asarray(dense),
                                  jnp.asarray(idx))
    with torch.no_grad():
        logits = td.dlrm_forward(model, *_t((dense, idx)))
    np.testing.assert_allclose(_np(logits), np.asarray(want_logits),
                               rtol=1e-5, atol=1e-6)
    want_loss, want = jax.value_and_grad(
        lambda p: jd.dlrm_loss(jcfg, p, jnp.asarray(dense), jnp.asarray(idx),
                               jnp.asarray(labels)))(params)
    loss = td.dlrm_loss(model, *_t((dense, idx, labels)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5, atol=1e-6)
    _assert_tree_close(model,
                       {n: p.grad for n, p in model.named_parameters()},
                       jax.tree.map(np.asarray, want))


def test_both_lookups_give_one_gradient():
    """The dedup lookup's two span sums and the plain lookup's one sum each
    table row's lookups; their table gradients agree within float32
    rounding, and with the float64 scatter-add of the same bags."""
    jcfg = _smoke()
    grads = []
    for dedup in (False, True):
        _, model = _pair(dataclasses.replace(jcfg, dedup=dedup))
        dense, idx, _ = _t(_batch(jcfg, b=96))
        g = torch.randn((96, jcfg.n_sparse, jcfg.embed_dim),
                        generator=torch.Generator().manual_seed(4))
        emb = (td.embedding_bag_dedup if dedup else td.embedding_bag)(
            model.tables, idx)
        (emb * g).sum().backward()
        grads.append(model.tables.grad)
    want = torch.zeros(grads[0].shape, dtype=torch.float64)
    for h in range(jcfg.hot):
        for f in range(jcfg.n_sparse):
            want[f].index_add_(0, idx[:, f, h].to(torch.int64),
                               g[:, f].to(torch.float64))
    for got in grads:
        err = float((got.to(torch.float64) - want).abs().max())
        assert err <= 1e-6 * float(want.abs().max())
    assert float((grads[0] - grads[1]).abs().max()) <= 1e-6 * float(
        want.abs().max())


def test_a_tensor_without_grad_gathers_without_a_layout(monkeypatch):
    """Serving (no grad) builds no layout: the gather is one
    ``index_select``; under grad the layout is built and the bags are the
    same values."""
    jcfg = _smoke()
    _, model = _pair(jcfg)
    _, idx, _ = _t(_batch(jcfg))
    built = []
    real = td.lookup_layout
    monkeypatch.setattr(td, "lookup_layout",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    with torch.no_grad():
        plain = td.embedding_bag(model.tables, idx)
    assert not built
    with_grad = td.embedding_bag(model.tables, idx)
    assert built == [1] and with_grad.requires_grad
    assert torch.equal(plain, with_grad.detach())


# ---------------------------------------------------------- dedup integers
def _j_dedup_field(ix):
    """The reference's sort-unique-rank of one field's [B, hot] indices,
    its own lines (``dlrm.py:60-67``): (uniq, rank, inv)."""
    flat = ix.reshape(-1)
    order = jnp.argsort(flat)
    sv = flat[order]
    is_first = jnp.concatenate([jnp.ones((1,), bool), sv[1:] != sv[:-1]])
    rank = j_prefix_sum(is_first.astype(jnp.int32)) - 1
    uniq = jax.ops.segment_max(sv, rank, num_segments=flat.shape[0])
    inv = jnp.zeros((flat.shape[0],), jnp.int32).at[order].set(rank)
    return np.asarray(uniq), np.asarray(rank), np.asarray(inv)


@pytest.mark.parametrize("hot,b,seed", [(1, 64, 0), (2, 64, 1), (3, 37, 2)])
def test_dedup_integers_equal_the_reference(hot, b, seed):
    """Each field's live unique rows, its sorted positions' ranks and its
    lookups' unique ids, read off the one all-field layout, equal the
    reference's per-field integers. The reference's unique tail holds
    ``segment_max``'s identity (int32 min) and is never read; only the
    live prefix is held."""
    jcfg = _smoke(hot=hot)
    _, idx, _ = _batch(jcfg, b=b, seed=seed)
    v, f = jcfg.vocab_size, jcfg.n_sparse
    layout = td.lookup_layout(torch.from_numpy(idx), v)
    dd = td.dedup_index(layout, f * v)
    first, rank, uniq, inv = (_np(t) for t in (dd.first, dd.rank, dd.uniq,
                                               dd.inv))
    m = b * hot
    for fi in range(f):
        j_uniq, j_rank, j_inv = _j_dedup_field(jnp.asarray(idx[:, fi]))
        lo, hi = first[fi * m], first[(fi + 1) * m]
        n_live = int(j_rank.max()) + 1
        assert hi - lo == n_live
        np.testing.assert_array_equal(uniq[lo:hi] - fi * v,
                                      j_uniq[:n_live])
        assert (j_uniq[n_live:] == np.iinfo(np.int32).min).all()
        np.testing.assert_array_equal(rank[fi * m:(fi + 1) * m] - lo,
                                      j_rank)
        np.testing.assert_array_equal(inv[fi * m:(fi + 1) * m] - lo, j_inv)
    assert (uniq[first[-1]:] == f * v).all()


@pytest.mark.parametrize("cfg", [SLICE_CFG, MERGE_CFG],
                         ids=["slice", "merge"])
@pytest.mark.parametrize("b,hot", [(64, 2), (700, 1), (1, 1)])
def test_layout_equals_a_stable_sort(cfg, b, hot):
    """``rev_perm`` is the keys' stable sort order and ``rev_ptr`` each
    row's first sorted position (700 × 6 lookups: padded to the sort's
    tile of 4,096 and cut back)."""
    jcfg = _smoke(hot=hot)
    _, idx, _ = _batch(jcfg, b=b, seed=b)
    v = jcfg.vocab_size
    layout = td.lookup_layout(torch.from_numpy(idx), v, cfg)
    keys = layout.keys
    assert keys.dtype == torch.int32
    np.testing.assert_array_equal(
        _np(keys), (idx.transpose(1, 0, 2)
                    + np.arange(jcfg.n_sparse)[:, None, None] * v).ravel())
    sk, order = torch.sort(keys, stable=True)
    assert layout.rev_perm.dtype == layout.rev_ptr.dtype == torch.int32
    assert torch.equal(layout.rev_perm.to(torch.int64), order)
    want_ptr = torch.searchsorted(
        sk, torch.arange(jcfg.n_sparse * v + 1, dtype=torch.int32))
    assert torch.equal(layout.rev_ptr.to(torch.int64), want_ptr)


def test_lookup_keys_refuse_an_int32_overflow():
    with pytest.raises(ValueError, match="overflow"):
        td.lookup_keys(torch.zeros((1, 3, 1), dtype=torch.int32), 2 ** 30)


# --------------------------------------------------------------- retrieval
@pytest.mark.parametrize("top_k", [5, 16])
def test_retrieval_top_k_with_ties(top_k):
    """Candidates that repeat another's indices score equal; the top-k keeps
    equal scores in candidate order (``jax.lax.top_k``'s rule)."""
    jcfg = _smoke()
    params, model = _pair(jcfg, seed=2)
    dense, idx, _ = _batch(jcfg, b=40, seed=2)
    fu = jcfg.n_sparse - 2
    cand = idx[:, fu:].copy()
    cand[10:20] = cand[3]  # ten ties with candidate 3
    cand[25] = cand[0]
    want_s, want_i = jd.dlrm_retrieval(
        jcfg, params, jnp.asarray(dense[:1]), jnp.asarray(idx[:1, :fu]),
        jnp.asarray(cand), top_k=top_k)
    got_s, got_i = td.dlrm_retrieval(
        model, *_t((dense[:1], idx[:1, :fu], cand)), top_k=top_k)
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(_np(got_i), np.asarray(want_i))
    np.testing.assert_allclose(_np(got_s), np.asarray(want_s), rtol=1e-5,
                               atol=1e-6)
    ties = [i for i in _np(got_i) if i in (3, *range(10, 20))]
    assert ties == sorted(ties)


# ------------------------------------------------------------ compression
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_ef_bit_identical(seed):
    """Values, scale and the carried error equal the reference's bit for
    bit, halves included (values drawn on a grid of the scale, so some
    quotients land on .5 and round to even)."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(64, 33)).astype(np.float32)
    g[0, :8] = np.arange(8) * 0.5 - 2  # exact halves of a step below
    g[0, 8] = 127.0
    err = (1e-3 * rng.normal(size=g.shape)).astype(np.float32)
    if seed == 2:
        err[:] = 0
    q, scale, e = tcomp.quantize_ef(*_t((g, err)))
    jq, jscale, je = jcomp.quantize_ef(jnp.asarray(g), jnp.asarray(err))
    assert q.dtype == torch.int8 and scale.dtype == e.dtype == torch.float32
    np.testing.assert_array_equal(_np(q), np.asarray(jq))
    assert _np(scale).tobytes() == np.asarray(jscale).tobytes()
    np.testing.assert_array_equal(_np(e), np.asarray(je))
    np.testing.assert_array_equal(_np(tcomp.dequantize(q, scale)),
                                  np.asarray(jcomp.dequantize(jq, jscale)))


def test_compression_error_buffers_and_the_all_reduce():
    grads = {"a": torch.ones(3, 2, dtype=torch.bfloat16), "b": torch.ones(4)}
    errs = tcomp.zeros_like_error(grads)
    assert {n: (tuple(t.shape), t.dtype) for n, t in errs.items()} == {
        "a": ((3, 2), torch.float32), "b": ((4,), torch.float32)}
    assert all(not t.any() for t in errs.values())
    # the all-reduce on a world-1 gloo group (a spawned rank): quantize
    # then dequantize, the error buffers quantize_ef's, twice over
    from torch_dist_worker import run_ranks
    rng = np.random.default_rng(4)
    g = {"f32_a": rng.normal(size=(1, 5, 7)).astype(np.float32),
         "bf16_b": torch.from_numpy(rng.normal(size=(1, 13)).astype(
             np.float32)).to(torch.bfloat16).float().numpy()}
    (out,) = run_ranks("compress", {"grads": g}, (1,), ("data",))
    want_err = {k: torch.zeros(a.shape[1:]) for k, a in g.items()}
    for red, errs in out[:2]:
        for k, a in g.items():
            t = torch.from_numpy(a[0]).to(torch.bfloat16 if k == "bf16_b"
                                          else torch.float32)
            q, scale, e = tcomp.quantize_ef(t, want_err[k])
            np.testing.assert_array_equal(red[k], _np(
                tcomp.dequantize(q, scale).to(t.dtype).float()))
            np.testing.assert_array_equal(errs[k], _np(e))
            want_err[k] = e
    for k in g:
        np.testing.assert_array_equal(out[2][k], out[0][0][k])
    with pytest.raises(TypeError, match="DeviceMesh"):
        tcomp.make_compressed_allreduce(None, None)


# ------------------------------------------------------------------- cells
@pytest.mark.parametrize("shape", ["train_batch", "serve_p99", "serve_bulk",
                                   "retrieval_cand"])
def test_recsys_cell_step_matches_reference_cell(monkeypatch, shape):
    """The port's ``_recsys_cell`` (smoke, batch cut to 48) against the
    reference ``_recsys_cell`` step on a 1 × 1 mesh with the smoke config
    (retrieval: 128 candidates, so that the top 100 exist),
    on the same inputs and weights: the train step's loss, grad norm, lr
    and updated parameters; the serve step's logits; retrieval's top-k."""
    import repro.launch.steps as jsteps
    monkeypatch.setattr(jsteps, "get_config",
                        lambda arch, smoke=False: j_get_config(ARCH, True))
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jcell = jsteps._recsys_cell(ARCH, shape, mesh)
    n = 128 if shape == "retrieval_cand" else 48  # top 100
    cell = tsteps._recsys_cell(ARCH, shape, device="cpu", seed=3,
                               smoke=True, batch=n)
    params = jd.dlrm_init(j_get_config(ARCH, True), jax.random.PRNGKey(3))
    td.load_reference_dlrm_params(cell.model,
                                  jax.tree.map(np.asarray, params))
    inputs = [jnp.asarray(_np(t)) for t in cell.inputs]
    want_in = jsyn.dlrm_batch(3, 0, n, 13, 6, 2, 1000)
    if shape == "retrieval_cand":
        assert [tuple(t.shape) for t in cell.inputs] == [(1, 13), (1, 4, 2),
                                                          (n, 2, 2)]
        np.testing.assert_array_equal(_np(cell.inputs[2]), want_in[1][:, 4:])
    else:
        for got, want in zip(cell.inputs, want_in):
            np.testing.assert_array_equal(_np(got), want)
    with mesh:
        if shape == "train_batch":
            want_p, _, want_m = jax.jit(jcell.fn)(
                params, jopt.adamw_init(params), *inputs)
        else:
            want = jax.jit(jcell.fn)(params, *inputs)
    got = cell.step()
    if shape == "train_batch":
        assert cell.opt_cfg == tsteps.AdamWConfig()
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(got[key]), float(want_m[key]),
                                       rtol=1e-5, err_msg=key)
        assert got["lr"] == float(want_m["lr"])
        _assert_tree_close(cell.model, dict(cell.model.named_parameters()),
                           jax.tree.map(np.asarray, want_p), tol=1e-6)
    elif shape == "retrieval_cand":
        np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))
        np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]),
                                   rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


def test_run_recsys_resumes_after_injected_failure(tmp_path):
    """``run_recsys`` on the smoke config (a checkpoint every 10 steps): a
    run that crashes at step 13 and resumes from its step-10 checkpoint
    ends with the bits of an uninterrupted run, and the same history after
    the resume; ``vocab_size`` cuts the tables."""
    kw = dict(arch=ARCH, steps=16, smoke=True, device="cpu", log_every=1,
              vocab_size=257)
    with pytest.raises(RuntimeError, match="injected failure"):
        tlaunch.run_recsys(ckpt_dir=str(tmp_path / "a"), fail_at=13, **kw)
    m1, o1, h1 = tlaunch.run_recsys(ckpt_dir=str(tmp_path / "a"),
                                    fail_at=None, **kw)
    m2, o2, h2 = tlaunch.run_recsys(ckpt_dir=str(tmp_path / "b"),
                                    fail_at=None, **kw)
    assert tuple(m1.tables.shape) == (6, 257, 16)
    assert int(o1["step"]) == int(o2["step"]) == 16
    assert h1[0]["step"] == 10 and h1 == h2[10:]
    assert h2[-1]["loss"] < h2[0]["loss"]
    for (n, p), q in zip(m1.named_parameters(), m2.parameters()):
        assert torch.equal(p, q), n
