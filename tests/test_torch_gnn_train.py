"""GNN training in the port against the JAX reference, on the CPU at smoke
sizes: ``graph_dataset`` / ``batch_nodes`` and ``SampledDataset.batch``
bit for bit (the transposed layout against a stable ``torch.sort``,
prefetched batches against synchronous ones); ``pool_graphs`` and
``gnn_loss`` of all four families, with the reference's ``gnn_init``
weights, against ``jax.value_and_grad`` of the reference's ``gnn_loss``
(loss and every gradient) on a batch without ``ptr`` (``index_add_``), a
sampler batch with the transposed layout (``SpanSum`` / ``GatherRows``),
a batched-graphs batch and MeshGraphNet's regression labels; the two
Functions against the autograd of the plain composition and under
``gradcheck``; the guard against silent detachment; ``use_pallas_agg``
refused under autograd by both packages; ``sgd_update``; four
``gnn_train_step``s against the reference's ``_train_step_factory``;
``run_gnn`` crashed and resumed against a clean run; ``main``; and
``_gnn_cell`` at every ``GNN_SHAPES`` shape, cut to size.

Tolerances. Loss and gradients, as a share of each tensor's largest
|reference value| (``GRAD_TOL`` = 1e-4): both packages sum in float32 in
different orders (the pointer path takes prefix differences, whose
cancellation grows with the prefix; the reference's segment sums
scatter), and through the layers and normalisations those orders move a
gradient by at most 1.03e-5 of its largest value here (GAT; GatedGCN
5.5e-6, GraphSAGE 3.2e-7). The train steps' losses: ``STEP_TOL`` = 1e-5
relative (AdamW moves a parameter by about lr a step, whatever a
gradient's last bits; read 7.0e-8)."""
import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import COO as JCOO  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.data.sampler import SampledDataset as JSampledDataset  # noqa: E402
from repro.launch.train import _train_step_factory  # noqa: E402
from repro.models import gnn as jg  # noqa: E402
from repro.train import optim as jopt  # noqa: E402
from repro_torch.configs import GNN_SHAPES, get_config  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.data.sampler import SampledDataset  # noqa: E402
from repro_torch.kernels import ptr_scan  # noqa: E402
from repro_torch.kernels import segment_agg  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from repro_torch.train import optim as topt  # noqa: E402

SEN = 0x7FFFFFFF
GRAD_TOL, STEP_TOL, FLOOR = 1e-4, 1e-5, 1e-4
ARCHS = ("graphsage-reddit", "gat-cora", "gatedgcn", "meshgraphnet")
N, E, D_FEAT, D_EDGE, N_CLASSES = 48, 256, 10, 4, 5
# the sampler's smoke graph
G_NODES, G_EDGES, FANOUTS, BATCH = 128, 512, (3, 2), 16


def _np(t):
    return t.detach().cpu().numpy()


def _dataset(seed=0, d_feat=D_FEAT):
    dst, src, feats, labels = tsyn.graph_dataset(seed, G_NODES, G_EDGES,
                                                 d_feat, N_CLASSES)
    ds = SampledDataset(
        coo=tg.COO.from_arrays(dst, src, G_NODES, device="cpu"),
        features=torch.from_numpy(feats), labels=torch.from_numpy(labels),
        fanouts=FANOUTS, batch_size=BATCH, seed=seed)
    return ds, (dst, src, feats, labels)


# ------------------------------------------------------------- data
@pytest.mark.parametrize("seed", [0, 3])
def test_graph_dataset_and_batch_nodes_bit_identical(seed):
    got = tsyn.graph_dataset(seed, 300, 2000, 7, 5)
    want = jsyn.graph_dataset(seed, 300, 2000, 7, 5)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    uniform = tsyn.graph_dataset(seed, 50, 100, 2, 3, power_law=None)
    for g, w in zip(uniform, jsyn.graph_dataset(seed, 50, 100, 2, 3,
                                                power_law=None)):
        np.testing.assert_array_equal(g, w)
    for step in range(4):
        np.testing.assert_array_equal(tsyn.batch_nodes(seed, step, 16, 300),
                                      jsyn.batch_nodes(seed, step, 16, 300))


def test_sampled_dataset_batches_equal_the_reference():
    """Steps 0-3: the reference's fields bit for bit; ptr the CSC
    pointers of the sorted dst; rev_perm / rev_ptr a stable sort of the
    sources and its pointers; prefetched == synchronous."""
    ds, (dst, src, feats, labels) = _dataset()
    jds = JSampledDataset(
        coo=JCOO.from_arrays(dst, src, G_NODES), features=jnp.asarray(feats),
        labels=jnp.asarray(labels), fanouts=FANOUTS, batch_size=BATCH,
        seed=0)
    assert ds.engine_cfg.use_pallas
    sync = [ds.batch(s) for s in range(4)]
    for step, b in enumerate(sync):
        jb = jds.batch(step)
        for f in ("edge_dst", "edge_src", "node_feat", "labels",
                  "label_mask"):
            g, w = _np(getattr(b, f)), np.asarray(getattr(jb, f))
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)
        n = b.n_nodes
        ar = torch.arange(n + 1, dtype=torch.int32)
        assert torch.equal(b.ptr, torch.searchsorted(
            b.edge_dst, ar).to(torch.int32))
        order = torch.sort(b.edge_src, stable=True)
        assert torch.equal(b.rev_perm, order.indices.to(torch.int32))
        assert torch.equal(b.rev_ptr, torch.searchsorted(
            order.values, ar).to(torch.int32))
        assert int(b.rev_ptr[-1]) == int(b.ptr[-1]) > 0
    with ds.iter_batches(start=0, stop=4, prefetch=True) as it:
        pref = list(it)
    assert [s for s, _ in pref] == [0, 1, 2, 3]
    for (_, got), want in zip(pref, sync):
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            assert (a is None and b is None) or (
                isinstance(a, int) and a == b) or torch.equal(a, b), f.name


# ---------------------------------------------------------- loss and grads
def _configs(arch):
    jcfg = j_get_config(arch, smoke=True)
    return jcfg, get_config(arch, smoke=True)


def _models(arch, d_in, seed=0):
    """(reference config, its gnn_init params, the port's model with them)."""
    jcfg, tcfg = _configs(arch)
    n_classes = 0 if arch == "meshgraphnet" else N_CLASSES
    params = jg.gnn_init(jcfg, jax.random.PRNGKey(seed), d_in=d_in,
                         d_edge=D_EDGE, n_classes=n_classes)
    model = tgnn.gnn_model(tcfg, d_in, d_edge=D_EDGE, n_classes=n_classes,
                           generator=torch.Generator().manual_seed(1),
                           device="cpu")
    return jcfg, params, tgnn.load_reference_params(model, params)


def _labels(rng, arch, rows):
    if arch == "meshgraphnet":  # regression targets, d_out 3
        return rng.normal(size=(rows, 3)).astype(np.float32)
    return rng.integers(0, N_CLASSES, rows).astype(np.int32)


def _plain_batch(arch, kind, seed=0):
    """numpy fields of a batch without ptr: dst-sorted edges with a
    SENTINEL tail ("nodes"), or 6 graphs of 8 nodes ("graphs")."""
    rng = np.random.default_rng(seed)
    if kind == "graphs":
        g, per = 6, N // 6
        graph = np.sort(rng.integers(0, g, E))
        dst = (graph * per + rng.integers(0, per, E)).astype(np.int32)
        src = (graph * per + rng.integers(0, per, E)).astype(np.int32)
        gid = (np.arange(N) // per).astype(np.int32)
        rows = g
    else:
        dst = np.sort(rng.integers(0, N, E)).astype(np.int32)
        src = rng.integers(0, N, E).astype(np.int32)
        gid, rows, g = None, N, 1
    dst[-30:], src[-30:] = SEN, SEN
    fields = dict(edge_dst=dst, edge_src=src,
                  node_feat=rng.normal(size=(N, D_FEAT)).astype(np.float32),
                  labels=_labels(rng, arch, rows),
                  label_mask=rng.random(rows) < 0.7,
                  edge_feat=rng.normal(size=(E, D_EDGE)).astype(np.float32),
                  graph_ids=gid)
    return fields, g


def _sampler_batch(arch, step=1):
    ds, _ = _dataset(seed=2)
    b = ds.batch(step)
    if arch == "meshgraphnet":
        rng = np.random.default_rng(step)
        b = dataclasses.replace(b, labels=torch.from_numpy(
            _labels(rng, arch, b.n_nodes)))
    return b


def _to_t(fields, g, **extra):
    return tgnn.GraphBatch(n_graphs=g, **extra, **{
        k: None if v is None else torch.from_numpy(v)
        for k, v in fields.items()})


def _to_j(batch):
    def j(v):
        return None if v is None else jnp.asarray(_np(v))
    return jg.GraphBatch(
        edge_dst=j(batch.edge_dst), edge_src=j(batch.edge_src),
        node_feat=j(batch.node_feat), labels=j(batch.labels),
        label_mask=j(batch.label_mask), edge_feat=j(batch.edge_feat),
        graph_ids=j(batch.graph_ids), n_graphs=batch.n_graphs)


def _loss_and_grads(model, batch):
    for p in model.parameters():
        p.grad = None
    loss = tgnn.gnn_loss(model, batch)
    loss.backward()
    return loss


def _assert_grads_close(model, jgrads, what):
    """Every parameter's gradient within GRAD_TOL of the reference's, as a
    share of the reference gradient's largest |value|, or of FLOOR times
    the largest over all parameters where that is more: a gradient the
    math makes zero (GAT's a_dst, a shift constant per destination that
    the softmax cancels) is float noise in both. A gradient the loss does
    not reach is zero in both."""
    want = tgnn.load_reference_params(copy.deepcopy(model), jgrads)
    top = max(float(q.abs().max()) for q in want.parameters())
    for (name, p), q in zip(model.named_parameters(), want.parameters()):
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        err = float((got - q).abs().max())
        scale = max(float(q.abs().max()), FLOOR * top)
        assert err <= GRAD_TOL * scale, \
            f"{what} {name}: {err} against {scale}"


def _check(arch, model, jcfg, params, batch):
    jb = _to_j(batch)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jg.gnn_loss(jcfg, p, jb))(params)
    loss = float(_loss_and_grads(model, batch))
    assert abs(loss - float(jloss)) <= GRAD_TOL * max(
        1.0, abs(float(jloss))), (loss, float(jloss))
    _assert_grads_close(model, jgrads, arch)


@pytest.mark.parametrize("kind", ["nodes", "graphs"])
@pytest.mark.parametrize("arch", ARCHS)
def test_gnn_loss_and_grads_without_ptr(arch, kind):
    """The index_add_ path (no ptr), node or graph level (pool_graphs)."""
    jcfg, params, model = _models(arch, D_FEAT)
    fields, g = _plain_batch(arch, kind)
    if arch not in ("gatedgcn", "meshgraphnet"):
        fields["edge_feat"] = None
    _check(arch, model, jcfg, params, _to_t(fields, g))


@pytest.mark.parametrize("arch", ARCHS)
def test_gnn_loss_and_grads_through_the_transposed_layout(arch):
    """A sampler batch: every sum a SpanSum, every gather a GatherRows;
    against the reference on the same fields (its batch has no ptr)."""
    jcfg, params, model = _models(arch, D_FEAT)
    batch = _sampler_batch(arch)
    assert batch.rev_ptr is not None
    _check(arch, model, jcfg, params, batch)


def test_pool_graphs_against_the_reference():
    rng = np.random.default_rng(5)
    h = rng.normal(size=(N, 3)).astype(np.float32)
    gid = rng.integers(-1, 8, N).astype(np.int32)  # ids outside [0, 7) drop
    fields = dict(edge_dst=np.zeros(1, np.int32), edge_src=np.zeros(1,
                                                                    np.int32),
                  node_feat=h, graph_ids=gid)
    tb = tgnn.GraphBatch(n_graphs=7, **{k: torch.from_numpy(v)
                                        for k, v in fields.items()})
    jb = jg.GraphBatch(labels=None, label_mask=None, n_graphs=7,
                       **{k: jnp.asarray(v) for k, v in fields.items()})
    np.testing.assert_allclose(
        _np(tgnn.pool_graphs(tb, torch.from_numpy(h))),
        np.asarray(jg.pool_graphs(jb, jnp.asarray(h))), rtol=1e-6, atol=1e-6)


def test_masked_rows_give_the_reference_gradients():
    """The reference clamps SENTINEL edges onto node n - 1 and masks them
    with a where (their gradient is zero); the span sums never read those
    rows. On a sampler batch (a SENTINEL tail past ptr[N]), the port's
    gradients through the Functions equal, within GRAD_TOL, its own
    index_add_ path on the same batch without ptr and layout, and the
    reference's."""
    jcfg, params, model = _models("gatedgcn", D_FEAT)
    batch = _sampler_batch("gatedgcn", step=2)
    assert int((batch.edge_dst == SEN).sum()) > 0
    _loss_and_grads(model, batch)
    fn_grads = {n: p.grad.clone() for n, p in model.named_parameters()
                if p.grad is not None}
    plain = dataclasses.replace(batch, ptr=None, rev_perm=None, rev_ptr=None)
    _loss_and_grads(model, plain)
    for n, p in model.named_parameters():
        if n in fn_grads:
            scale = float(p.grad.abs().max())
            assert float((fn_grads[n] - p.grad).abs().max()) <= \
                GRAD_TOL * scale, n
    _check("gatedgcn", model, jcfg, params, batch)


# ------------------------------------------------------------- Functions
def _tiny_graph(seed=0, n=9, e=32, dead=5):
    """dst-sorted edges with a SENTINEL tail of ``dead``, ptr, and the
    transposed layout by a stable sort of the sources."""
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, n, e)).astype(np.int32)
    src = rng.integers(0, n, e).astype(np.int32)
    dst[e - dead:], src[e - dead:] = SEN, SEN
    t = {k: torch.from_numpy(v) for k, v in (("dst", dst), ("src", src))}
    ar = torch.arange(n + 1, dtype=torch.int32)
    t["ptr"] = torch.searchsorted(t["dst"], ar).to(torch.int32)
    order = torch.sort(t["src"], stable=True)
    t["rev_perm"] = order.indices.to(torch.int32)
    t["rev_ptr"] = torch.searchsorted(order.values, ar).to(torch.int32)
    t["dst_c"] = torch.clamp(t["dst"], max=n - 1)
    t["src_c"] = torch.clamp(t["src"], max=n - 1)
    return t


@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_span_sum_backward_equals_the_plain_composition(mean, fused):
    t = _tiny_graph()
    n, e = t["ptr"].shape[0] - 1, t["dst"].shape[0]
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(n if fused else e, 3)))
    g = torch.from_numpy(rng.normal(size=(n, 3)))
    rows = t["src"] if fused else None
    xa = x.clone().requires_grad_()
    ptr_scan.SpanSum.apply(xa, t["ptr"], rows, mean, t["dst_c"],
                           t["rev_perm"], t["rev_ptr"]).backward(g)
    xb = x.clone().requires_grad_()
    ptr_scan._ptr_seg_sum_plain(t["ptr"], xb, rows, mean).backward(g)
    torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-12, atol=1e-12)
    torch.autograd.gradcheck(
        lambda y: ptr_scan.SpanSum.apply(y, t["ptr"], rows, mean,
                                         t["dst_c"], t["rev_perm"],
                                         t["rev_ptr"]),
        (x.clone().requires_grad_(),))


@pytest.mark.parametrize("by", ["src", "dst"])
def test_gather_rows_backward_equals_the_plain_composition(by):
    t = _tiny_graph(seed=2)
    n, e = t["ptr"].shape[0] - 1, t["dst"].shape[0]
    live = torch.arange(e) < t["ptr"][-1]
    idx = (t["src_c"] if by == "src" else t["dst_c"]).to(torch.int64)
    ptr, rows = ((t["rev_ptr"], t["rev_perm"]) if by == "src"
                 else (t["ptr"], None))
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.normal(size=(n, 4)))
    g = torch.from_numpy(rng.normal(size=(e, 4))) * live[:, None]
    ha = h.clone().requires_grad_()
    ptr_scan.GatherRows.apply(ha, idx, ptr, rows).backward(g)
    hb = h.clone().requires_grad_()
    hb.index_select(0, idx).backward(g)
    torch.testing.assert_close(ha.grad, hb.grad, rtol=1e-12, atol=1e-12)
    torch.autograd.gradcheck(
        lambda y: ptr_scan.GatherRows.apply(y, idx, ptr, rows) * live[:, None],
        (h.clone().requires_grad_(),))


def test_kernels_refuse_silent_detachment():
    """Under grad mode a kernel wrapper refuses an input that requires
    grad (its output would carry no history); under no_grad, and for
    inputs that need none, it runs as before."""
    t = _tiny_graph()
    n, e = t["ptr"].shape[0] - 1, t["dst"].shape[0]
    x = torch.randn(e, 3, requires_grad=True)
    calls = [lambda: ptr_scan.ptr_seg_sum(t["ptr"], x),
             lambda: segment_agg.segment_sum_sorted(t["dst"], x, n),
             lambda: segment_agg.segment_sum_padded(t["dst"], x, n)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no autograd history"):
            call()
        with torch.no_grad():
            out = call()
        assert not out.requires_grad
        with torch.no_grad():
            assert torch.equal(out, call())
    plain = x.detach()
    assert torch.equal(ptr_scan.ptr_seg_sum(t["ptr"], plain),
                       ptr_scan._ptr_seg_sum_plain(t["ptr"], plain))
    # the model refuses a pointer batch without the transposed layout
    _, _, model = _models("graphsage-reddit", D_FEAT)
    batch = dataclasses.replace(_sampler_batch("graphsage-reddit"),
                                rev_perm=None, rev_ptr=None)
    with pytest.raises(RuntimeError, match="no autograd history"):
        tgnn.gnn_loss(model, batch)
    with torch.no_grad():
        logits = model(batch)
        again = model(_sampler_batch("graphsage-reddit"))
    assert torch.equal(logits, again)  # the layout changes no forward bit


@pytest.mark.parametrize("arch", ["graphsage-reddit", "gatedgcn"])
def test_use_pallas_agg_is_refused_under_autograd_by_both(arch):
    jcfg, params, model = _models(arch, D_FEAT)
    jcfg = dataclasses.replace(jcfg, use_pallas_agg=True)
    model.cfg = dataclasses.replace(model.cfg, use_pallas_agg=True)
    fields, g = _plain_batch(arch, "nodes")
    if arch != "gatedgcn":
        fields["edge_feat"] = None
    batch = _to_t(fields, g)
    jb = _to_j(batch)
    with pytest.raises(Exception):  # AssertionError under jax 0.9
        jax.grad(lambda p: jg.gnn_loss(jcfg, p, jb))(params)
    with pytest.raises(NotImplementedError, match="no reverse-mode rule"):
        tgnn.gnn_loss(model, batch)
    with torch.no_grad():
        assert torch.isfinite(tgnn.gnn_loss(model, batch))


# ------------------------------------------------------- optimizer, steps
def test_sgd_update_matches_the_reference():
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 3), "b": (7,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    cfg, jcfg = topt.SGDConfig(), jopt.SGDConfig()
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = topt.sgd_init(tp)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.sgd_init(jp)
    for _ in range(3):
        grads = {k: rng.normal(size=s).astype(np.float32)
                 for k, s in shapes.items()}
        assert topt.sgd_update(cfg, {k: torch.from_numpy(v)
                                     for k, v in grads.items()},
                               state, tp) == {}
        jp, jstate, _ = jopt.sgd_update(
            jcfg, {k: jnp.asarray(v) for k, v in grads.items()}, jstate, jp)
        for k in shapes:
            np.testing.assert_array_equal(_np(tp[k]), np.asarray(jp[k]))
            np.testing.assert_array_equal(_np(state["mom"][k]),
                                          np.asarray(jstate["mom"][k]))
    assert int(state["step"]) == int(jstate["step"]) == 3


def test_gnn_train_steps_match_the_reference_history():
    """Four AdamW steps of graphsage (smoke) from the reference's initial
    parameters on the sampler's batches: the port's losses within
    STEP_TOL of the reference's ``_train_step_factory``."""
    ds, (dst, src, feats, labels) = _dataset(seed=1, d_feat=32)
    jds = JSampledDataset(
        coo=JCOO.from_arrays(dst, src, G_NODES), features=jnp.asarray(feats),
        labels=jnp.asarray(labels), fanouts=FANOUTS, batch_size=BATCH,
        seed=1)
    jcfg, params, model = _models("graphsage-reddit", 32)
    jstep = _train_step_factory(lambda p, b: jg.gnn_loss(jcfg, p, b),
                                jopt.AdamWConfig(lr=1e-3))
    jstate = jopt.adamw_init(params)
    opt_cfg = topt.AdamWConfig(lr=1e-3)
    state = topt.adamw_init(dict(model.named_parameters()))
    for step in range(4):
        params, jstate, jm = jstep(params, jstate, jds.batch(step))
        m = tsteps.gnn_train_step(model, opt_cfg, state, ds.batch(step))
        assert abs(float(m["loss"]) - float(jm["loss"])) <= STEP_TOL * abs(
            float(jm["loss"])), (step, float(m["loss"]), float(jm["loss"]))


def test_run_gnn_resumes_after_injected_failure(tmp_path):
    """The smoke run crashed at step 11 resumes from its step-10
    checkpoint and ends with the clean run's bits and losses."""
    kw = dict(arch="graphsage-reddit", steps=12, smoke=True, device="cpu",
              log_every=1)
    data = tlaunch.gnn_data(0, True)
    with pytest.raises(RuntimeError, match="injected failure"):
        tlaunch.run_gnn(ckpt_dir=str(tmp_path / "a"), fail_at=11, data=data,
                        **kw)
    m1, o1, h1 = tlaunch.run_gnn(ckpt_dir=str(tmp_path / "a"), fail_at=None,
                                 data=data, **kw)
    m2, o2, h2 = tlaunch.run_gnn(ckpt_dir=str(tmp_path / "b"), fail_at=None,
                                 **kw)
    assert int(o1["step"]) == int(o2["step"]) == 12
    assert [h["step"] for h in h1] == [10, 11]
    assert h1 == h2[10:]
    for (n, p), q in zip(m1.named_parameters(), m2.parameters()):
        assert torch.equal(p, q), n
    assert h2[-1]["loss"] < h2[0]["loss"]


@pytest.mark.parametrize("arch", ["gat-cora", "meshgraphnet"])
def test_run_gnn_trains_every_family(arch, tmp_path):
    _, _, hist = tlaunch.run_gnn(arch, 2, True, str(tmp_path), None,
                                 device="cpu", log_every=1)
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)


@pytest.mark.parametrize("shape_name", sorted(GNN_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_gnn_cell_steps_at_every_shape(arch, shape_name):
    cut = {"full_graph": dict(n_nodes=60, n_edges=300, d_feat=8),
           "minibatch": dict(batch_nodes=4, fanout=(3, 2), d_feat=8),
           "batched_graphs": dict(n_nodes=6, n_edges=10, batch=4,
                                  d_feat=4)}[GNN_SHAPES[shape_name]["kind"]]
    cell = tsteps._gnn_cell(arch, shape_name, device="cpu", smoke=True,
                            **cut)
    specs = tsteps._gnn_batch_specs(cell.model.cfg,
                                    {**GNN_SHAPES[shape_name], **cut})
    for name, spec in specs.items():
        if name != "n_graphs":
            t = getattr(cell.batch, name)
            assert (tuple(t.shape), t.dtype) == spec, name
    before = [p.detach().clone() for p in cell.model.parameters()]
    m = cell.step()
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    assert any(not torch.equal(a, b) for a, b in
               zip(before, cell.model.parameters()))
