"""repro_torch GraphSAGE + GnnServeEngine against the JAX reference, with
the reference's gnn_init weights carried across: logits within
rtol = atol = 1e-5 (the pointer segment sum's float cumsum and the matmuls
sum in another order than XLA's), argmax and the served predictions equal,
and the port's batched serving bit-identical to its sequential slot_fn
loop. The batched step's parts lane by lane (sample_subgraph_batched,
gnn_apply_batched) against single lanes and the reference's batched
functions, the pointer segment sum's twin against the reference and
segment_sum, the pointer sum's wrapper guards, and the step's guards: one step
program whatever the seed counts, a step refused on tensors rebound since
the program was built, slot reuse, no host read of a tensor value inside
the step (a CUDA graph capture would break on one)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.graphsage_reddit import smoke_config as j_smoke  # noqa: E402
from repro.core import COO, EngineConfig, convert, random_coo  # noqa: E402
from repro.core import pipeline as jp  # noqa: E402
from repro.models.gnn import _ptr_seg_sum as j_ptr_seg_sum  # noqa: E402
from repro.models.gnn import gnn_apply, gnn_apply_batched, gnn_init  # noqa: E402
from repro.models.gnn import subgraph_batch as j_batch  # noqa: E402
from repro.serve.gnn import build_slot_fn as j_slot_fn  # noqa: E402
from repro_torch.configs.graphsage_reddit import smoke_config  # noqa: E402
from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core import pipeline as tp  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels import ptr_scan  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from repro_torch.models.gnn import (GraphSAGE, load_reference_params,  # noqa: E402
                                    subgraph_batch)
from repro_torch.serve import GnnServeEngine  # noqa: E402

SEN = 0x7FFFFFFF
N_NODES, D_FEAT, N_CLASSES, SEED_CAP = 256, 12, 7, 8
RTOL = ATOL = 1e-5

_rng = np.random.default_rng(0)
_DST, _SRC = random_coo(_rng, N_NODES, 1500)
FEATS = _rng.normal(size=(N_NODES, D_FEAT)).astype(np.float32)
J_PARAMS = gnn_init(j_smoke(), jax.random.PRNGKey(1), d_in=D_FEAT,
                    n_classes=N_CLASSES)
J_CFG = EngineConfig(sort_strategy="xla_sort", reindex_strategy="fused")
SLICE_CFG = tcm.EngineConfig(w_upe=256, use_pallas=True,
                             sort_strategy="global_radix",
                             reindex_strategy="fused")
MERGE_CFG = tcm.EngineConfig(w_upe=256, use_pallas=True,
                             sort_strategy="chunked_merge",
                             reindex_strategy="unfused")


def _j_csc():
    return convert(COO.from_arrays(_DST, _SRC, N_NODES, capacity=2048), J_CFG)


def _t_csc():
    return tp.convert(tg.COO.from_arrays(_DST, _SRC, N_NODES, capacity=2048,
                                         device="cpu"), SLICE_CFG,
                      device="cpu")


def _model():
    return load_reference_params(
        GraphSAGE(smoke_config(), d_in=D_FEAT, n_classes=N_CLASSES,
                  device="cpu"), J_PARAMS)


def _requests(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.choice(N_NODES, int(rng.integers(1, SEED_CAP + 1)),
                       replace=False).tolist() for _ in range(n)]


def _row(seeds):
    row = np.full((SEED_CAP,), SEN, np.int32)
    row[:len(seeds)] = seeds
    return row


def test_weights_carry_keeps_reference_layout():
    model = _model()
    np.testing.assert_array_equal(model.layers[0]["w_self"].detach().numpy(),
                                  np.asarray(J_PARAMS["layers"][0]["w_self"]))
    assert tuple(model.layers[0]["w_nb"].shape) == (D_FEAT, 16)
    assert tuple(model.head.shape) == (16, N_CLASSES)
    bad = {**J_PARAMS, "head": np.zeros((N_CLASSES, 16), np.float32)}
    with pytest.raises(ValueError, match="shape"):
        load_reference_params(
            GraphSAGE(smoke_config(), d_in=D_FEAT, n_classes=N_CLASSES,
                      device="cpu"), bad)


@pytest.mark.parametrize("fanouts", [(3, 2), (4,)])
def test_logits_match_reference_forward(fanouts):
    """Same sampled subgraph (integer-exact), same weights: logits within
    the stated tolerance, argmax equal on every node."""
    jcsc, tcsc, model = _j_csc(), _t_csc(), _model()
    gcfg = j_smoke()

    @jax.jit
    def j_logits(seeds, key):
        sub = jp.sample_subgraph(jcsc, seeds, fanouts, key, J_CFG)
        return gnn_apply(gcfg, J_PARAMS, j_batch(sub, jnp.asarray(FEATS)))

    for rid, seeds in enumerate(_requests(3, seed=1)):
        key = prng.fold_in(prng.PRNGKey(0), rid)
        want = np.asarray(j_logits(jnp.asarray(_row(seeds)),
                                   jnp.asarray(np.array(key, np.uint32))))
        sub = tp.sample_subgraph(tcsc, torch.from_numpy(_row(seeds)), fanouts,
                                 key, SLICE_CFG)
        with torch.no_grad():
            got = model(subgraph_batch(sub, torch.from_numpy(FEATS))).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _engine(n_slots=2, fanouts=(3, 2)):
    return GnnServeEngine(_model(), _t_csc(), FEATS, fanouts=fanouts,
                          n_slots=n_slots, seed_cap=SEED_CAP, cfg=SLICE_CFG,
                          device="cpu")


@pytest.mark.parametrize("n_slots", [1, 2, 4])
def test_batched_serve_equals_sequential_and_reference(n_slots):
    """Every served prediction equals the port's sequential slot_fn loop
    (same request_key(rid)) and the reference's own slot_fn."""
    reqs = _requests(6, seed=2)
    eng = _engine(n_slots=n_slots)
    for seeds in reqs:
        eng.submit(seeds)
    eng.close_submissions()
    completed = eng.run()
    assert sorted(r.rid for r in completed) == list(range(len(reqs)))
    j_fn = jax.jit(j_slot_fn(j_smoke(), (3, 2), SEED_CAP, J_CFG))
    bundle = {"gnn": J_PARAMS, "csc": _j_csc(), "features": jnp.asarray(FEATS)}
    for req in completed:
        seeds = reqs[req.rid]
        seq = eng.slot_fn(eng.params, torch.from_numpy(_row(seeds)),
                          eng.request_key(req.rid))
        assert req.tokens_out == seq[:len(seeds)].tolist(), req.rid
        key = jnp.asarray(np.array(eng.request_key(req.rid), np.uint32))
        ref = np.asarray(j_fn(bundle, jnp.asarray(_row(seeds)), key))
        assert req.tokens_out == ref[:len(seeds)].tolist(), req.rid
    assert eng.stats.admitted == eng.stats.retired == len(reqs)
    assert eng.stats.tokens_generated == sum(map(len, reqs))


def test_admission_is_fifo_and_slots_fill_lowest_first():
    eng = _engine(n_slots=4)
    handles = [eng.submit(s) for s in _requests(7, seed=3)]
    eng.close_submissions()
    assert len(eng.run()) == 7
    admits = [h.admit_t for h in handles]
    assert admits == sorted(admits)
    assert [h.slot for h in handles[:4]] == [0, 1, 2, 3]


def test_reopen_serves_a_second_stream():
    eng = _engine()
    eng.submit([0, 1, 2])
    eng.close_submissions()
    assert len(eng.run()) == 1
    eng.reopen()
    eng.submit([3])
    eng.close_submissions()
    assert [r.rid for r in eng.run()] == [1]


def test_submit_guards_and_unported_updates():
    """The submit guards, and the update guards that now stand where the
    unported update raised: an empty update, more inserts or deletes than
    the delta bucket, and VIDs out of range each raise ValueError before
    anything is queued."""
    eng = _engine()
    with pytest.raises(ValueError):
        eng.submit([])
    with pytest.raises(ValueError):
        eng.submit(list(range(SEED_CAP + 1)))
    with pytest.raises(ValueError):
        eng.submit([N_NODES])
    with pytest.raises(ValueError, match="empty update"):
        eng.submit_update([], [])
    with pytest.raises(ValueError, match="delta bucket"):
        eng.submit_update([(0, 1)] * (eng.delta_cap + 1))
    with pytest.raises(ValueError, match="out of range"):
        eng.submit_update([(0, N_NODES)])
    assert len(eng.queue) == 0
    req = eng.submit_update([(0, 1)])
    assert req.prompt == [-2] and req.max_new == 0


def test_entry_points_refuse_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GnnServeEngine(_model(), _t_csc(), FEATS, seed_cap=SEED_CAP)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphSAGE(smoke_config(), d_in=D_FEAT, n_classes=N_CLASSES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from repro_torch.launch.serve import main
        main(["--arch", "graphsage-reddit", "--smoke"])


# ------------------------------------------------- the batched step's parts
def _lanes(fanouts, n_lanes=3, seed=7):
    """Seed rows [S, SEED_CAP] (the last lane idle: all SENTINEL), their
    request keys and the port's key schedules [S, K, 2]."""
    reqs = _requests(n_lanes - 1, seed=seed)
    rows = np.stack([_row(r) for r in reqs] + [_row([])])
    keys = [prng.fold_in(prng.PRNGKey(0), 10 + i) for i in range(n_lanes)]
    sched = torch.stack([prng.key_schedule(k, fanouts) for k in keys])
    return rows, keys, sched


def _lane(sub, i):
    """Lane ``i`` of a slot-batched Subgraph."""
    return tg.Subgraph(csc=tg.CSC(ptr=sub.csc.ptr[i], idx=sub.csc.idx[i],
                                  n_edges=sub.csc.n_edges[i],
                                  n_nodes=sub.csc.n_nodes),
                       order=sub.order[i], n_sub_nodes=sub.n_sub_nodes[i])


@pytest.mark.parametrize("cfg", [SLICE_CFG, MERGE_CFG],
                         ids=["slice", "merge"])
def test_sample_subgraph_batched_lanes_match_reference_and_single(cfg):
    """Every lane of the port's batched sampling equals the reference's
    sample_subgraph_batched lane and the port's single sample_subgraph of
    that row, integers bit for bit, under either routing (CPU twins)."""
    fanouts = (3, 2)
    rows, keys, sched = _lanes(fanouts)
    tcsc = _t_csc()
    got = tp.sample_subgraph_batched(tcsc, torch.from_numpy(rows), fanouts,
                                     sched, cfg)
    jkeys = jnp.asarray(np.array(keys, np.uint32))
    want = jp.sample_subgraph_batched(_j_csc(), jnp.asarray(rows), fanouts,
                                      jkeys, J_CFG)
    assert tuple(got.csc.ptr.shape) == tuple(want.csc.ptr.shape)
    for a, b in ((got.csc.ptr, want.csc.ptr), (got.csc.idx, want.csc.idx),
                 (got.order, want.order), (got.csc.n_edges, want.csc.n_edges),
                 (got.n_sub_nodes, want.n_sub_nodes)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for i in range(rows.shape[0]):
        one = tp.sample_subgraph(tcsc, torch.from_numpy(rows[i]), fanouts,
                                 keys[i], cfg)
        lane = _lane(got, i)
        for a, b in ((lane.csc.ptr, one.csc.ptr), (lane.csc.idx, one.csc.idx),
                     (lane.order, one.order), (lane.n_sub_nodes,
                                               one.n_sub_nodes)):
            assert torch.equal(a, b), i


def test_gnn_apply_batched_lanes_match_single():
    """Lanes of the batched forward are bit-identical to the forward on
    each lane's own batch, and within the stated tolerance of the
    reference's gnn_apply_batched."""
    fanouts = (2, 2)
    rows, keys, sched = _lanes(fanouts, n_lanes=3, seed=8)
    tcsc, model, feats = _t_csc(), _model(), torch.from_numpy(FEATS)
    sub = tp.sample_subgraph_batched(tcsc, torch.from_numpy(rows), fanouts,
                                     sched, SLICE_CFG)
    batches = [subgraph_batch(_lane(sub, i), feats)
               for i in range(rows.shape[0])]
    with torch.no_grad():
        stacked = tgnn.gnn_apply_batched(model, batches)
        for i in range(rows.shape[0]):
            one = tp.sample_subgraph(tcsc, torch.from_numpy(rows[i]), fanouts,
                                     keys[i], SLICE_CFG)
            assert torch.equal(stacked[i], model(subgraph_batch(one, feats)))
    jsub = jp.sample_subgraph_batched(
        _j_csc(), jnp.asarray(rows), fanouts,
        jnp.asarray(np.array(keys, np.uint32)), J_CFG)
    jbatch = jax.vmap(lambda s: j_batch(s, jnp.asarray(FEATS)))(jsub)
    want = np.asarray(gnn_apply_batched(j_smoke(), J_PARAMS, jbatch))
    np.testing.assert_allclose(stacked.numpy(), want, rtol=RTOL, atol=ATOL)


def _ragged_ptr(rng, n_rows, n_segs):
    """Sorted pointers in [0, n_rows] with empty segments, a first pointer
    past 0 and a last one short of n_rows."""
    p = np.sort(rng.integers(3, n_rows - 2, n_segs + 1))
    p[n_segs // 3:n_segs // 3 + 5] = p[n_segs // 3]
    return torch.from_numpy(p.astype(np.int32))


def test_ptr_segment_sum_matches_reference_and_segment_sum():
    """The pointer segment sum's twin (torch.cumsum along the rows, two
    index_selects) against the reference's _ptr_seg_sum on a request's
    own message stream (rtol = atol = 1e-5), the forward through the
    pointers against segment_sum (the port's index_add_ path with the
    pointers dropped), and the twin bit for bit against the transposed
    scan the port ran before."""
    sub = tp.sample_subgraph(_t_csc(), torch.arange(8, dtype=torch.int32),
                             (3, 2), prng.fold_in(prng.PRNGKey(0), 5),
                             SLICE_CFG)
    batch = subgraph_batch(sub, torch.from_numpy(FEATS))
    msgs = torch.where(tgnn._valid(batch)[:, None],
                       tgnn.gather_src(batch, batch.node_feat), 0.0)
    for m in (msgs, torch.ones((msgs.shape[0], 1))):
        got = tgnn._ptr_seg_sum(batch.ptr, m)
        want = np.asarray(j_ptr_seg_sum(jnp.asarray(batch.ptr.numpy()),
                                        jnp.asarray(m.numpy())))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
        p = batch.ptr.to(torch.int64)
        cs = torch.nn.functional.pad(torch.cumsum(m.T.contiguous(), dim=1),
                                     (1, 0))
        old = (cs.index_select(1, p[1:]) - cs.index_select(1, p[:-1])).T
        assert torch.equal(got, old)
    no_ptr = tgnn.GraphBatch(edge_dst=batch.edge_dst,
                             edge_src=batch.edge_src,
                             node_feat=batch.node_feat)
    model = _model()
    with torch.no_grad():
        np.testing.assert_allclose(model(batch).numpy(),
                                   model(no_ptr).numpy(), rtol=2e-5,
                                   atol=2e-5)


def test_ptr_segment_sum_twin_on_ragged_pointers_against_float64():
    """On ragged pointers (empty segments, a first pointer past 0, a last
    short of E) over a stream whose prefix reaches about 100, the twin is
    within its own float32 bound of the float64 prefix difference:
    (len + 1) / 2 ulps at twice the column's largest prefix
    (``twin_tolerance``'s terms)."""
    rng = np.random.default_rng(11)
    msgs = torch.from_numpy(rng.normal(size=(3000, 7)).astype(np.float32))
    ptr = _ragged_ptr(rng, 3000, 400)
    got = tgnn._ptr_seg_sum(ptr, msgs).double()
    p = ptr.to(torch.int64)
    cs = torch.nn.functional.pad(torch.cumsum(msgs.double(), 0), (0, 0, 1, 0))
    exact = cs[p[1:]] - cs[p[:-1]]
    seg = (p[1:] - p[:-1]).double()[:, None]
    ulp = ptr_scan.twin_tolerance(ptr, msgs) / (2 * seg + 4)
    assert bool(((got - exact).abs() <= (seg + 1) / 2 * ulp).all())


def test_ptr_seg_sum_wrapper_guards_and_chunking():
    """Shapes, the gather index (int32, 1-D, into a non-empty x) and the
    mean flag (a bool) are refused on the CPU as on the card; an empty
    pointer list gives an empty output."""
    ptr = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        ptr_scan.ptr_seg_sum(ptr, torch.zeros(4))
    for rows in (torch.zeros(4, dtype=torch.int64),
                 torch.zeros((4, 1), dtype=torch.int32)):
        with pytest.raises(ValueError, match="rows"):
            ptr_scan.ptr_seg_sum(ptr, torch.zeros((4, 2)), rows)
    with pytest.raises(ValueError, match="rows"):
        ptr_scan.ptr_seg_sum(ptr, torch.zeros((0, 2)),
                             torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="mean"):
        ptr_scan.ptr_seg_sum(ptr, torch.zeros((4, 2)), mean=1)
    out = ptr_scan.ptr_seg_sum(torch.zeros(1, dtype=torch.int32),
                               torch.zeros((0, 3)))
    assert tuple(out.shape) == (0, 3)
    out = ptr_scan.ptr_seg_sum(torch.zeros(1, dtype=torch.int32),
                               torch.zeros((5, 3)),
                               torch.zeros(0, dtype=torch.int32), mean=True)
    assert tuple(out.shape) == (0, 3)


def test_bucket_reuse_zero_recompiles_for_mixed_sizes():
    """One step program after warm-up, whatever the seed counts: every
    count in [1, SEED_CAP] reuses it (fixed pow2 rows, static state)."""
    eng = _engine(n_slots=4)
    assert eng.step_cache_size() == 0
    eng.submit([0, 1, 2])
    eng.close_submissions()
    eng.run()
    assert eng.step_cache_size() == 1
    rng = np.random.default_rng(4)
    eng.reopen()
    for k in range(1, SEED_CAP + 1):
        eng.submit(rng.choice(N_NODES, k, replace=False).tolist())
    eng.close_submissions()
    assert len(eng.run()) == SEED_CAP
    assert eng.step_cache_size() == 1
    # the step cleared the flags and zeroed the idle rows' predictions
    assert not bool(eng.state["active"].any())
    em = eng.state["emission"]
    assert not bool(em[em[:, 0] == 0, 1:].any())


def _rebind(eng, what):
    """Replace one tensor the step reads by a copy at a new address."""
    if what == "state.seeds":
        eng.state["seeds"] = eng.state["seeds"].clone()
    elif what == "features":
        eng.params["features"] = eng.params["features"].clone()
    else:
        weight = next(eng.params["gnn"].parameters())
        weight.data = weight.data.clone()


@pytest.mark.parametrize("what", ["state.seeds", "features", "gnn."])
def test_step_refuses_tensors_rebound_since_it_was_built(what):
    """The step program is bound to the tensors it was built on (on the
    card a CUDA graph replays on their addresses): writing a tensor in
    place serves on, rebinding a state, feature or weight tensor makes the
    next step raise and name it, and no second program is built."""
    eng = _engine(n_slots=2)
    eng.submit([0, 1])
    eng.close_submissions()
    eng.run()
    eng.params["features"].add_(0.0)  # in place: the same program serves
    eng.reopen()
    eng.submit([3])
    eng.close_submissions()
    assert len(eng.run()) == 1
    _rebind(eng, what)
    eng.reopen()
    eng.submit([4])
    eng.close_submissions()
    with pytest.raises(RuntimeError, match=what.replace(".", r"\.")):
        eng.run()
    assert eng.step_cache_size() == 1


def test_retirement_frees_slots_for_later_requests():
    """More requests than slots: every request completes with one
    prediction per seed, through slot reuse, each equal to the sequential
    slot_fn."""
    reqs = _requests(9, seed=3)
    eng = _engine(n_slots=2)
    for s in reqs:
        eng.submit(s)
    eng.close_submissions()
    completed = eng.run()
    assert sorted(r.rid for r in completed) == list(range(9))
    for r in completed:
        seeds = reqs[r.rid]
        assert len(r.tokens_out) == len(seeds)
        seq = eng.slot_fn(eng.params, torch.from_numpy(_row(seeds)),
                          eng.request_key(r.rid))
        assert r.tokens_out == seq[:len(seeds)].tolist()
    assert eng.stats.admitted == eng.stats.retired == 9
    assert eng.stats.steps < 9


def test_step_reads_no_tensor_value_on_the_host(monkeypatch):
    """The step function never brings a tensor value to the host nor
    builds a tensor from host data: on the card either would break the
    CUDA graph capture (a sync or a host-to-device copy inside it)."""
    eng = _engine(n_slots=2, fanouts=(25, 10))
    eng._admit_many([(0, _prep(eng, [1, 2, 3], 0)),
                     (1, _prep(eng, [4], 1))])

    def refuse(*a, **k):
        raise AssertionError("host read of a tensor value inside the step")
    for name in ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
                 "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "tensor", refuse)
    eng.step_fn(eng.params, eng.state)
    monkeypatch.undo()
    em = eng.state["emission"].numpy()
    assert em[:, 0].tolist() == [1, 1]
    for slot, (seeds, rid) in enumerate((([1, 2, 3], 0), ([4], 1))):
        seq = eng.slot_fn(eng.params, torch.from_numpy(_row(seeds)),
                          eng.request_key(rid))
        assert em[slot, 1:1 + len(seeds)].tolist() == \
            seq[:len(seeds)].tolist()


def _prep(eng, seeds, rid):
    from repro_torch.serve.feeder import PreparedAdmission
    from repro_torch.serve.request import Request
    return PreparedAdmission(Request(rid=rid, prompt=seeds), _row(seeds))
