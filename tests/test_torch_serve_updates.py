"""Streamed graph updates through the port's GnnServeEngine, against the
JAX engine (the port-to-JAX version of ``tests/test_gnn_serve.py``'s
``test_interleaved_updates_and_inference_match_sequential_oracle``):
updates and queries interleave on one FIFO; every prediction and the
final CSC equal the JAX engine's run of the same stream, bit for bit,
under SLICE_CFG and MERGE_CFG routing on the twins; the step program
is built once and the engine's CSC tensors keep their addresses (the
update is copied into them in place). Also: the update guards, an
overflowing update that raises and leaves the graph as it was, and
``deactivate_update``."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.graphsage_reddit import smoke_config as j_smoke  # noqa: E402
from repro.core import COO, convert, random_coo  # noqa: E402
from repro.models.gnn import gnn_init  # noqa: E402
from repro.serve import GnnServeEngine as JEngine  # noqa: E402
from repro_torch.configs.graphsage_reddit import smoke_config  # noqa: E402
from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core import pipeline as tp  # noqa: E402
from repro_torch.core.delta import EdgeDelta  # noqa: E402
from repro_torch.models.gnn import GraphSAGE, load_reference_params  # noqa: E402
from repro_torch.serve import GnnServeEngine  # noqa: E402
from repro_torch.serve.gnn import UPDATE_MARKER  # noqa: E402
from repro_torch.serve.slots import deactivate_update  # noqa: E402

N_NODES, D_FEAT, N_CLASSES, DELTA_CAP = 256, 12, 7, 16
_rng = np.random.default_rng(0)
_DST, _SRC = random_coo(_rng, N_NODES, 1500)
FEATS = _rng.normal(size=(N_NODES, D_FEAT)).astype(np.float32)
PARAMS = gnn_init(j_smoke(), jax.random.PRNGKey(1), d_in=D_FEAT,
                  n_classes=N_CLASSES)
CFGS = {"slice": tcm.EngineConfig(w_upe=256, use_pallas=True,
                                  sort_strategy="global_radix",
                                  reindex_strategy="fused"),
        "merge": tcm.EngineConfig(w_upe=256, use_pallas=True,
                                  sort_strategy="chunked_merge",
                                  reindex_strategy="unfused")}


def _stream(seed=5):
    """The warm-up history and the 12-item stream (every third an update
    of 4 inserts and 3 deletes of existing edges; the rest queries)."""
    rng = np.random.default_rng(seed)
    edges = list(zip(_DST.tolist(), _SRC.tolist()))

    def update():
        ins = [(int(rng.integers(N_NODES)), int(rng.integers(N_NODES)))
               for _ in range(4)]
        return ("u", ins, [edges[int(rng.integers(len(edges)))]
                           for _ in range(3)])

    def query():
        return ("q", rng.choice(N_NODES, int(rng.integers(1, 9)),
                                replace=False).tolist())
    history = [query(), update(), query()]
    stream = [update() if i % 3 == 2 else query() for i in range(12)]
    return history, stream


def _serve(eng, items):
    for item in items:
        if item[0] == "q":
            eng.submit(item[1])
        else:
            eng.submit_update(item[1], item[2])
    eng.close_submissions()
    return eng.run()


@functools.lru_cache(maxsize=None)
def _reference_run():
    """The JAX engine on the stream: {rid: predictions}, the final CSC."""
    eng = JEngine(j_smoke(), PARAMS,
                  convert(COO.from_arrays(_DST, _SRC, N_NODES,
                                          capacity=2048)),
                  jnp.asarray(FEATS), fanouts=(3, 2), n_slots=2, seed_cap=8,
                  delta_cap=DELTA_CAP)
    history, stream = _stream()
    done = _serve(eng, history)
    eng.reopen()
    done += _serve(eng, stream)
    csc = eng.params["csc"]
    return ({r.rid: list(r.tokens_out) for r in done},
            np.asarray(csc.ptr), np.asarray(csc.idx), int(csc.n_edges))


def _csc(cfg):
    return tp.convert(tg.COO.from_arrays(_DST, _SRC, N_NODES, capacity=2048,
                                         device="cpu"), cfg, device="cpu")


def _engine(cfg, csc=None):
    model = load_reference_params(
        GraphSAGE(smoke_config(), d_in=D_FEAT, n_classes=N_CLASSES,
                  device="cpu"), PARAMS)
    return GnnServeEngine(model, _csc(cfg) if csc is None else csc, FEATS,
                          fanouts=(3, 2), n_slots=2, seed_cap=8, cfg=cfg,
                          device="cpu", delta_cap=DELTA_CAP)


@pytest.mark.parametrize("which", sorted(CFGS))
def test_interleaved_updates_match_the_reference_engine(which):
    want, ptr, idx, n_edges = _reference_run()
    eng = _engine(CFGS[which])
    history, stream = _stream()
    done = _serve(eng, history)
    programs = eng.step_cache_size()
    csc = eng.params["csc"]
    addrs = [t.data_ptr() for t in (csc.ptr, csc.idx, csc.n_edges)]
    eng.reopen()
    done += _serve(eng, stream)
    assert programs == eng.step_cache_size() == 1
    assert eng.params["csc"] is csc
    assert [t.data_ptr() for t in (csc.ptr, csc.idx, csc.n_edges)] == addrs
    assert len(done) == len(history) + len(stream) == len(want)
    for req in done:
        assert req.tokens_out == want[req.rid], req.rid
    np.testing.assert_array_equal(csc.ptr.numpy(), ptr)
    np.testing.assert_array_equal(csc.idx.numpy(), idx)
    assert int(csc.n_edges) == n_edges


def test_predictions_follow_the_fifo_and_the_caller_graph_stays():
    """A query queued after an update samples the updated graph and one
    queued before it the old one (each equals the sequential slot_fn on
    that graph); the CSC the engine was built from is not written."""
    cfg = CFGS["slice"]
    orig = _csc(cfg)
    eng = _engine(cfg, orig)
    idx0 = orig.idx.clone()
    seeds = [int(d) for d in _DST[:6]]
    ins = [(d, 7) for d in seeds]
    dels = [(int(d), int(s)) for d, s in zip(_DST[:6], _SRC[:6])]
    first = eng.submit(seeds)
    up = eng.submit_update(ins, dels)
    second = eng.submit(seeds)
    eng.close_submissions()
    eng.run()
    assert up.prompt == [UPDATE_MARKER] and up.tokens_out == []
    assert isinstance(up.payload, EdgeDelta)
    row = torch.full((8,), tg.SENTINEL, dtype=torch.int32)
    row[:6] = torch.tensor(seeds)
    delta = EdgeDelta.from_arrays(*zip(*ins), *zip(*dels), n_nodes=N_NODES,
                                  capacity=DELTA_CAP, device="cpu")
    after = tp.apply_delta(orig, delta, cfg, out_capacity=2048)
    for req, graph in ((first, orig), (second, after)):
        seq = eng.slot_fn({**eng.params, "csc": graph}, row,
                          eng.request_key(req.rid))
        assert req.tokens_out == seq[:6].tolist()
    assert torch.equal(eng.params["csc"].idx, after.idx)
    assert torch.equal(orig.idx, idx0) and not torch.equal(idx0, after.idx)


@pytest.mark.parametrize("ins,dels,match", [
    ([], [], "empty update"),
    ([(0, 1)] * (DELTA_CAP + 1), [], "delta bucket"),
    ([], [(1, 2)] * (DELTA_CAP + 1), "delta bucket"),
    ([(0, N_NODES)], [], "out of range"),
    ([], [(-1, 3)], "out of range")])
def test_update_guards(ins, dels, match):
    eng = _engine(CFGS["slice"])
    with pytest.raises(ValueError, match=match):
        eng.submit_update(ins, dels)
    assert len(eng.queue) == 0


def test_overflowing_update_raises_and_leaves_the_graph():
    """An update whose inserts could overflow the index bucket (2,000 edges
    in 2,048 slots, 64 inserts) raises, and the engine's graph is the one
    it had."""
    d, s = random_coo(np.random.default_rng(3), N_NODES, 2000)
    cfg = CFGS["slice"]
    model = GraphSAGE(smoke_config(), d_in=D_FEAT, n_classes=N_CLASSES,
                      device="cpu")
    eng = GnnServeEngine(
        model, tp.convert(tg.COO.from_arrays(d, s, N_NODES, capacity=2048,
                                             device="cpu"), cfg,
                          device="cpu"),
        FEATS, fanouts=(3, 2), seed_cap=8, cfg=cfg, device="cpu",
        delta_cap=64)
    csc = eng.params["csc"]
    ptr, idx, n_edges = csc.ptr.clone(), csc.idx.clone(), int(csc.n_edges)
    eng.submit_update([(i, i) for i in range(64)])
    eng.close_submissions()
    with pytest.raises(RuntimeError, match="overflows"):
        eng.run()
    assert torch.equal(csc.ptr, ptr) and torch.equal(csc.idx, idx)
    assert int(csc.n_edges) == n_edges


def test_deactivate_update_clears_one_flag_in_place():
    state = {"active": torch.ones(4, dtype=torch.int32),
             "seeds": torch.zeros((4, 8), dtype=torch.int32)}
    flags = state["active"]
    out = deactivate_update(state, 2)
    assert out is state and state["active"] is flags
    assert flags.tolist() == [1, 1, 0, 1]
