"""repro_torch GraphSAGE + GnnServeEngine against the JAX reference, with
the reference's gnn_init weights carried across: logits within
rtol = atol = 1e-5 (the pointer segment sum's float cumsum and the matmuls
sum in another order than XLA's), argmax and the served predictions equal,
and the port's batched serving bit-identical to its sequential slot_fn
loop."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.graphsage_reddit import smoke_config as j_smoke  # noqa: E402
from repro.core import COO, EngineConfig, convert, random_coo  # noqa: E402
from repro.core import pipeline as jp  # noqa: E402
from repro.models.gnn import gnn_apply, gnn_init  # noqa: E402
from repro.models.gnn import subgraph_batch as j_batch  # noqa: E402
from repro.serve.gnn import build_slot_fn as j_slot_fn  # noqa: E402
from repro_torch.configs.graphsage_reddit import smoke_config  # noqa: E402
from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core import pipeline as tp  # noqa: E402
from repro_torch.core import prng  # noqa: E402
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
    eng = _engine()
    with pytest.raises(ValueError):
        eng.submit([])
    with pytest.raises(ValueError):
        eng.submit(list(range(SEED_CAP + 1)))
    with pytest.raises(ValueError):
        eng.submit([N_NODES])
    with pytest.raises(NotImplementedError):
        eng.submit_update([(0, 1)])


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
