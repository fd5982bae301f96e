"""repro_torch keysort and reservoir selection against the JAX reference,
bit for bit: the selectors, ``sample_khop`` and ``sample_subgraph`` under
``cfg.selection`` (plain and kernel routing, on the twins), each key
schedule layout against the reference's fold_in / split chain, keysort's
2-D draw against ``jax.random.uniform`` and its top-k order against
``lax.top_k`` on a constructed ``r`` full of ties. Degrees below k, above
the window, and SENTINEL, negative and out-of-range frontier nodes are
all in the frontiers. A keysort-served engine equals its sequential
``slot_fn`` and the reference's."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.graphsage_reddit import smoke_config as j_smoke  # noqa: E402
from repro.core import COO, EngineConfig, convert, random_coo  # noqa: E402
from repro.core import pipeline as jp  # noqa: E402
from repro.core import sampling as js  # noqa: E402
from repro.models.gnn import gnn_init  # noqa: E402
from repro.serve.gnn import build_slot_fn as j_slot_fn  # noqa: E402
from repro_torch.configs.graphsage_reddit import smoke_config  # noqa: E402
from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core import pipeline as tp  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import sampling as ts  # noqa: E402
from repro_torch.models.gnn import GraphSAGE, load_reference_params  # noqa: E402
from repro_torch.serve import GnnServeEngine  # noqa: E402

SEN = 0x7FFFFFFF
N = 300
_rng = np.random.default_rng(4)
# a power-law in-degree: hubs far above any window used here, many nodes
# below k, some with no edge at all
_DST = np.minimum(_rng.zipf(1.6, 4000) - 1, N - 1).astype(np.int32)
_SRC = _rng.integers(0, N, 4000).astype(np.int32)
J_CFG = EngineConfig(sort_strategy="xla_sort", reindex_strategy="fused")
T_PLAIN = tcm.EngineConfig(sort_strategy="xla_sort", reindex_strategy="fused")
SLICE_CFG = tcm.EngineConfig(w_upe=256, use_pallas=True,
                             sort_strategy="global_radix",
                             reindex_strategy="fused")
FRONTIER = np.array([0, 1, 2, 5, 17, N - 1, SEN, N + 3, -1, 100]
                    + list(range(20, 44)), np.int32)


def _j_csc():
    return convert(COO.from_arrays(_DST, _SRC, N, capacity=4096), J_CFG)


def _t_csc():
    return tp.convert(tg.COO.from_arrays(_DST, _SRC, N, capacity=4096,
                                         device="cpu"), T_PLAIN,
                      device="cpu")


def _jkey(key):
    return jnp.asarray(np.array(key, np.uint32))


def test_graph_spans_the_cases():
    deg = np.bincount(_DST, minlength=N)
    assert deg.max() > 1024 and (deg[FRONTIER[FRONTIER >= 0][
        FRONTIER[FRONTIER >= 0] < N]] < 3).any() and (deg == 0).any()


def _bare_rows(selection, key, k, window):
    """The rows a bare selector draws with from the key it is given (the
    reference's selector takes the layer key itself): keysort the key,
    reservoir window - k successive splits of it."""
    rows, lk = [], key
    if selection == "keysort":
        rows.append(key)
    for _ in range(max(0, window - k) if selection == "reservoir" else 0):
        lk, sub = prng.split(lk)
        rows.append(sub)
    return torch.tensor(rows, dtype=torch.int64).reshape(-1, 2)


@pytest.mark.parametrize("selection", ["keysort", "reservoir"])
@pytest.mark.parametrize("k,window", [(3, 8), (5, 64), (4, 1024)])
def test_selector_matches_reference(selection, k, window):
    """One layer's selector on the same key: neighbour VIDs [F, k]
    bit-equal (deg < k, deg > window, SENTINEL / OOB frontier)."""
    jcsc, tcsc = _j_csc(), _t_csc()
    key = prng.fold_in(prng.PRNGKey(3), 11)
    want = np.asarray(js._SELECTORS[selection](
        jcsc, jnp.asarray(FRONTIER), k, _jkey(key), window=window))
    got = ts._SELECTORS[selection](tcsc, torch.from_numpy(FRONTIER), k,
                                   _bare_rows(selection, key, k, window),
                                   window).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("selection", ["floyd", "keysort", "reservoir"])
@pytest.mark.parametrize("fanouts,window", [((5, 3), 16), ((4, 2), 1024)])
def test_sample_khop_matches_reference(selection, fanouts, window):
    jcsc, tcsc = _j_csc(), _t_csc()
    key = prng.fold_in(prng.PRNGKey(1), 5)
    want = js.sample_khop(jcsc, jnp.asarray(FRONTIER), fanouts, _jkey(key),
                          selection=selection, window=window)
    got = ts.sample_khop(tcsc, torch.from_numpy(FRONTIER), fanouts, key,
                         selection=selection, window=window)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # a schedule table laid out beforehand draws the same
    sched = prng.key_schedule(key, fanouts, selection, window)
    again = ts.sample_khop(tcsc, torch.from_numpy(FRONTIER), fanouts, sched,
                           selection=selection, window=window)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.parametrize("selection", ["keysort", "reservoir"])
@pytest.mark.parametrize("cfg", ["plain", "slice"])
def test_sample_subgraph_under_cfg_selection(selection, cfg):
    """The whole sampling (select → reindex → subgraph convert) under
    ``cfg.selection`` (default window 1024), on the plain route and on
    SLICE_CFG's kernel routing (twins), equals the reference's."""
    t_cfg = dataclasses.replace({"plain": T_PLAIN, "slice": SLICE_CFG}[cfg],
                                selection=selection)
    j_cfg = dataclasses.replace(J_CFG, selection=selection)
    jcsc, tcsc = _j_csc(), _t_csc()
    seeds = np.full((8,), SEN, np.int32)
    seeds[:6] = [0, 3, 9, 40, 299, 150]
    key = prng.fold_in(prng.PRNGKey(0), 2)
    want = jp.sample_subgraph(jcsc, jnp.asarray(seeds), (3, 2), _jkey(key),
                              j_cfg)
    got = tp.sample_subgraph(tcsc, torch.from_numpy(seeds), (3, 2), key,
                             t_cfg)
    for g, w in ((got.csc.ptr, want.csc.ptr), (got.csc.idx, want.csc.idx),
                 (got.order, want.order), (got.csc.n_edges,
                                           want.csc.n_edges),
                 (got.n_sub_nodes, want.n_sub_nodes)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("selection,fanouts,window",
                         [("keysort", (3, 2), 1024), ("keysort", (25, 10), 64),
                          ("reservoir", (3, 2), 16),
                          ("reservoir", (25, 10), 1024),
                          ("reservoir", (30,), 20)])
def test_key_schedule_layouts_match_reference_chain(selection, fanouts,
                                                    window):
    """keysort: one row a layer, fold_in(key, l); reservoir: window - k_l
    successive splits of fold_in(key, l) (none when the window is not
    wider), as the reference's selectors consume them."""
    key = prng.fold_in(prng.PRNGKey(2), 41)
    jk = jax.random.fold_in(jax.random.PRNGKey(2), 41)
    want = []
    for layer, k in enumerate(fanouts):
        jkl = jax.random.fold_in(jk, layer)
        if selection == "keysort":
            want.append(tuple(int(v) for v in np.asarray(jkl)))
            continue
        for _ in range(max(0, window - k)):
            jkl, jsub = jax.random.split(jkl)
            want.append(tuple(int(v) for v in np.asarray(jsub)))
    got = prng.key_schedule(key, fanouts, selection, window)
    assert got.dtype == torch.int64
    assert [tuple(r) for r in got.tolist()] == want
    assert got.shape[0] == sum(prng.schedule_rows(selection, fanouts,
                                                  window))


@pytest.mark.parametrize("shape", [(7, 33), (31, 1024)])
def test_keysort_2d_draw_is_the_flat_counter_draw(shape):
    """uniform(key, (F, W)) counts its elements row-major: the same bits as
    random_bits' flat counters reshaped, and as jax.random.uniform."""
    key = prng.fold_in(prng.PRNGKey(5), 3)
    f, w = shape
    got = prng.uniform_rows([key], f * w, "cpu").reshape(f, w).numpy()
    want = np.asarray(jax.random.uniform(_jkey(key), shape))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    bits = prng.random_bits([key], f * w, "cpu").reshape(f, w)
    assert torch.equal(prng._bits_to_unit_float(bits),
                       torch.from_numpy(got))


def test_smallest_k_breaks_ties_as_lax_top_k():
    """Rows of few distinct values (many ties), masked slots at 2.0, a row
    all masked: the same indices, in the same order, as
    ``lax.top_k(-r, k)``."""
    rng = np.random.default_rng(0)
    r = rng.choice(np.array([0.0, 0.25, 0.5, 0.75], np.float32), (40, 64))
    r[rng.random((40, 64)) < 0.3] = 2.0
    r[3] = 2.0
    r[5, :] = 0.5
    for k in (1, 5, 17, 64):
        want = np.asarray(jax.lax.top_k(-jnp.asarray(r), k)[1])
        got = ts.smallest_k(torch.from_numpy(r), k).numpy()
        np.testing.assert_array_equal(got, want)


def test_unknown_selection_and_a_misshapen_schedule_raise():
    tcsc = _t_csc()
    key = prng.PRNGKey(0)
    with pytest.raises(ValueError, match="unknown selection"):
        ts.sample_khop(tcsc, torch.zeros(4, dtype=torch.int32), (2,), key,
                       selection="layerwise")
    with pytest.raises(ValueError, match="keysort key schedule"):
        ts.sample_khop(tcsc, torch.zeros(4, dtype=torch.int32), (2, 2),
                       prng.key_schedule(key, (2, 2)), selection="keysort")


def test_keysort_served_equals_sequential_and_reference():
    """A keysort engine (schedules [S, 2, 2]) serves predictions equal to
    its sequential slot_fn and the reference's slot_fn under keysort."""
    d, s = random_coo(np.random.default_rng(0), 256, 1500)
    feats = np.random.default_rng(1).normal(size=(256, 12)).astype(
        np.float32)
    params = gnn_init(j_smoke(), jax.random.PRNGKey(1), d_in=12, n_classes=7)
    model = load_reference_params(
        GraphSAGE(smoke_config(), d_in=12, n_classes=7, device="cpu"), params)
    t_cfg = dataclasses.replace(SLICE_CFG, selection="keysort")
    eng = GnnServeEngine(
        model, tp.convert(tg.COO.from_arrays(d, s, 256, capacity=2048,
                                             device="cpu"), t_cfg,
                          device="cpu"),
        feats, fanouts=(3, 2), n_slots=2, seed_cap=8, cfg=t_cfg,
        device="cpu")
    assert tuple(eng.state["schedules"].shape) == (2, 2, 2)
    rng = np.random.default_rng(3)
    reqs = [rng.choice(256, int(rng.integers(1, 9)), replace=False).tolist()
            for _ in range(5)]
    for r in reqs:
        eng.submit(r)
    eng.close_submissions()
    done = eng.run()
    j_cfg = dataclasses.replace(J_CFG, selection="keysort")
    j_fn = jax.jit(j_slot_fn(j_smoke(), (3, 2), 8, j_cfg))
    bundle = {"gnn": params, "features": jnp.asarray(feats),
              "csc": convert(COO.from_arrays(d, s, 256, capacity=2048),
                             j_cfg)}
    for req in done:
        seeds = reqs[req.rid]
        row = np.full((8,), SEN, np.int32)
        row[:len(seeds)] = seeds
        seq = eng.slot_fn(eng.params, torch.from_numpy(row),
                          eng.request_key(req.rid))
        assert req.tokens_out == seq[:len(seeds)].tolist()
        ref = np.asarray(j_fn(bundle, jnp.asarray(row),
                              _jkey(eng.request_key(req.rid))))
        assert req.tokens_out == ref[:len(seeds)].tolist()
    assert eng.step_cache_size() == 1
