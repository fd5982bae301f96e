"""repro_torch GAT, GatedGCN and MeshGraphNet against the JAX reference's
``gnn_apply``, with the reference's ``gnn_init`` weights carried across
by ``load_reference_params``, at their smoke configs: the forward with
and without CSC pointers, with ``use_pallas_agg`` on and off, with and
without edge features; ``seg_softmax`` on ragged pointers with empty
segments; ``layer_norm`` and ``mlp_apply``; the port's served
``slot_fn`` against the reference's ``build_slot_fn``; the configs and
the factory's head rule.

Tolerances, as a share of the largest |reference output| (at least 1):
the pointer sum differences float32 prefix sums, whose cancellation
grows with the prefix (GatedGCN's residual states grow a layer at a time:
1.2e-5 of it read here), so ``PTR_TOL`` = 1e-4; without pointers every
sum adds the same few terms in another order than XLA's segment_sum and
the matmuls block differently: ``TOL`` = 1e-5 (1.8e-7 read)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import gat_cora as j_gat  # noqa: E402
from repro.configs import gatedgcn as j_ggcn  # noqa: E402
from repro.configs import graphsage_reddit as j_sage  # noqa: E402
from repro.configs import meshgraphnet as j_mgn  # noqa: E402
from repro.core import COO, EngineConfig, convert, random_coo  # noqa: E402
from repro.core import pipeline as jp  # noqa: E402
from repro.models import common as jc  # noqa: E402
from repro.models import gnn as jg  # noqa: E402
from repro.serve.gnn import build_slot_fn as j_slot_fn  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core import pipeline as tp  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.models import common as tc  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from repro_torch.serve import GnnServeEngine  # noqa: E402
from repro_torch.serve.gnn import build_slot_fn  # noqa: E402

SEN = 0x7FFFFFFF
PTR_TOL, TOL = 1e-4, 1e-5
N, E, D_FEAT, D_EDGE, N_CLASSES = 40, 200, 12, 3, 5
ARCHS = {"gat-cora": j_gat, "gatedgcn": j_ggcn, "meshgraphnet": j_mgn}

_rng = np.random.default_rng(0)
_DST = np.sort(_rng.integers(0, N, E)).astype(np.int32)
_DST[-20:] = SEN  # a SENTINEL tail
_SRC = _rng.integers(0, N, E).astype(np.int32)
_PTR = np.searchsorted(_DST, np.arange(N + 1), side="left").astype(np.int32)
_X = _rng.normal(size=(N, D_FEAT)).astype(np.float32)
_EF = _rng.normal(size=(E, D_EDGE)).astype(np.float32)


def _t_cfg(j_cfg, **kw):
    """The port's GNNConfig with the reference config's fields."""
    fields = {f.name: getattr(j_cfg, f.name)
              for f in dataclasses.fields(j_cfg) if f.name != "dtype"}
    return tgnn.GNNConfig(**{**fields, **kw})


def _pair(arch, d_edge=0, n_classes=N_CLASSES, d_in=D_FEAT, seed=1):
    """(reference config, params; port model with the same weights)."""
    j_cfg = ARCHS[arch].smoke_config()
    params = jg.gnn_init(j_cfg, jax.random.PRNGKey(seed), d_in=d_in,
                         d_edge=d_edge, n_classes=n_classes)
    model = tgnn.gnn_model(_t_cfg(j_cfg), d_in=d_in, d_edge=d_edge,
                           n_classes=n_classes, device="cpu")
    return j_cfg, params, tgnn.load_reference_params(model, params)


def _scaled_close(got, want, tol):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, tol * scale)


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("ptr", [False, True])
@pytest.mark.parametrize("pallas", [False, True])
def test_forward_matches_reference(arch, ptr, pallas):
    j_cfg, params, model = _pair(arch)
    j_cfg = dataclasses.replace(j_cfg, use_pallas_agg=pallas)
    model.cfg = dataclasses.replace(model.cfg, use_pallas_agg=pallas)
    jb = jg.GraphBatch(edge_dst=jnp.asarray(_DST), edge_src=jnp.asarray(_SRC),
                       node_feat=jnp.asarray(_X),
                       labels=jnp.zeros(N, jnp.int32),
                       label_mask=jnp.zeros(N, bool),
                       ptr=jnp.asarray(_PTR) if ptr else None)
    want = np.asarray(jg.gnn_apply(j_cfg, params, jb))
    tb = tgnn.GraphBatch(edge_dst=torch.from_numpy(_DST),
                         edge_src=torch.from_numpy(_SRC),
                         node_feat=torch.from_numpy(_X),
                         ptr=torch.from_numpy(_PTR) if ptr else None)
    with torch.no_grad():
        got = model(tb).numpy()
    assert got.shape == want.shape == (N, N_CLASSES)
    # the pointer form's cancellation only arises where the pointer sum runs
    _scaled_close(got, want, PTR_TOL if ptr and not pallas else TOL)


@pytest.mark.parametrize("arch", ["gatedgcn", "meshgraphnet"])
def test_edge_features_feed_the_edge_encoder(arch):
    """With edge features the edge states start from the encoder (d_edge
    3); without them (the serve path) from zero, as the reference does."""
    j_cfg, params, model = _pair(arch, d_edge=D_EDGE)
    jb = jg.GraphBatch(edge_dst=jnp.asarray(_DST), edge_src=jnp.asarray(_SRC),
                       node_feat=jnp.asarray(_X),
                       labels=jnp.zeros(N, jnp.int32),
                       label_mask=jnp.zeros(N, bool),
                       edge_feat=jnp.asarray(_EF))
    want = np.asarray(jg.gnn_apply(j_cfg, params, jb))
    tb = tgnn.GraphBatch(edge_dst=torch.from_numpy(_DST),
                         edge_src=torch.from_numpy(_SRC),
                         node_feat=torch.from_numpy(_X),
                         edge_feat=torch.from_numpy(_EF))
    with torch.no_grad():
        got = model(tb).numpy()
        bare = model(dataclasses.replace(tb, edge_feat=None)).numpy()
    _scaled_close(got, want, TOL)
    assert not np.allclose(got, bare)


@pytest.mark.parametrize("heads", [1, 3])
def test_seg_softmax_on_ragged_pointers(heads):
    """Ragged segments (empty ones first, between and last, one of 30
    edges), a SENTINEL tail, scores far apart: the port's edge softmax,
    with the pointer sum and with index_add_, against the reference's
    (exp of the same differences; sums of a few terms in another order:
    1e-6). Each non-empty segment's weights sum to 1."""
    rng = np.random.default_rng(heads)
    deg = np.array([0, 0, 3, 1, 0, 30, 2, 0, 5, 0, 0, 1, 0], np.int64)
    n = deg.shape[0]
    dst = np.concatenate([np.repeat(np.arange(n), deg),
                          np.full(7, SEN)]).astype(np.int32)
    e = dst.shape[0]
    ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    scores = (rng.normal(size=(e, heads)) * 30).astype(np.float32)
    src = rng.integers(0, n, e).astype(np.int32)
    jb = jg.GraphBatch(edge_dst=jnp.asarray(dst), edge_src=jnp.asarray(src),
                       node_feat=jnp.zeros((n, 1)), labels=jnp.zeros(n),
                       label_mask=jnp.zeros(n, bool))
    want = np.asarray(jg.seg_softmax(jb, jnp.asarray(scores)))
    for p in (torch.from_numpy(ptr), None):
        tb = tgnn.GraphBatch(edge_dst=torch.from_numpy(dst),
                             edge_src=torch.from_numpy(src),
                             node_feat=torch.zeros((n, 1)), ptr=p)
        got = tgnn.seg_softmax(tb, torch.from_numpy(scores)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        sums = np.zeros((n, heads))
        np.add.at(sums, dst[dst < n], got[dst < n])
        np.testing.assert_allclose(sums[deg > 0], 1.0, rtol=1e-5)
        assert (got[dst >= n] == 0).all()


def test_layer_norm_and_mlp_match_reference():
    """LayerNorm (float32 inside, biased variance, eps 1e-5) within 1e-6
    (another reduction order in the mean and variance) and the plain MLP
    with the reference's mlp_init tree within TOL (GEMM blocking)."""
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(64, 48)) * 3 + 1).astype(np.float32)
    scale = rng.normal(size=(48,)).astype(np.float32)
    bias = rng.normal(size=(48,)).astype(np.float32)
    want = np.asarray(jc.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                    jnp.asarray(bias)))
    got = tc.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                        torch.from_numpy(bias)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    p = jc.mlp_init(jax.random.PRNGKey(3), (48, 32, 32, 7))
    tp_ = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    assert {k: tuple(v.shape) for k, v in tp_.items()} == {
        k: tuple(v.shape) for k, v in tc.mlp_init(
            torch.Generator().manual_seed(0), (48, 32, 32, 7)).items()}
    for final in (False, True):
        want = np.asarray(jc.mlp_apply(p, jnp.asarray(x), final_act=final))
        got = tc.mlp_apply(tp_, torch.from_numpy(x), final_act=final).numpy()
        _scaled_close(got, want, TOL)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_slot_fn_matches_reference(arch):
    """The served ``slot_fn`` (sample → convert → forward → argmax) of the
    port and of the reference, on the same graph, weights and keys:
    predictions equal wherever the reference's top-2 logit margin exceeds
    the pointer tolerance (PTR_TOL of the logits' scale; a seed the
    sampler gave no neighbour may have all-equal logits)."""
    n, seed_cap, fanouts = 256, 8, (3, 2)
    d, s = random_coo(np.random.default_rng(5), n, 1500)
    feats = np.random.default_rng(6).normal(size=(n, D_FEAT)).astype(
        np.float32)
    j_cfg, params, model = _pair(arch, d_in=D_FEAT)
    e_cfg = EngineConfig(sort_strategy="xla_sort", reindex_strategy="fused")
    t_ecfg = tcm.EngineConfig(w_upe=256, use_pallas=True,
                              sort_strategy="global_radix",
                              reindex_strategy="fused")
    jcsc = convert(COO.from_arrays(d, s, n, capacity=2048), e_cfg)
    tcsc = tp.convert(tg.COO.from_arrays(d, s, n, capacity=2048,
                                         device="cpu"), t_ecfg, device="cpu")

    @jax.jit
    def j_logits(seeds, key):
        sub = jp.sample_subgraph(jcsc, seeds, fanouts, key, e_cfg)
        return jg.gnn_apply(j_cfg, params, jg.subgraph_batch(
            sub, jnp.asarray(feats)))

    j_fn = jax.jit(j_slot_fn(j_cfg, fanouts, seed_cap, e_cfg))
    t_fn = build_slot_fn(fanouts, seed_cap, t_ecfg)
    t_bundle = {"gnn": model.eval(), "csc": tcsc,
                "features": torch.from_numpy(feats)}
    j_bundle = {"gnn": params, "csc": jcsc, "features": jnp.asarray(feats)}
    rng = np.random.default_rng(7)
    checked = 0
    for rid in range(4):
        row = np.full((seed_cap,), SEN, np.int32)
        k = int(rng.integers(1, seed_cap + 1))
        row[:k] = rng.choice(n, k, replace=False)
        key = prng.fold_in(prng.PRNGKey(0), rid)
        jkey = jnp.asarray(np.array(key, np.uint32))
        logits = np.asarray(j_logits(jnp.asarray(row), jkey))[:seed_cap]
        want = np.asarray(j_fn(j_bundle, jnp.asarray(row), jkey))
        got = t_fn(t_bundle, torch.from_numpy(row), key).numpy()
        np.testing.assert_array_equal(want, logits.argmax(-1))
        top2 = np.sort(logits, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > PTR_TOL * max(
            1.0, float(np.abs(logits).max()))
        np.testing.assert_array_equal(got[clear], want[clear])
        checked += int(clear.sum())
    assert checked >= 8


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_families_serve_batched_equal_to_sequential(arch):
    """Each family through GnnServeEngine (one step program whatever the
    seed counts): every request equals its sequential slot_fn, and
    gnn_apply_batched stacks the single-lane forwards."""
    n = 128
    d, s = random_coo(np.random.default_rng(8), n, 700)
    feats = np.random.default_rng(9).normal(size=(n, 6)).astype(np.float32)
    model = tgnn.gnn_model(get_config(arch, smoke=True), d_in=6,
                           n_classes=4, generator=torch.Generator()
                           .manual_seed(0), device="cpu")
    eng = GnnServeEngine(model, tp.convert(tg.COO.from_arrays(
        d, s, n, capacity=1024, device="cpu"), device="cpu"), feats,
        fanouts=(3, 2), n_slots=2, seed_cap=8, device="cpu")
    rng = np.random.default_rng(10)
    reqs = [rng.choice(n, int(rng.integers(1, 9)), replace=False).tolist()
            for _ in range(5)]
    for r in reqs:
        eng.submit(r)
    eng.close_submissions()
    done = eng.run()
    assert sorted(r.rid for r in done) == list(range(5))
    assert eng.step_cache_size() == 1
    subs = []
    for req in done:
        row = np.full((8,), SEN, np.int32)
        row[:len(reqs[req.rid])] = reqs[req.rid]
        seq = eng.slot_fn(eng.params, torch.from_numpy(row),
                          eng.request_key(req.rid))
        assert req.tokens_out == seq[:len(reqs[req.rid])].tolist()
        subs.append(tgnn.subgraph_batch(tp.sample_subgraph(
            eng.params["csc"], torch.from_numpy(row), (3, 2),
            eng.request_key(req.rid)), eng.params["features"]))
    with torch.no_grad():
        stacked = tgnn.gnn_apply_batched(model, subs[:2])
        for i in range(2):
            assert torch.equal(stacked[i], model(subs[i]))


@pytest.mark.parametrize("arch", ["graphsage-reddit"] + sorted(ARCHS))
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_the_reference(arch, smoke):
    mod = {**ARCHS, "graphsage-reddit": j_sage}[arch]
    want = mod.smoke_config() if smoke else mod.config()
    got = get_config(arch, smoke=smoke)
    assert got == _t_cfg(want)


@pytest.mark.parametrize("arch,out_dim", [("graphsage-reddit", 16),
                                          ("gat-cora", 4), ("gatedgcn", 8),
                                          ("meshgraphnet", 3)])
def test_factory_head_rule_and_tree_checks(arch, out_dim):
    """The head maps the model's output width (d_hidden; MeshGraphNet
    max(d_out, 1)) to the classes, as the reference's gnn_init; a tree
    naming other parameters, or another shape, is refused."""
    cfg = get_config(arch, smoke=True)
    model = tgnn.gnn_model(cfg, d_in=D_FEAT, n_classes=N_CLASSES,
                           device="cpu")
    assert tuple(model.head.shape) == (out_dim, N_CLASSES)
    j_cfg = {**ARCHS, "graphsage-reddit": j_sage}[arch].smoke_config()
    params = jg.gnn_init(j_cfg, jax.random.PRNGKey(0), d_in=D_FEAT,
                         n_classes=N_CLASSES)
    tgnn.load_reference_params(model, params)
    np.testing.assert_array_equal(model.head.detach().numpy(),
                                  np.asarray(params["head"]))
    with pytest.raises(ValueError, match="names"):
        tgnn.load_reference_params(model, {k: v for k, v in params.items()
                                           if k != "head"})
    with pytest.raises(ValueError, match="shape"):
        tgnn.load_reference_params(model, {**params, "head": np.zeros(
            (N_CLASSES, out_dim), np.float32)})
    with pytest.raises(ValueError, match="kind"):
        tgnn.gnn_model(dataclasses.replace(cfg, kind="gcn"), d_in=4,
                       device="cpu")
