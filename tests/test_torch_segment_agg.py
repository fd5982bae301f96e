"""repro_torch segment sum and the merge-configuration serve path against
the JAX reference: segment_sum_padded against the reference's
segment_sum_sorted kernel (Pallas interpret mode) for D = 1, 5 and 130,
with empty segments and a SENTINEL tail, within rtol = atol = 1e-5 (the
twin sums in float64 and rounds once; the reference's one-hot matmul sums
in float32 in another order); the kernel's span bounds (its plain
version ``span_bounds``: runs of nodes, a search of each run's two ends,
heads, a suffix minimum) equal to ``torch.searchsorted`` on sorted dst;
the fused call through the edge sources with the mean bit-equal to the
unfused composition it replaced and within the same tolerance of the
reference's ``seg_mean(use_pallas=True)``; GraphSAGE logits with use_pallas_agg
against the reference's gnn_apply with use_pallas_agg, within the same
tolerance and with argmax equal; and GnnServeEngine under MERGE_CFG,
batched equal to sequential bit for bit and equal to the reference's own
slot_fn under the same configuration."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.graphsage_reddit import smoke_config as j_smoke  # noqa: E402
from repro.core import COO, EngineConfig, convert, random_coo  # noqa: E402
from repro.core import pipeline as jp  # noqa: E402
from repro.kernels.ops import segment_sum_padded as j_seg  # noqa: E402
from repro.models.gnn import GraphBatch as JBatch  # noqa: E402
from repro.models.gnn import gnn_apply, gnn_init  # noqa: E402
from repro.models.gnn import gather_src as j_gather_src  # noqa: E402
from repro.models.gnn import seg_mean as j_seg_mean  # noqa: E402
from repro.models.gnn import seg_sum as j_seg_sum  # noqa: E402
from repro.models.gnn import subgraph_batch as j_batch  # noqa: E402
from repro.serve.gnn import build_slot_fn as j_slot_fn  # noqa: E402
from repro_torch.configs.graphsage_reddit import smoke_config  # noqa: E402
from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core import pipeline as tp  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels import segment_agg as tsa  # noqa: E402
from repro_torch.models.gnn import (GraphBatch, GraphSAGE,  # noqa: E402
                                    gather_src, load_reference_params,
                                    seg_mean, seg_sum, subgraph_batch)
from repro_torch.serve import GnnServeEngine  # noqa: E402

SEN = 0x7FFFFFFF
RTOL = ATOL = 1e-5
N_NODES, D_FEAT, N_CLASSES, SEED_CAP, FANOUTS = 256, 12, 7, 8, (3, 2)
MERGE_KW = dict(w_upe=64, use_pallas=True, sort_strategy="chunked_merge",
                reindex_strategy="unfused")
T_MERGE = tcm.EngineConfig(**MERGE_KW)
J_MERGE = EngineConfig(**MERGE_KW)
J_GCFG = dataclasses.replace(j_smoke(), use_pallas_agg=True)
T_GCFG = dataclasses.replace(smoke_config(), use_pallas_agg=True)

_rng = np.random.default_rng(0)
_DST, _SRC = random_coo(_rng, N_NODES, 1500)
FEATS = _rng.normal(size=(N_NODES, D_FEAT)).astype(np.float32)
J_PARAMS = gnn_init(j_smoke(), jax.random.PRNGKey(1), d_in=D_FEAT,
                    n_classes=N_CLASSES)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _segments(e, n, d, seed):
    """dst sorted, every third node without edges, a SENTINEL tail."""
    rng = np.random.default_rng(seed)
    nodes = np.arange(n)[np.arange(n) % 3 != 1]
    dst = np.sort(rng.choice(nodes, e - e // 4)).astype(np.int32)
    dst = np.concatenate([dst, np.full(e // 4, SEN, np.int32)])
    msgs = rng.normal(size=(e, d)).astype(np.float32)
    return dst, msgs


@pytest.mark.parametrize("d", [1, 5, 130])
@pytest.mark.parametrize("e,n", [(512, 256), (300, 77)])
def test_segment_sum_twin_matches_reference_kernel(d, e, n):
    dst, msgs = _segments(e, n, d, seed=d + e)
    want = np.asarray(j_seg(jnp.asarray(dst), jnp.asarray(msgs), n))
    got = tsa.segment_sum_padded(_t(dst), _t(msgs), n)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL)
    assert not got[1::3].any()  # empty segments stay zero
    # deterministic: the same bits on a second call
    assert torch.equal(got, tsa.segment_sum_padded(_t(dst), _t(msgs), n))


def _bounds_case(kind, e, n, seed):
    """A sorted dst of ``kind``: ``empty`` (every third node without
    edges), ``gaps`` (edges into every 97th node: runs of 96 empty nodes,
    longer than a thread writes), ``tail`` (a SENTINEL tail),
    ``sentinel`` (every edge SENTINEL), ``live`` (every edge into [0,
    n)), ``past`` (a tail of values in [n, SENTINEL) before the
    SENTINELs)."""
    rng = np.random.default_rng(seed)
    if kind == "sentinel":
        return np.full(e, SEN, np.int32)
    if kind == "empty":
        dst = np.sort(rng.choice(np.arange(n)[np.arange(n) % 3 != 1], e))
    elif kind == "gaps":
        dst = np.sort(rng.choice(np.arange(0, n, 97), e))
    else:
        dst = np.sort(rng.integers(0, n, e))
    if kind in ("tail", "past"):
        dst[e - e // 3:] = SEN
    if kind == "past":
        dst[e // 2:e - e // 3] = np.sort(rng.integers(n, SEN, e - e // 3
                                                      - e // 2))
    return dst.astype(np.int32)


@pytest.mark.parametrize("kind", ["empty", "tail", "sentinel", "live",
                                  "past", "gaps"])
@pytest.mark.parametrize("e,n", [(300, 77), (300, 7000), (5000, 1),
                                 (3000, 2), (0, 9), (1 << 19, 200_003),
                                 (70_000, 5)])
def test_span_bounds_equal_searchsorted(kind, e, n):
    """The bounds pass's plain version (each edge the first edge of the
    nodes between its predecessor's dst and its own, the tail's owner two
    numbers) gives ``searchsorted(dst, arange(n + 1))``: empty nodes, long
    runs of them, a SENTINEL tail, every edge SENTINEL, every edge live,
    n = 1, values in [n, SENTINEL), no edges."""
    dst = torch.from_numpy(_bounds_case(kind, e, n, seed=e + n))
    want = torch.searchsorted(dst, torch.arange(n + 1, dtype=torch.int32),
                              out_int32=True)
    got = tsa.span_bounds(dst, n)
    assert got.dtype == torch.int32 and torch.equal(got, want)


def _gather_case(e, n, d, seed):
    """dst sorted with empty nodes and a SENTINEL tail; src into [0, n)
    with every 7th out of range (clamped), SENTINEL where dst is; node
    states [n, d]."""
    dst, _ = _segments(e, n, 1, seed)
    rng = np.random.default_rng(seed + 1)
    src = rng.integers(0, n, e).astype(np.int32)
    src[::7] = n + 5
    src[dst == SEN] = SEN
    h = rng.normal(size=(n, d)).astype(np.float32)
    return dst, src, h


@pytest.mark.parametrize("mean", [True, False], ids=["mean", "sum"])
@pytest.mark.parametrize("e,n,d", [(512, 256, 5), (300, 77, 130),
                                   (64, 20, 1)])
def test_fused_gather_segment_sum_equals_unfused_and_reference(mean, e, n,
                                                               d):
    """segment_sum_sorted(dst, h, n, rows=src, mean) on the CPU gives the
    bits of the unfused composition (the gather, the masked stream, its
    segment sum, the degree sum, the division: seg_mean / seg_sum over
    gather_src with use_pallas), and lies within RTOL of the reference's
    seg_mean / seg_sum(use_pallas=True) on the same numpy inputs."""
    dst, src, h = _gather_case(e, n, d, seed=e + d)
    batch = GraphBatch(edge_dst=_t(dst), edge_src=_t(src), node_feat=_t(h))
    got = tsa.segment_sum_sorted(_t(dst), _t(h), n, rows=_t(src), mean=mean)
    unfused = (seg_mean if mean else seg_sum)(batch, gather_src(batch,
                                                                _t(h)), True)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, d)
    assert torch.equal(got, unfused)
    jb = JBatch(edge_dst=jnp.asarray(dst), edge_src=jnp.asarray(src),
                node_feat=jnp.asarray(h), labels=None, label_mask=None)
    want = np.asarray((j_seg_mean if mean else j_seg_sum)(
        jb, j_gather_src(jb, jnp.asarray(h)), use_pallas=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("agg", ["mean", "sum"])
def test_graphsage_pallas_agg_forward_keeps_its_bits(agg, monkeypatch):
    """GraphSAGE under use_pallas_agg (one fused call a layer) gives the
    logits the forward gave with the unfused gather, masked stream, degree
    sum and division, bit for bit, on batches from subgraph_batch."""
    import repro_torch.models.gnn as tgnn
    model = GraphSAGE(dataclasses.replace(T_GCFG, aggregator=agg),
                      d_in=D_FEAT, n_classes=N_CLASSES,
                      generator=torch.Generator().manual_seed(3),
                      device="cpu")
    csc = _t_csc()
    for rid, seeds in enumerate(_requests(3, seed=5)):
        sub = tp.sample_subgraph(csc, _t(_row(seeds)), FANOUTS,
                                 prng.fold_in(prng.PRNGKey(1), rid), T_MERGE)
        batch = subgraph_batch(sub, _t(FEATS))
        with torch.no_grad():
            got = model(batch)
            with monkeypatch.context() as mp:
                mp.setattr(tgnn, "_dst_seg_sum",
                           lambda b, x, rows, mean: (seg_mean if mean
                                                     else seg_sum)(
                               b, gather_src(b, x), True))
                want = model(batch)
        assert torch.equal(got, want), rid


def test_fused_call_refuses_what_the_kernel_cannot_take():
    """rows must be int32 [E] into a non-empty x; mean a bool."""
    dst, src, h = _gather_case(64, 20, 3, seed=4)
    with pytest.raises(ValueError, match="rows"):
        tsa.segment_sum_sorted(_t(dst), _t(h), 20, rows=_t(src).long())
    with pytest.raises(ValueError, match="rows"):
        tsa.segment_sum_sorted(_t(dst), _t(h), 20, rows=_t(src)[:10])
    with pytest.raises(ValueError, match="rows"):
        tsa.segment_sum_sorted(_t(dst), torch.zeros((0, 3)), 20,
                               rows=_t(src))
    with pytest.raises(ValueError, match="mean"):
        tsa.segment_sum_sorted(_t(dst), _t(h), 20, rows=_t(src), mean=1)


def test_seg_sum_pallas_ignores_ptr_and_masks_sentinels():
    """``seg_sum(use_pallas=True)`` sums by edge_dst alone (a wrong ptr
    changes nothing) and agrees with the pointer segment sum."""
    dst, msgs = _segments(64, 20, 3, seed=9)
    ptr = torch.searchsorted(_t(dst), torch.arange(21, dtype=torch.int32),
                             out_int32=True)
    batch = GraphBatch(edge_dst=_t(dst), edge_src=_t(dst),
                       node_feat=torch.zeros(20, 1), ptr=ptr)
    got = seg_sum(batch, _t(msgs), use_pallas=True)
    np.testing.assert_allclose(got.numpy(), seg_sum(batch, _t(msgs)).numpy(),
                               rtol=RTOL, atol=ATOL)
    batch.ptr = torch.zeros_like(ptr)
    assert torch.equal(seg_sum(batch, _t(msgs), use_pallas=True), got)


def _j_csc(cfg):
    return convert(COO.from_arrays(_DST, _SRC, N_NODES, capacity=2048), cfg)


def _t_csc():
    return tp.convert(tg.COO.from_arrays(_DST, _SRC, N_NODES, capacity=2048,
                                         device="cpu"), T_MERGE, device="cpu")


def _model():
    return load_reference_params(
        GraphSAGE(T_GCFG, d_in=D_FEAT, n_classes=N_CLASSES, device="cpu"),
        J_PARAMS)


def _requests(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.choice(N_NODES, int(rng.integers(1, SEED_CAP + 1)),
                       replace=False).tolist() for _ in range(n)]


def _row(seeds):
    row = np.full((SEED_CAP,), SEN, np.int32)
    row[:len(seeds)] = seeds
    return row


def test_logits_with_pallas_agg_match_reference_forward():
    """Same subgraph (sampled under the merge configuration on both
    sides), same weights: logits within the stated tolerance, argmax
    equal on every node."""
    jcsc, tcsc, model = _j_csc(J_MERGE), _t_csc(), _model()

    @jax.jit
    def j_logits(seeds, key):
        sub = jp.sample_subgraph(jcsc, seeds, FANOUTS, key, J_MERGE)
        return gnn_apply(J_GCFG, J_PARAMS, j_batch(sub, jnp.asarray(FEATS)))

    for rid, seeds in enumerate(_requests(3, seed=1)):
        key = prng.fold_in(prng.PRNGKey(0), rid)
        want = np.asarray(j_logits(jnp.asarray(_row(seeds)),
                                   jnp.asarray(np.array(key, np.uint32))))
        sub = tp.sample_subgraph(tcsc, _t(_row(seeds)), FANOUTS, key, T_MERGE)
        with torch.no_grad():
            got = model(subgraph_batch(sub, _t(FEATS))).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("n_slots", [1, 4])
def test_merge_cfg_serve_batched_equals_sequential_and_reference(n_slots):
    reqs = _requests(6, seed=2)
    eng = GnnServeEngine(_model(), _t_csc(), FEATS, fanouts=FANOUTS,
                         n_slots=n_slots, seed_cap=SEED_CAP, cfg=T_MERGE,
                         device="cpu")
    for seeds in reqs:
        eng.submit(seeds)
    eng.close_submissions()
    completed = eng.run()
    assert sorted(r.rid for r in completed) == list(range(len(reqs)))
    j_fn = jax.jit(j_slot_fn(J_GCFG, FANOUTS, SEED_CAP, J_MERGE))
    bundle = {"gnn": J_PARAMS, "csc": _j_csc(J_MERGE),
              "features": jnp.asarray(FEATS)}
    for req in completed:
        seeds = reqs[req.rid]
        seq = eng.slot_fn(eng.params, _t(_row(seeds)), eng.request_key(req.rid))
        assert req.tokens_out == seq[:len(seeds)].tolist(), req.rid
        key = jnp.asarray(np.array(eng.request_key(req.rid), np.uint32))
        ref = np.asarray(j_fn(bundle, jnp.asarray(_row(seeds)), key))
        assert req.tokens_out == ref[:len(seeds)].tolist(), req.rid
