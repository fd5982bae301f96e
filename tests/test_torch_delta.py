"""repro_torch core.delta and pipeline.apply_delta against the JAX
reference: the cases of tests/test_delta.py. Every spliced CSC equals the
numpy oracle's convert of the post-update edge list bit for bit, and on
the strategy axis (every sort_strategy x reindex_strategy x mode, both
kernel routings) it equals the reference's apply_delta on the same
inputs. The fuzz holds the port to the oracle (25 examples); the mode
resolution and the native sorts the merge path runs are held to the
reference's cost model."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import pipeline as jp  # noqa: E402
from repro.core.costmodel import EngineConfig as JCfg  # noqa: E402
from repro.core.costmodel import Workload as JW  # noqa: E402
from repro.core.costmodel import delta_sort_op_count  # noqa: E402
from repro.core.delta import EdgeDelta as JDelta  # noqa: E402
from repro.core.graph import COO as JCOO  # noqa: E402
from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core import pipeline as tp  # noqa: E402
from repro_torch.core.delta import EdgeDelta, delta_merge  # noqa: E402

jax.config.update("jax_platform_name", "cpu")
SEN = 0x7FFFFFFF


# ----------------------------------------------------------------- helpers
def _coo(dst, src, n_nodes, capacity=None):
    cap = capacity or tg.next_pow2(max(1, len(dst)))
    return tg.COO.from_arrays(np.asarray(dst, np.int32),
                              np.asarray(src, np.int32), n_nodes,
                              capacity=cap, device="cpu")


def _oracle_update(dst, src, ins, dels):
    """Post-update edge list by the delta contract: each delete kills at
    most one matching pre-update edge; same-delta inserts are never the
    victim."""
    keep = [True] * len(dst)
    avail = {}
    for i, e in enumerate(zip(dst, src)):
        avail.setdefault(e, []).append(i)
    for e in dels:
        for i in avail.get(tuple(e), []):
            if keep[i]:
                keep[i] = False
                break
    nd = [d for i, d in enumerate(dst) if keep[i]] + [d for d, _ in ins]
    ns = [s for i, s in enumerate(src) if keep[i]] + [s for _, s in ins]
    return nd, ns


def _expected_csc(nd, ns, n_nodes, out_cap):
    order = np.lexsort((np.asarray(ns), np.asarray(nd)))
    sd = np.asarray(nd, np.int64)[order]
    ss = np.asarray(ns, np.int32)[order]
    ptr = np.searchsorted(sd, np.arange(n_nodes + 1)).astype(np.int32)
    idx = np.full((out_cap,), SEN, np.int32)
    idx[:len(ss)] = ss
    return ptr, idx


def _delta(ins, dels, n_nodes, capacity=None):
    return EdgeDelta.from_arrays([d for d, _ in ins], [s for _, s in ins],
                                 [d for d, _ in dels], [s for _, s in dels],
                                 n_nodes=n_nodes, capacity=capacity,
                                 device="cpu")


def _check(csc, delta, dst, src, ins, dels, cfg=None, mode="auto",
           out_capacity=None):
    out = tp.apply_delta(csc, delta, cfg, mode=mode,
                         out_capacity=out_capacity)
    nd, ns = _oracle_update(list(dst), list(src), ins, dels)
    ptr, idx = _expected_csc(nd, ns, csc.n_nodes, out.idx.shape[0])
    assert int(out.n_edges) == len(nd)
    np.testing.assert_array_equal(out.ptr[:csc.n_nodes + 1].numpy(), ptr)
    np.testing.assert_array_equal(out.idx.numpy(), idx)
    return out


def _rand_case(rng, n_nodes, n_edges, n_ins, n_del, n_miss=0, d_cap=None):
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    ins = [(int(rng.integers(n_nodes)), int(rng.integers(n_nodes)))
           for _ in range(n_ins)]
    victims = rng.choice(n_edges, min(n_del, n_edges), replace=False)
    dels = [(int(dst[i]), int(src[i])) for i in victims]
    dels += [(int(rng.integers(n_nodes)), int(rng.integers(n_nodes)))
             for _ in range(n_miss)]
    return dst, src, ins, dels, _delta(ins, dels, n_nodes, d_cap)


def _reference(dst, src, n_nodes, cap, ins, dels, d_cap, cfg, mode,
               out_capacity=None):
    """The reference's apply_delta on the same inputs, on the CSC its
    native-sort convert gives (every strategy converts to the same CSC)."""
    csc = jp.convert(JCOO.from_arrays(np.asarray(dst, np.int32),
                                      np.asarray(src, np.int32), n_nodes,
                                      capacity=cap),
                     JCfg(sort_strategy="xla_sort"))
    d = JDelta.from_arrays(
        np.asarray([d for d, _ in ins], np.int32).reshape(-1),
        np.asarray([s for _, s in ins], np.int32).reshape(-1),
        np.asarray([d for d, _ in dels], np.int32).reshape(-1),
        np.asarray([s for _, s in dels], np.int32).reshape(-1),
        n_nodes=n_nodes, capacity=d_cap)
    return jp.apply_delta(csc, d, cfg, mode=mode, out_capacity=out_capacity)


def _same(out, ref):
    np.testing.assert_array_equal(out.ptr.numpy(), np.asarray(ref.ptr))
    np.testing.assert_array_equal(out.idx.numpy(), np.asarray(ref.idx))
    assert int(out.n_edges) == int(ref.n_edges)


# ------------------------------------------------- bit-identity, all axes
@pytest.mark.parametrize("mode", ["merge", "rebuild"])
@pytest.mark.parametrize("strategy",
                         ["auto", "xla_sort", "chunked_merge",
                          "global_radix"])
@pytest.mark.parametrize("reindex", ["fused", "unfused"])
def test_merge_bit_identical_across_strategies(strategy, reindex, mode):
    """Every (sort_strategy, reindex_strategy, mode) gives the CSC a fresh
    convert of the updated edge list gives, and the reference's
    apply_delta's, on plain routing and on the kernels' routing (their
    twins here; chunk 256, so the chunk sorts and merge rungs run)."""
    rng = np.random.default_rng(7)
    dst, src, ins, dels, delta = _rand_case(rng, 512, 1500, 100, 60,
                                            n_miss=20, d_cap=256)
    jcfg = JCfg(sort_strategy=strategy, reindex_strategy=reindex)
    ref = _reference(dst, src, 512, 2048, ins, dels, 256, jcfg, mode)
    for cfg in (tcm.EngineConfig(sort_strategy=strategy,
                                 reindex_strategy=reindex),
                tcm.EngineConfig(w_upe=256, use_pallas=True,
                                 sort_strategy=strategy,
                                 reindex_strategy=reindex)):
        csc = tp.convert(_coo(dst, src, 512, capacity=2048), cfg,
                         device="cpu")
        out = _check(csc, delta, dst, src, ins, dels, cfg=cfg, mode=mode)
        _same(out, ref)


def test_merge_equals_rebuild_mode():
    rng = np.random.default_rng(8)
    dst, src, ins, dels, delta = _rand_case(rng, 300, 900, 50, 40,
                                            n_miss=10, d_cap=128)
    csc = tp.convert(_coo(dst, src, 300, capacity=1024), device="cpu")
    a = tp.apply_delta(csc, delta, mode="merge")
    b = tp.apply_delta(csc, delta, mode="rebuild")
    assert torch.equal(a.ptr, b.ptr) and torch.equal(a.idx, b.idx)
    assert int(a.n_edges) == int(b.n_edges)
    _check(csc, delta, dst, src, ins, dels, mode="merge")


def test_pair_mode_wide_vid_space():
    """VID spaces too wide to pack (dst, src) into one int32 key route the
    delta sorts through the two-pass pair scheme: the same output, and the
    reference's."""
    n_nodes = 1 << 17
    rng = np.random.default_rng(9)
    dst = rng.integers(0, n_nodes, 700).astype(np.int32)
    src = rng.integers(0, n_nodes, 700).astype(np.int32)
    ins = [(int(rng.integers(n_nodes)), int(rng.integers(n_nodes)))
           for _ in range(30)]
    dels = [(int(dst[i]), int(src[i])) for i in range(25)]
    delta = _delta(ins, dels, n_nodes, capacity=64)
    csc = tp.convert(_coo(dst, src, n_nodes, capacity=1024), device="cpu")
    out = _check(csc, delta, dst, src, ins, dels, mode="merge")
    _same(out, _reference(dst, src, n_nodes, 1024, ins, dels, 64, JCfg(),
                          "merge"))


# ------------------------------------------------------- adversarial shapes
def test_duplicate_edges_multiset_delete_semantics():
    """k copies of an edge minus m deletes of it leaves max(k-m, 0) copies;
    a delete never kills a same-delta insert of the edge."""
    dst = [3, 3, 3, 5, 5, 7]
    src = [1, 1, 1, 2, 2, 0]
    ins = [(3, 1), (5, 2)]
    dels = [(3, 1), (3, 1), (5, 2), (5, 2), (5, 2), (9, 9)]
    delta = _delta(ins, dels, 16)
    csc = tp.convert(_coo(dst, src, 16, capacity=16), device="cpu")
    out = _check(csc, delta, dst, src, ins, dels, mode="merge")
    assert int(out.n_edges) == 6 - 4 + 2


def test_all_edges_deleted_and_inserts_only():
    dst, src = [1, 2, 3], [0, 0, 0]
    delta = _delta([], list(zip(dst, src)), 8)
    csc = tp.convert(_coo(dst, src, 8), device="cpu")
    out = _check(csc, delta, dst, src, [], list(zip(dst, src)),
                 mode="merge")
    assert int(out.n_edges) == 0
    ins = [(4, 5), (0, 1)]
    _check(out, _delta(ins, [], 8), [], [], ins, [], mode="merge")


def test_sentinel_heavy_sparse_buffer():
    """n_edges ≪ capacity: the SENTINEL tail stays inert."""
    rng = np.random.default_rng(10)
    dst, src, ins, dels, delta = _rand_case(rng, 64, 20, 10, 8, n_miss=4,
                                            d_cap=32)
    csc = tp.convert(_coo(dst, src, 64, capacity=1024), device="cpu")
    _check(csc, delta, dst, src, ins, dels, mode="merge")


def test_single_node_graph():
    dst, src = [0, 0], [0, 0]
    delta = _delta([(0, 0)], [(0, 0)], 1)
    csc = tp.convert(_coo(dst, src, 1), device="cpu")
    _check(csc, delta, dst, src, [(0, 0)], [(0, 0)], mode="merge")


def test_output_capacity_growth_and_ptr_tail():
    """out_capacity above the input bucket grows the index buffer; a
    padded pointer tail rides through, in both modes."""
    rng = np.random.default_rng(11)
    dst, src, ins, dels, delta = _rand_case(rng, 100, 250, 30, 5, d_cap=32)
    csc = tp.convert(_coo(dst, src, 100, capacity=256), device="cpu")
    tail = tg.CSC(ptr=torch.cat([csc.ptr, csc.ptr[-1:].expand(27)]),
                  idx=csc.idx, n_edges=csc.n_edges, n_nodes=100)
    for mode in ("merge", "rebuild"):
        out = _check(tail, delta, dst, src, ins, dels, mode=mode,
                     out_capacity=512)
        assert out.idx.shape[0] == 512
        assert out.ptr.shape[0] == tail.ptr.shape[0]
        assert torch.all(out.ptr[101:] == out.ptr[100])


def test_chained_deltas_stay_identical():
    """Five successive merges == one convert of the final edge list."""
    rng = np.random.default_rng(12)
    n_nodes = 200
    dst = list(rng.integers(0, n_nodes, 400).astype(int))
    src = list(rng.integers(0, n_nodes, 400).astype(int))
    csc = tp.convert(_coo(dst, src, n_nodes, capacity=1024), device="cpu")
    for _ in range(5):
        ins = [(int(rng.integers(n_nodes)), int(rng.integers(n_nodes)))
               for _ in range(20)]
        victims = rng.choice(len(dst), min(15, len(dst)), replace=False)
        dels = [(dst[i], src[i]) for i in victims]
        csc = _check(csc, _delta(ins, dels, n_nodes, 32), dst, src, ins,
                     dels, mode="merge")
        dst, src = _oracle_update(dst, src, ins, dels)


# -------------------------------------------------------------- mode resolve
def test_auto_mode_merges_small_deltas_rebuilds_huge_ones():
    cfg = tcm.EngineConfig()
    w = tcm.Workload(n=16384, e=131072)
    assert tcm.resolve_delta_mode(cfg, w, 256) == "merge"
    assert tcm.resolve_delta_mode(cfg, w, 16384) == "merge"
    assert tcm.resolve_delta_mode(cfg, w, 131072) == "rebuild"
    assert tcm.resolve_delta_mode(cfg, tcm.Workload(n=131073, e=1 << 20),
                                  131072) == "merge"


@pytest.mark.parametrize("n_nodes,passes", [(512, 1), (1 << 17, 2)])
def test_delta_program_census_expectations(n_nodes, passes, monkeypatch):
    """The resolved delta merge sorts natively (xla_sort): 2·passes + 1
    ``torch.sort`` calls, the reference's ``delta_sort_op_count`` (the +1
    is the event-zip rung); with the kernels routed the rung is a merge
    rung and no native sort runs for it. (The reference's while census
    has no torch counterpart.)"""
    cfg = tcm.EngineConfig()
    w = tcm.Workload(n=n_nodes, e=2048)
    assert tcm.resolve_delta_sort_strategy(
        cfg, tcm.delta_workload(w, 256)) == "xla_sort"
    want = delta_sort_op_count(JCfg(), JW(n=n_nodes, e=2048), 256)
    assert want == 2 * passes + 1
    rng = np.random.default_rng(13)
    dst, src, ins, dels, delta = _rand_case(rng, n_nodes, 700, 30, 20,
                                            d_cap=256)
    csc = tp.convert(_coo(dst, src, n_nodes, capacity=2048), device="cpu")
    calls = []
    real_sort = torch.sort

    def counted(*a, **k):
        calls.append(1)
        return real_sort(*a, **k)

    monkeypatch.setattr(torch, "sort", counted)
    tp.apply_delta(csc, delta, cfg, mode="merge")
    assert len(calls) == want
    calls.clear()
    routed = tcm.EngineConfig(use_pallas=True, sort_strategy="xla_sort")
    tp.apply_delta(csc, delta, routed, mode="merge")
    assert len(calls) == want - 1


def test_delta_merge_needs_a_sorted_event_table():
    """The event table is two sorted runs, so one merge rung zips it: a
    rung that sorts nothing (keeps the concatenation) gives another CSC,
    the rung the kernel routing passes gives the native sort's."""
    rng = np.random.default_rng(14)
    dst, src, ins, dels, delta = _rand_case(rng, 128, 600, 40, 30,
                                            d_cap=64)
    csc = tp.convert(_coo(dst, src, 128, capacity=1024), device="cpu")
    kf = tp.kernel_fns(tcm.EngineConfig(use_pallas=True))

    def sort_fn(k, v, bound):
        return tp.stable_sort_by_key(k, v, bound, strategy="xla_sort")

    want = delta_merge(csc, delta, sort_fn=sort_fn)
    got = delta_merge(csc, delta, sort_fn=sort_fn, rung_fn=kf.rung_fn,
                      rank_fn=kf.rank_fn, unroll=True)
    assert torch.equal(got.idx, want.idx) and torch.equal(got.ptr, want.ptr)
    bad = delta_merge(csc, delta, sort_fn=sort_fn,
                      rung_fn=lambda k, v, run, f: (k, v))
    assert not torch.equal(bad.idx, want.idx)


# ------------------------------------------------------------ property sweep
def test_delta_merge_property_fuzz():
    """Any (graph, delta) in the support gives the oracle CSC."""
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hyp.settings(max_examples=25, deadline=None)
    @hyp.given(data=st.data())
    def run(data):
        n_nodes = data.draw(st.integers(1, 64), label="n_nodes")
        n_edges = data.draw(st.integers(0, 80), label="n_edges")
        edge = st.tuples(st.integers(0, n_nodes - 1),
                         st.integers(0, n_nodes - 1))
        edges = data.draw(st.lists(edge, min_size=n_edges,
                                   max_size=n_edges), label="edges")
        ins = data.draw(st.lists(edge, max_size=24), label="ins")
        dels = data.draw(st.lists(edge, max_size=24), label="dels")
        dst = [d for d, _ in edges]
        src = [s for _, s in edges]
        csc = tp.convert(_coo(dst, src, n_nodes, capacity=128),
                         device="cpu")
        _check(csc, _delta(ins, dels, n_nodes), dst, src, ins, dels,
               mode="merge", out_capacity=256)

    run()


def test_edge_delta_fields_and_capacity():
    d = _delta([(0, 1), (2, 3), (1, 1)], [(0, 1)], 4)
    assert d.capacity == 4 and int(d.n_ins) == 3 and int(d.n_del) == 1
    assert d.del_dst.tolist() == [0, SEN, SEN, SEN]
    assert [f.name for f in dataclasses.fields(d)] == [
        "ins_dst", "ins_src", "del_dst", "del_src", "n_ins", "n_del",
        "n_nodes"]
