"""repro_torch Reindexing, the rank-epilogue kernel twins and the sampled
subgraph against the JAX reference: rank_search / rename equal the
reference's rank_search_tiles / reindex_rename_tiles (Pallas interpret
mode) on SENTINEL-heavy and single-element inputs, long duplicate runs,
all-SENTINEL streams, queries outside the stream, sorted queries (once
with one element out of order) and no queries, and so does the card
kernels' search loop, emulated here; the reindex map is
bit-identical in packed and pair mode under both epilogue strategies, and
sample_subgraph gives the same ptr / idx / order / n_sub_nodes under
global_radix and xla_sort with kernel routing on and off."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import COO, EngineConfig, convert, random_coo  # noqa: E402
from repro.core import pipeline as jp  # noqa: E402
from repro.core.reindexing import build_reindex_map as j_build  # noqa: E402
from repro.core.reindexing import reindex_edges as j_edges  # noqa: E402
from repro.kernels.reindex_epilogue import (pallas_rank_fn,  # noqa: E402
                                            pallas_rename_fn)
from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core import pipeline as tp  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.reindexing import (build_reindex_map,  # noqa: E402
                                         reindex_edges, reindex_serial_oracle)
from repro_torch.core.set_count import rank_in_sorted  # noqa: E402
from repro_torch.kernels import reindex_epilogue as tre  # noqa: E402

SEN = 0x7FFFFFFF


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


KINDS = ["random", "sentinel_heavy", "single", "long_runs", "all_sentinel",
         "outside", "sorted", "sorted_but_one", "no_queries"]


def _stream(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "single":
        arr = np.array([int(rng.integers(0, 50))], np.int32)
        q = np.array([arr[0] - 1, arr[0], arr[0] + 1, SEN], np.int32)
        return arr, q
    if kind == "long_runs":  # runs of 700 and 1200
        arr = np.sort(np.concatenate([
            rng.integers(0, 40, 300), np.full(700, 17), np.full(1200, 25),
            np.full(100, SEN)])).astype(np.int32)
        q = np.concatenate([np.arange(-2, 43), [17, 25, SEN] * 20,
                            rng.integers(0, 45, 200)]).astype(np.int32)
        return arr, q
    if kind == "all_sentinel":
        arr = np.full(500, SEN, np.int32)
        return arr, np.array([SEN] * 40 + [0, -7, SEN - 1], np.int32)
    if kind == "outside":  # below the first element, above the last valid
        arr = np.sort(rng.integers(100, 200, 400)).astype(np.int32)
        arr[350:] = SEN
        q = np.concatenate([rng.integers(-(2 ** 31), 100, 60),
                            rng.integers(200, SEN, 60), [SEN, SEN - 1,
                                                         -(2 ** 31)]])
        return arr, q.astype(np.int32)
    if kind in ("sorted", "sorted_but_one"):  # a pointer build's targets
        arr = np.sort(rng.integers(0, 300, 900)).astype(np.int32)
        arr[800:] = SEN
        q = np.arange(301, dtype=np.int32)
        if kind == "sorted_but_one":
            q[150] = 3
        return arr, q
    if kind == "no_queries":
        return np.sort(rng.integers(0, 9, 50)).astype(np.int32), np.zeros(
            0, np.int32)
    arr = np.sort(rng.integers(0, 100, 600)).astype(np.int32)
    if kind == "sentinel_heavy":
        arr[200:] = SEN  # SENTINEL tail
    q = rng.integers(-5, 120, 300).astype(np.int32)
    q[rng.random(300) < 0.3] = SEN
    return arr, q


def _reference_rank(arr, q, side):
    """The reference's Pallas rank; its adapter cannot take 0 queries
    (its tile would be 0), where the answer is the empty rank."""
    if q.size == 0:
        return np.zeros(0, np.int32)
    return np.asarray(pallas_rank_fn(jnp.asarray(arr), jnp.asarray(q), side))


def _reference_rename(arr, table, q):
    if q.size == 0:
        return np.zeros(0, np.int32)
    return np.asarray(pallas_rename_fn(jnp.asarray(arr), jnp.asarray(table),
                                       jnp.asarray(q)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("side", ["left", "right"])
def test_rank_search_twin_matches_reference_kernel(kind, side):
    arr, q = _stream(kind, seed=1)
    want = _reference_rank(arr, q, side)
    got = tre.rank_fn(_t(arr), _t(q), side)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for unroll in (False, True):  # the plain rank agrees too
        np.testing.assert_array_equal(
            rank_in_sorted(_t(arr), _t(q), side, unroll=unroll).numpy(),
            np.asarray(want))


@pytest.mark.parametrize("kind", KINDS)
def test_rename_twin_matches_reference_kernel(kind):
    arr, q = _stream(kind, seed=2)
    table = np.arange(arr.shape[0], dtype=np.int32) * 7
    want = _reference_rename(arr, table, q)
    got = tre.rename_fn(_t(arr), _t(table), _t(q))
    np.testing.assert_array_equal(got.numpy(), want)


def _kernel_search(arr, q, right, table=None):
    """``csrc/reindex_epilogue.cu``'s search, one query at a time in
    Python: rank_of's bisection (mid = (lo + hi) >> 1, until lo == hi),
    and rename_kernel's hit test at the rank clamped to [0, n - 1]."""
    n = arr.shape[0]
    out = np.zeros(q.shape[0], np.int64)
    for i, x in enumerate(q):
        lo, hi = 0, n
        while lo < hi:
            mid = (lo + hi) >> 1
            if (arr[mid] <= x) if right else (arr[mid] < x):
                lo = mid + 1
            else:
                hi = mid
        if table is None:
            out[i] = lo
        else:
            r = min(max(lo, 0), n - 1)
            out[i] = table[r] if arr[r] == x != SEN else SEN
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("side", ["left", "right", "rename"])
def test_kernel_search_path_emulated_matches_reference(kind, side):
    """The card kernels' own loop (a bisection that stops when it
    converges, where the twin runs the reference's fixed rounds with the
    converged-lane freeze) against the reference's Pallas kernels."""
    arr, q = _stream(kind, seed=3)
    if side == "rename":
        table = np.arange(arr.shape[0], dtype=np.int32) * 7
        got = _kernel_search(arr, q, False, table=table)
        want = _reference_rename(arr, table, q)
    else:
        got = _kernel_search(arr, q, side == "right")
        want = _reference_rank(arr, q, side)
    np.testing.assert_array_equal(got, want)


def _vids(n, bound, seed, sentinel_frac=0.3):
    rng = np.random.default_rng(seed)
    v = rng.integers(0, bound, n).astype(np.int32)
    v[rng.random(n) < sentinel_frac] = SEN
    return v


@pytest.mark.parametrize("numbering", ["first_occurrence", "sorted"])
@pytest.mark.parametrize("vid_bound", [300, None, 70000])
def test_reindex_map_bit_identical(numbering, vid_bound):
    """Packed (300), pair (None) and wide (70000 over 2^14 slots: pair)
    shared sorts, both epilogue strategies and the kernel twins."""
    n = 1 << 14 if vid_bound == 70000 else 1000
    vids = _vids(n, vid_bound or 400, seed=3)
    ref = j_build(jnp.asarray(vids), numbering=numbering,
                  vid_bound=vid_bound, strategy="fused")
    variants = [dict(strategy="fused"), dict(strategy="unfused"),
                dict(strategy="fused", rank_fn=tre.rank_fn,
                     rename_fn=tre.rename_fn)]
    e_dst = _vids(256, 500, seed=4, sentinel_frac=0.1)
    e_src = _vids(256, 500, seed=5, sentinel_frac=0.1)
    ref_e = j_edges(ref, jnp.asarray(e_dst), jnp.asarray(e_src), n)
    for kw in variants:
        got = build_reindex_map(_t(vids), numbering=numbering,
                                vid_bound=vid_bound, **kw)
        for name in ("sorted_vids", "slot_to_new", "order"):
            np.testing.assert_array_equal(
                getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                (name, kw.get("strategy"), "rank_fn" in kw))
        assert int(got.n_unique) == int(ref.n_unique)
        ge = reindex_edges(got, _t(e_dst), _t(e_src), n)
        np.testing.assert_array_equal(ge.dst.numpy(), np.asarray(ref_e.dst))
        np.testing.assert_array_equal(ge.src.numpy(), np.asarray(ref_e.src))
        assert int(ge.n_edges) == int(ref_e.n_edges)


def test_first_occurrence_order_matches_serial_oracle():
    vids = _vids(500, 120, seed=6)
    got = build_reindex_map(_t(vids), vid_bound=120)
    _, order = reindex_serial_oracle(vids)
    assert got.order[:len(order)].tolist() == order
    assert int(got.n_unique) == len(order)


N_NODES = 300
_DST, _SRC = random_coo(np.random.default_rng(0), N_NODES, 2000)


def test_sample_subgraph_bit_identical():
    """Selecting (Floyd + threefry), Reindexing and the subgraph
    re-conversion, end to end, against the reference's kernel path."""
    jcsc = convert(COO.from_arrays(_DST, _SRC, N_NODES, capacity=2048),
                   EngineConfig(sort_strategy="xla_sort"))
    tcoo = tg.COO.from_arrays(_DST, _SRC, N_NODES, capacity=2048,
                              device="cpu")
    seeds = np.array([5, 17, 3, 250, SEN, SEN, SEN, SEN], np.int32)
    key = prng.fold_in(prng.PRNGKey(3), 7)
    jkey = jnp.asarray(np.array(key, np.uint32))
    kw = dict(w_upe=256, sort_strategy="global_radix", use_pallas=True,
              reindex_strategy="fused")
    jcfg = EngineConfig(**kw)
    ref = jax.jit(lambda c, s, k: jp.sample_subgraph(c, s, (3, 2), k, jcfg))(
        jcsc, jnp.asarray(seeds), jkey)
    for strategy in ("global_radix", "xla_sort"):
        for use_pallas in (False, True):
            cfg = tcm.EngineConfig(w_upe=256, sort_strategy=strategy,
                                   use_pallas=use_pallas,
                                   reindex_strategy="fused")
            csc = tp.convert(tcoo, cfg, device="cpu")
            sub = tp.sample_subgraph(csc, _t(seeds), (3, 2), key, cfg)
            tag = (strategy, use_pallas)
            np.testing.assert_array_equal(sub.csc.ptr.numpy(),
                                          np.asarray(ref.csc.ptr), tag)
            np.testing.assert_array_equal(sub.csc.idx.numpy(),
                                          np.asarray(ref.csc.idx), tag)
            np.testing.assert_array_equal(sub.order.numpy(),
                                          np.asarray(ref.order), tag)
            assert int(sub.n_sub_nodes) == int(ref.n_sub_nodes), tag
            assert int(sub.csc.n_edges) == int(ref.csc.n_edges), tag
