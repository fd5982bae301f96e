"""The rest of the port's core primitives against the JAX reference, bit
for bit on numpy inputs from a seed: ``displacement``,
``partition_indices`` and ``radix_partition`` (set-partitioning),
``count_equal`` and ``rank_in_sorted2`` (set-counting, both sides, the
bisection and the unrolled lifting), ``build_pointer_array_serial`` and
``graph_convert`` (reshaping), and layer-wise selection
(``select_layerwise``, ``sample_layerwise``), whose draws come from the
port's threefry and whose top-k tie order from ``smallest_k``."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import COO, EngineConfig, convert, random_coo  # noqa: E402
from repro.core import reshaping as jr  # noqa: E402
from repro.core import sampling as js  # noqa: E402
from repro.core import set_count as jc  # noqa: E402
# repro.core re-exports the function set_partition under the module's name
jsp = importlib.import_module("repro.core.set_partition")
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core import pipeline as tp  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import reshaping as tr  # noqa: E402
from repro_torch.core import sampling as ts  # noqa: E402
from repro_torch.core import set_count as tc  # noqa: E402
from repro_torch.core import set_partition as tsp  # noqa: E402
from repro_torch.core.costmodel import EngineConfig as TEngineConfig  # noqa: E402

SEN = 0x7FFFFFFF
INT32_MIN = -(1 << 31)


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


# -------------------------------------------------------- set partitioning
@pytest.mark.parametrize("n,p", [(1, 0.5), (7, 0.0), (64, 1.0), (300, 0.3),
                                 (1025, 0.7)])
def test_displacement_and_partition_indices(n, p):
    cond = np.random.default_rng(n).random(n) < p
    _eq(tsp.displacement(torch.from_numpy(cond)),
        jsp.displacement(jnp.asarray(cond)))
    dest, n_sel = tsp.partition_indices(torch.from_numpy(cond))
    jdest, jn = jsp.partition_indices(jnp.asarray(cond))
    _eq(dest, jdest)
    _eq(n_sel, jn)
    assert sorted(dest.tolist()) == list(range(n))


@pytest.mark.parametrize("n,buckets,cols", [(1, 4, 0), (100, 16, 0),
                                            (257, 5, 2), (1000, 16, 3)])
def test_radix_partition(n, buckets, cols):
    rng = np.random.default_rng(buckets + n)
    keys = rng.integers(0, buckets, n).astype(np.int32)
    vals = rng.integers(-50, 50, (n, cols) if cols else n).astype(np.int32)
    got, base = tsp.radix_partition(torch.from_numpy(vals),
                                    torch.from_numpy(keys), buckets)
    want, jbase = jsp.radix_partition(jnp.asarray(vals), jnp.asarray(keys),
                                      buckets)
    _eq(got, want)
    _eq(base, jbase)
    _eq(got, vals[np.argsort(keys, kind="stable")])


# ----------------------------------------------------------- set counting
@pytest.mark.parametrize("e,t,block", [(0, 5, 2048), (10, 3, 4),
                                       (5000, 300, 2048), (777, 64, 100)])
def test_count_equal(e, t, block):
    rng = np.random.default_rng(e + t)
    vals = rng.integers(-5, 20, e).astype(np.int32)
    tgts = np.concatenate([rng.integers(-6, 21, t - 1),
                           [INT32_MIN]]).astype(np.int32)
    got = tc.count_equal(torch.from_numpy(vals), torch.from_numpy(tgts),
                         block=block)
    _eq(got, jc.count_equal(jnp.asarray(vals), jnp.asarray(tgts),
                            block=block))


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("unroll", [False, True])
@pytest.mark.parametrize("n", [1, 2, 33, 1000])
def test_rank_in_sorted2(side, unroll, n):
    rng = np.random.default_rng(n)
    a = rng.integers(0, 8, n).astype(np.int32)
    b = rng.integers(0, 8, n).astype(np.int32)
    order = np.lexsort((b, a))
    sa, sb = a[order], b[order]
    qa = rng.integers(-1, 10, 400).astype(np.int32)
    qb = rng.integers(-1, 10, 400).astype(np.int32)
    qa[:3], qb[:3] = SEN, SEN  # SENTINEL queries rank past everything
    got = tc.rank_in_sorted2(*map(torch.from_numpy, (sa, sb, qa, qb)),
                             side=side, unroll=unroll)
    want = jc.rank_in_sorted2(*map(jnp.asarray, (sa, sb, qa, qb)),
                              side=side, unroll=unroll)
    _eq(got, want)
    keys = (sa.astype(np.int64) << 32) + sb + (1 << 31)  # order-preserving
    q = (qa.astype(np.int64) << 32) + qb + (1 << 31)
    np.testing.assert_array_equal(got.numpy(),
                                  np.searchsorted(keys, q, side=side))


# -------------------------------------------------------------- reshaping
@pytest.mark.parametrize("n,e", [(1, 0), (5, 40), (300, 4000)])
def test_build_pointer_array_serial(n, e):
    rng = np.random.default_rng(n)
    dst = np.sort(rng.integers(0, n, e)).astype(np.int32)
    dst = np.concatenate([dst, np.full(7, SEN, np.int32)])  # a SENTINEL tail
    got = tr.build_pointer_array_serial(torch.from_numpy(dst), n)
    _eq(got, jr.build_pointer_array_serial(jnp.asarray(dst), n))
    _eq(got, tr.build_pointer_array(torch.from_numpy(dst), n))


@pytest.mark.parametrize("n,e,cap,chunk", [(40, 600, 1024, 256),
                                           (300, 3000, 4096, None),
                                           (70_000, 3000, 4096, 1024)])
def test_graph_convert(n, e, cap, chunk):
    """Packed keys below 2^15 nodes, the two-pass Ordering above."""
    dst, src = random_coo(np.random.default_rng(e), n, e)
    want = jr.graph_convert(COO.from_arrays(dst, src, n, capacity=cap),
                            chunk=chunk, ptr_capacity=n + 9)
    got = tr.graph_convert(tg.COO.from_arrays(dst, src, n, capacity=cap,
                                              device="cpu"),
                           chunk=chunk, ptr_capacity=n + 9)
    _eq(got.ptr, want.ptr)
    _eq(got.idx, want.idx)
    assert int(got.n_edges) == int(want.n_edges) and got.n_nodes == n


# ------------------------------------------------------ layer-wise sampling
def _graphs(seed=0, n=40, e=600):
    dst, src = random_coo(np.random.default_rng(seed), n, e)
    jcsc = convert(COO.from_arrays(dst, src, n, capacity=1024),
                   EngineConfig(w_upe=256))
    tcsc = tp.convert(tg.COO.from_arrays(dst, src, n, capacity=1024,
                                         device="cpu"),
                      TEngineConfig(w_upe=256), device="cpu")
    return jcsc, tcsc


def _jkey(key):
    return jnp.asarray(np.array(key, np.uint32))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k,window", [(8, 64), (25, 8), (150, 16), (3, 1)])
def test_select_layerwise(seed, k, window):
    """k above the union's size pads with SENTINEL; a frontier with
    SENTINEL, negative and out-of-range nodes has degree 0 there."""
    jcsc, tcsc = _graphs(seed)
    frontier = np.array([0, 1, 5, 17, 39, SEN, -1, 40, 3, 3], np.int32)
    key = prng.PRNGKey(seed * 7 + k)
    got = ts.select_layerwise(tcsc, torch.from_numpy(frontier), k, key,
                              window=window)
    want = js.select_layerwise(jcsc, jnp.asarray(frontier), k, _jkey(key),
                               window=window)
    _eq(got, want)
    valid = got[got != SEN].tolist()
    assert len(set(valid)) == len(valid)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("sizes,window", [((8, 6), 64), ((10, 10), 64),
                                          ((5, 40, 3), 8)])
def test_sample_layerwise(seed, sizes, window):
    jcsc, tcsc = _graphs(seed + 1, n=60, e=900)
    batch = np.array([0, 1, 2, 3, 59], np.int32)
    key = prng.PRNGKey(11 + seed)
    got = ts.sample_layerwise(tcsc, torch.from_numpy(batch), sizes, key,
                              window=window)
    want = js.sample_layerwise(jcsc, jnp.asarray(batch), sizes, _jkey(key),
                               window=window)
    for g, w in zip(got, want):
        _eq(g, w)
    assert got[0].shape[0] == batch.shape[0] + sum(sizes)
