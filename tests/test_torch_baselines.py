"""The paper's GPU baselines of the port (``core/ordering.py``
``edge_ordering_xla``, ``core/pipeline.py`` ``convert_xla`` and
``preprocess_xla_baseline``, ``core/set_count.py`` ``searchsorted_oracle``)
against the JAX package's, bit for bit, on the same numpy inputs: packed-key
(200 nodes) and two-pass (40,000 ≥ 2^15 nodes) graphs in COOs padded with
SENTINEL. ``convert_xla`` also equals the port's own ``convert`` under every
``sort_strategy``, with and without the kernel routing (the twins on the
CPU)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import COO as JCOO  # noqa: E402
from repro.core import ordering as jo  # noqa: E402
from repro.core import pipeline as jp  # noqa: E402
from repro.core import random_coo  # noqa: E402
from repro.core import set_count as jsc  # noqa: E402
from repro_torch.core import (COO, SENTINEL, convert, convert_xla,  # noqa: E402
                              edge_ordering_xla, preprocess_xla_baseline,
                              searchsorted_oracle)
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.costmodel import (EngineConfig,  # noqa: E402
                                        SORT_STRATEGIES)

# (nodes, live edges, capacity): packed keys; two passes (2·16 bits > 31)
GRAPHS = ((200, 1500, 2048), (40_000, 5000, 8192))


def _graph(i):
    n, e, cap = GRAPHS[i]
    dst, src = random_coo(np.random.default_rng(30 + i), n, e)
    return n, np.asarray(dst, np.int32), np.asarray(src, np.int32), cap


def _coos(i):
    n, dst, src, cap = _graph(i)
    return (COO.from_arrays(dst, src, n, capacity=cap, device="cpu"),
            JCOO.from_arrays(dst, src, n, capacity=cap))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("i", range(len(GRAPHS)))
def test_edge_ordering_xla_bit_identical(i):
    """(dst, src) order with SENTINEL pads last, as ``jnp.lexsort``."""
    tc, jc = _coos(i)
    got, want = edge_ordering_xla(tc), jo.edge_ordering_xla(jc)
    _eq(got.dst, want.dst)
    _eq(got.src, want.src)
    assert int(got.n_edges) == int(want.n_edges)
    live = int(got.n_edges)
    assert (got.dst[live:] == SENTINEL).all()
    assert (got.src[live:] == SENTINEL).all()


@pytest.mark.parametrize("i", range(len(GRAPHS)))
def test_convert_xla_bit_identical(i):
    tc, jc = _coos(i)
    got, want = convert_xla(tc, device="cpu"), jp.convert_xla(jc)
    _eq(got.ptr, want.ptr)
    _eq(got.idx, want.idx)
    assert got.ptr.dtype == torch.int32 and got.n_nodes == want.n_nodes


@pytest.mark.parametrize("i", range(len(GRAPHS)))
@pytest.mark.parametrize("strategy", SORT_STRATEGIES)
def test_convert_xla_equals_convert_under_every_strategy(i, strategy):
    tc, _ = _coos(i)
    base = convert_xla(tc, device="cpu")
    for use_pallas in (False, True):
        cfg = EngineConfig(w_upe=512, sort_strategy=strategy,
                           use_pallas=use_pallas)
        got = convert(tc, cfg, device="cpu")
        _eq(got.ptr, base.ptr)
        _eq(got.idx, base.idx)


@pytest.mark.parametrize("i", range(len(GRAPHS)))
def test_preprocess_xla_baseline_bit_identical(i):
    """Keysort selection, the reindex map and the subgraph's CSC."""
    n, dst, src, cap = _graph(i)
    tc, jc = _coos(i)
    seeds = np.random.default_rng(40 + i).choice(n, 16, replace=False)
    key = prng.PRNGKey(5)
    got = preprocess_xla_baseline(tc, seeds.astype(np.int32), (4, 3), key,
                                  device="cpu")
    want = jp.preprocess_xla_baseline(
        jc, jnp.asarray(seeds, jnp.int32), (4, 3),
        jnp.asarray(np.array(key, np.uint32)))
    _eq(got.csc.ptr, want.csc.ptr)
    _eq(got.csc.idx, want.csc.idx)
    _eq(got.order, want.order)
    assert int(got.n_sub_nodes) == int(want.n_sub_nodes)
    assert int(got.csc.n_edges) == int(want.csc.n_edges)


@pytest.mark.parametrize("side", ("left", "right"))
def test_searchsorted_oracle_matches_reference(side):
    rng = np.random.default_rng(7)
    arr = np.sort(rng.integers(0, 100, 500)).astype(np.int32)
    q = rng.integers(-5, 105, 300).astype(np.int32)
    got = searchsorted_oracle(torch.from_numpy(arr), torch.from_numpy(q),
                              side)
    assert got.dtype == torch.int32
    _eq(got, jsc.searchsorted_oracle(jnp.asarray(arr), jnp.asarray(q), side))


def test_baselines_run_no_kernel_wrapper():
    """The baselines are library sorts and searches: no kernel scope opens
    (``analysis.census``), whatever the routing of the port."""
    from repro_torch.analysis.census import census
    tc, _ = _coos(0)
    with census("cpu") as c:
        convert_xla(tc, device="cpu")
    assert not c.calls and c.sort_count == 2
