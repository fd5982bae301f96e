"""repro_torch ``engine.shard`` (the sharded engine) against the reference's
single-device ``convert`` and ``preprocess``, bit for bit.

The oracle is the reference's single-device pipeline (its own mesh tests
fail under jax 0.9, so they are no oracle). A stable sort has one output,
so the reference's result does not depend on the strategy: it is taken
once a graph (``xla_sort``, unfused) and every port configuration —
``sort_strategy`` × ``reindex_strategy`` × ``use_pallas`` (the wrappers
run their twins on the CPU) — must equal it: ``ptr``, ``idx``, ``order``
and ``n_sub_nodes``. Two graphs: 100 nodes in a 1,024-edge COO (packed
keys, the keys-only sort) and 40,000 nodes in an 8,192-edge COO (two
passes with a payload).

* In spawned gloo groups of 2, 4 and 8 CPU processes
  (``tests/torch_dist_worker.py``, one spawn a world, several checks in
  it): ``shard_convert``, ``shard_preprocess``, ``PreprocService(mesh)``
  with dp above 1 (it routes through ``jit_shard_preprocess``), and the
  keys-only ``shard_sort_by_key``. A world of 3 takes the reference's
  fallback (3 is not a power of two) and matches too.
* In one process: the stages rank by rank (``shard_convert_ranks``, the
  gather a concatenation), as a single card runs them.
"""
import functools
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import COO as JCOO  # noqa: E402
from repro.core import pipeline as jp  # noqa: E402
from repro.core import random_coo  # noqa: E402
from repro.core.costmodel import EngineConfig as JCfg  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.costmodel import EngineConfig  # noqa: E402
from repro_torch.engine.shard import (_shardable,  # noqa: E402
                                      shard_convert_ranks)

from torch_dist_worker import run_ranks  # noqa: E402

GRAPHS = ((100, 700, 1024), (40_000, 6_000, 8_192))
W_UPE = 64
FANOUTS = (3, 2)
KEY = 3
CFGS = [dict(w_upe=W_UPE, sort_strategy=s, reindex_strategy=r,
             use_pallas=pl)
        for s, r, pl in itertools.product(
            ("chunked_merge", "global_radix", "xla_sort"),
            ("fused", "unfused"), (False, True))]


def _graph(i):
    n, e, cap = GRAPHS[i]
    dst, src = random_coo(np.random.default_rng(10 + i), n, e)
    seeds = np.random.default_rng(20 + i).choice(n, 8, replace=False)
    return dict(dst=np.asarray(dst, np.int32), src=np.asarray(src, np.int32),
                n=n, cap=cap, seeds=seeds.astype(np.int32))


@functools.lru_cache(maxsize=None)
def _reference(i):
    """The reference's single-device convert and preprocess of graph i."""
    g = _graph(i)
    jc = JCOO.from_arrays(g["dst"], g["src"], g["n"], capacity=g["cap"])
    cfg = JCfg(w_upe=W_UPE, sort_strategy="xla_sort",
               reindex_strategy="unfused")
    csc = jp.convert(jc, cfg)
    sub = jp.preprocess(jc, jnp.asarray(g["seeds"]), FANOUTS,
                        jnp.asarray(np.array(prng.PRNGKey(KEY), np.uint32)),
                        cfg)
    return ((np.asarray(csc.ptr), np.asarray(csc.idx)),
            (np.asarray(sub.csc.ptr), np.asarray(sub.csc.idx),
             np.asarray(sub.order), int(sub.n_sub_nodes)))


def _inputs():
    keys = np.random.default_rng(5).integers(0, 40, 256).astype(np.int32)
    keys[::7] = np.iinfo(np.int32).max  # SENTINEL pads past the bound
    return dict(graphs=[_graph(i) for i in range(len(GRAPHS))], cfgs=CFGS,
                fanouts=FANOUTS, key=prng.PRNGKey(KEY), sort_keys=keys,
                sort_bound=40)


@functools.lru_cache(maxsize=None)
def _world(n):
    return run_ranks("shard", _inputs(), (n,), ("data",))


def _same(got, want, what):
    for a, b in zip(got, want):
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=what)
        else:
            assert a == b, what


@pytest.mark.parametrize("world", [2, 4, 8, 3])
def test_shard_convert_and_preprocess_equal_the_reference(world):
    outs = _world(world)
    for rank, out in enumerate(outs):
        for gi, ci in itertools.product(range(len(GRAPHS)), range(len(CFGS))):
            conv, pre = _reference(gi)
            what = f"rank {rank} of {world}, graph {gi}, {CFGS[ci]}"
            j = gi * len(CFGS) + ci
            _same(out["convert"][j], conv, "convert " + what)
            _same(out["preprocess"][j], pre, "preprocess " + what)


@pytest.mark.parametrize("world", [2, 4])
def test_service_on_a_mesh_routes_through_the_shard_engine(world):
    """PreprocService(mesh) with dp above 1 calls shard_preprocess once
    (through jit_shard_preprocess) and returns the reference's
    subgraph."""
    for out in _world(world):
        *sub, calls = out["service"]
        assert calls == 1
        _same(sub, _reference(0)[1], f"service at world {world}")


@pytest.mark.parametrize("world", [2, 4, 8, 3])
def test_keys_only_sort_moves_no_payload(world):
    inp = _inputs()
    k = np.minimum(inp["sort_keys"], inp["sort_bound"])
    want = np.sort(k, kind="stable")
    want = np.where(want >= inp["sort_bound"], np.iinfo(np.int32).max, want)
    for out in _world(world):
        ks, no_payload = out["keys_only"]
        assert no_payload
        np.testing.assert_array_equal(ks, want)


def test_a_world_of_three_takes_the_fallback():
    assert not _shardable(1024, 3) and not _shardable(1024 + 512, 2)
    assert _shardable(1024, 4) and _shardable(1024, 8)


@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
def test_rank_by_rank_stages_equal_the_reference(world):
    """Every rank's stage in turn in one process (the card's form)."""
    for gi in range(len(GRAPHS)):
        g = _graph(gi)
        coo = tg.COO.from_arrays(g["dst"], g["src"], g["n"],
                                 capacity=g["cap"], device="cpu")
        conv, _ = _reference(gi)
        for fields in CFGS[::3]:
            csc = shard_convert_ranks(coo, EngineConfig(**fields), world)
            _same((csc.ptr.numpy(), csc.idx.numpy()), conv,
                  f"world {world}, graph {gi}, {fields}")
