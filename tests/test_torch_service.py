"""repro_torch engine.service (PreprocService, the pow2 buckets, the shared
dispatch table) against the JAX reference: the cases of
tests/test_engine_service.py and test_gnn_serve.py's
test_service_sample_batched_buckets_and_caches. Every PreprocService
result (subgraphs, batched samples, delta CSCs) is bit-identical to the
reference service's on the same inputs, and its ``stats`` and
``_keys_seen`` equal the reference's. Re-dispatching a (config, bucket)
pair already seen, from a fresh service too, adds no table entry and
loads no kernel library."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import COO as JCOO  # noqa: E402
from repro.core import pipeline as jp  # noqa: E402
from repro.core import random_coo  # noqa: E402
from repro.core.costmodel import EngineConfig as JCfg  # noqa: E402
from repro.core.costmodel import Workload as JW  # noqa: E402
from repro.core.delta import EdgeDelta as JDelta  # noqa: E402
from repro.core.reconfig import DynPre as JDynPre  # noqa: E402
from repro.core.reconfig import Engine as JEngine  # noqa: E402
from repro.engine import service as js  # noqa: E402
from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core import pipeline as tp  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.delta import EdgeDelta  # noqa: E402
from repro_torch.core.reconfig import DynPre, Engine  # noqa: E402
from repro_torch.engine import service as ts  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

jax.config.update("jax_platform_name", "cpu")
SEN = 0x7FFFFFFF


def _graph(seed=0, n=100, e=700, cap=1024):
    rng = np.random.default_rng(seed)
    dst, src = random_coo(rng, n, e)
    return (tg.COO.from_arrays(dst, src, n, capacity=cap, device="cpu"),
            JCOO.from_arrays(dst, src, n, capacity=cap))


def _jkey(key):
    return jnp.asarray(np.array(key, np.uint32))


def _same_sub(got, want):
    for g, w in ((got.csc.ptr, want.csc.ptr), (got.csc.idx, want.csc.idx),
                 (got.order, want.order), (got.csc.n_edges,
                                           want.csc.n_edges),
                 (got.n_sub_nodes, want.n_sub_nodes)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _jfields(cfg):
    return dataclasses.asdict(cfg)


def _same_service(t, j):
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)
    assert t._keys_seen == j._keys_seen
    assert (t.active_cfg is None) == (j.active_cfg is None)
    if t.active_cfg is not None:
        assert _jfields(t.active_cfg) == _jfields(j.active_cfg)


# ------------------------------------------------------------ the table
def test_service_zero_recompiles_for_reused_config_bucket():
    """Re-dispatching a (config, bucket) pair already seen, even from a
    fresh service, adds no table entry, builds no routing and loads no
    library; the services' results, stats and keys equal the
    reference's."""
    key = prng.PRNGKey(0)
    t1, j1 = ts.PreprocService(fanouts=(3, 2)), js.PreprocService((3, 2))
    tc, jc = _graph(seed=0, e=700)
    _same_sub(t1.preprocess(tc, torch.arange(12, dtype=torch.int32), key),
              j1.preprocess(jc, jnp.arange(12, dtype=jnp.int32), _jkey(key)))
    size, libs = ts.preprocess_cache_size(), dict(_build._LIBS)
    routes = dict(tp._KERNEL_FNS)
    t2, j2 = ts.PreprocService(fanouts=(3, 2)), js.PreprocService((3, 2))
    tc, jc = _graph(seed=1, e=800)
    _same_sub(t2.preprocess(tc, torch.arange(10, dtype=torch.int32), key),
              j2.preprocess(jc, jnp.arange(10, dtype=jnp.int32), _jkey(key)))
    assert ts.preprocess_cache_size() == size
    assert _build._LIBS == libs and tp._KERNEL_FNS == routes
    assert t1._keys_seen == t2._keys_seen
    assert t2.stats.n_dispatches == 1 and t2.stats.n_reconfigs == 1
    _same_service(t1, j1)
    _same_service(t2, j2)
    assert ts.PreprocService.cache_size() == ts.preprocess_cache_size()


def test_engine_shim_shares_module_level_cache():
    """Re-creating an Engine with a config already used hits the shared
    table; its subgraphs are the reference Engine's."""
    cfg, jcfg = tcm.EngineConfig(w_upe=256, n_upe=4), JCfg(w_upe=256,
                                                           n_upe=4)
    bn = np.arange(16, dtype=np.int32)
    key = prng.PRNGKey(1)
    tc, jc = _graph(seed=2)
    _same_sub(Engine(cfg, (3, 2)).preprocess(tc, torch.from_numpy(bn), key),
              JEngine(jcfg, (3, 2)).preprocess(jc, jnp.asarray(bn),
                                               _jkey(key)))
    size = ts.preprocess_cache_size()
    tc, jc = _graph(seed=3)
    _same_sub(Engine(cfg, (3, 2)).preprocess(tc, torch.from_numpy(bn), key),
              JEngine(jcfg, (3, 2)).preprocess(jc, jnp.asarray(bn),
                                               _jkey(key)))
    assert ts.preprocess_cache_size() == size


def test_dynpre_preprocess_equals_the_reference():
    key = prng.PRNGKey(5)
    t, j = DynPre((3, 2)), JDynPre((3, 2))
    tc, jc = _graph(seed=6, e=900)
    bn = np.arange(16, dtype=np.int32)
    _same_sub(t.preprocess(tc, torch.from_numpy(bn), key),
              j.preprocess(jc, jnp.asarray(bn), _jkey(key)))
    assert t.n_reconfigs == j.n_reconfigs == 1
    assert _jfields(t.engine.cfg) == _jfields(j.engine.cfg)


# ------------------------------------------------------------ bucketing
def test_bucket_coo_pads_to_pow2_capacity():
    tc, jc = _graph(cap=1000)
    b = ts.bucket_coo(tc)
    assert b.capacity == 1024 and int(b.n_edges) == int(tc.n_edges)
    assert torch.all(b.dst[1000:] == SEN)
    jb = js.bucket_coo(jc)
    np.testing.assert_array_equal(b.dst.numpy(), np.asarray(jb.dst))
    np.testing.assert_array_equal(b.src.numpy(), np.asarray(jb.src))
    assert ts.bucket_coo(b) is b


def test_bucket_batch_and_rows_and_delta_equal_the_reference():
    seeds = np.arange(12, dtype=np.int32)
    np.testing.assert_array_equal(
        ts.bucket_batch(torch.from_numpy(seeds)).numpy(),
        np.asarray(js.bucket_batch(jnp.asarray(seeds))))
    rows = np.arange(6, dtype=np.int32).reshape(2, 3)
    np.testing.assert_array_equal(
        ts.bucket_seed_rows(torch.from_numpy(rows)).numpy(),
        np.asarray(js.bucket_seed_rows(jnp.asarray(rows))))
    r4 = torch.zeros((2, 4), dtype=torch.int32)
    assert ts.bucket_seed_rows(r4) is r4
    d = EdgeDelta.from_arrays([0, 1, 2], [1, 2, 0], [0], [1], n_nodes=4,
                              capacity=3, device="cpu")
    jd = JDelta.from_arrays([0, 1, 2], [1, 2, 0], [0], [1], n_nodes=4,
                            capacity=3)
    b, jb = ts.bucket_delta(d), js.bucket_delta(jd)
    assert b.capacity == jb.capacity == 4
    for f in ("ins_dst", "ins_src", "del_dst", "del_src", "n_ins", "n_del"):
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      np.asarray(getattr(jb, f)))
    assert ts.bucket_delta(b) is b


def test_bucket_batch_sentinel_seeds_keep_first_vids():
    """SENTINEL-padded seeds have degree 0, so the real seeds keep the
    first new VIDs."""
    t, j = ts.PreprocService(fanouts=(3, 2)), js.PreprocService((3, 2))
    tc, jc = _graph(seed=4)
    key = prng.PRNGKey(0)
    sub = t.preprocess(tc, np.arange(12, dtype=np.int32), key)
    np.testing.assert_array_equal(sub.order[:12].numpy(), np.arange(12))
    _same_sub(sub, j.preprocess(jc, jnp.arange(12, dtype=jnp.int32),
                                _jkey(key)))
    _same_service(t, j)


def test_bucketed_selection_is_bucket_pure():
    t1, t2 = ts.PreprocService(fanouts=(3, 2)), ts.PreprocService((3, 2))
    cfg_a = t1.select(_graph(seed=0, e=600)[0], 16)
    cfg_b = t2.select(_graph(seed=1, e=900)[0], 16)
    assert cfg_a == cfg_b
    j = js.PreprocService((3, 2))
    assert _jfields(cfg_a) == _jfields(j.select(_graph(seed=0, e=600)[1],
                                                16))
    assert t1.profile(_graph(cap=1000)[0], 8, bucketed=True).e == 1024
    assert t1.profile(_graph(e=700)[0], 8).e == 700


def test_service_reconfigures_on_diverse_buckets():
    t, j = ts.PreprocService(fanouts=(10, 10)), js.PreprocService((10, 10))
    small = tg.COO(dst=torch.zeros(1024, dtype=torch.int32),
                   src=torch.zeros(1024, dtype=torch.int32),
                   n_edges=torch.tensor(1000, dtype=torch.int32),
                   n_nodes=500)
    jsmall = JCOO(dst=jnp.zeros(1024, jnp.int32),
                  src=jnp.zeros(1024, jnp.int32),
                  n_edges=jnp.int32(1000), n_nodes=500)
    c1 = t.select(small, 64)
    assert _jfields(c1) == _jfields(j.select(jsmall, 64))
    d = t.decide(tcm.Workload(n=3 * 10**6, e=1 << 27, l=2, k=10, b=1024))
    jd = j.decide(JW(n=3 * 10**6, e=1 << 27, l=2, k=10, b=1024))
    assert d.config != c1
    assert (d.reconfigure, _jfields(d.config), d.predicted_gain_s) == (
        jd.reconfigure, _jfields(jd.config), jd.predicted_gain_s)
    _same_service(t, j)


# ------------------------------------------------------------ batched
def test_service_sample_batched_buckets_and_caches():
    """Per-row pow2 SENTINEL bucketing, (config, bucket) accounting, no
    new entry on re-dispatch; lanes equal the reference service's."""
    rng = np.random.default_rng(0)
    dst, src = random_coo(rng, 256, 1500)
    csc = tp.convert(tg.COO.from_arrays(dst, src, 256, capacity=2048,
                                        device="cpu"), device="cpu")
    jcsc = jp.convert(JCOO.from_arrays(dst, src, 256, capacity=2048))
    keys = prng.split(prng.PRNGKey(7), 2)
    jkeys = jax.random.split(jax.random.PRNGKey(7), 2)
    rows = np.arange(6, dtype=np.int32).reshape(2, 3)  # buckets to [2, 4]
    t, j = ts.PreprocService(fanouts=(2, 2)), js.PreprocService((2, 2))
    sub = t.sample_batched(csc, torch.from_numpy(rows), keys)
    jsub = j.sample_batched(jcsc, jnp.asarray(rows), jkeys)
    assert sub.order.shape[0] == 2
    _same_sub(sub, jsub)
    before = ts.sample_batched_cache_size()
    sub2 = t.sample_batched(csc, torch.from_numpy(rows), keys)
    j.sample_batched(jcsc, jnp.asarray(rows), jkeys)
    assert ts.sample_batched_cache_size() == before
    assert t.stats.n_dispatches == 2 and t.stats.n_unique_keys == 1
    assert torch.equal(sub.order, sub2.order)
    _same_service(t, j)


# ------------------------------------------------------------ deltas
def _delta_case(seed, n, e, n_ins, n_del, cap):
    rng = np.random.default_rng(seed)
    dst, src = random_coo(rng, n, e)
    ins = rng.integers(0, n, (2, n_ins)).astype(np.int32)
    victims = rng.choice(e, n_del, replace=False)
    args = (ins[0], ins[1], dst[victims], src[victims])
    return (tg.COO.from_arrays(dst, src, n, capacity=cap, device="cpu"),
            JCOO.from_arrays(dst, src, n, capacity=cap),
            EdgeDelta.from_arrays(*args, n_nodes=n, device="cpu"),
            JDelta.from_arrays(*args, n_nodes=n))


@pytest.mark.parametrize("mode", ["auto", "merge", "rebuild"])
def test_service_apply_delta_equals_the_reference(mode):
    """The delta bucketed, the dispatch accounted under (e_cap, d bucket,
    out_cap), the CSC the reference service's; a re-dispatch adds no
    entry."""
    tc, jc, d, jd = _delta_case(0, 64, 200, 3, 5, 256)
    csc, jcsc = tp.convert(tc, device="cpu"), jp.convert(jc)
    t, j = ts.PreprocService(fanouts=(2, 2)), js.PreprocService((2, 2))
    out, jout = t.apply_delta(csc, d, mode=mode), j.apply_delta(jcsc, jd,
                                                               mode=mode)
    for g, w in ((out.ptr, jout.ptr), (out.idx, jout.idx),
                 (out.n_edges, jout.n_edges)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert out.idx.shape == csc.idx.shape and int(out.n_edges) == 198
    size = ts.apply_delta_cache_size()
    t.apply_delta(csc, d, mode=mode)
    j.apply_delta(jcsc, jd, mode=mode)
    assert ts.apply_delta_cache_size() == size
    _same_service(t, j)


def test_service_apply_delta_grows_the_output_bucket():
    """n_edges + n_ins past the index buffer: the output capacity grows to
    the next pow2, as the reference's."""
    tc, jc, d, jd = _delta_case(1, 64, 250, 20, 4, 256)
    csc, jcsc = tp.convert(tc, device="cpu"), jp.convert(jc)
    cfg, jcfg = tcm.EngineConfig(sort_strategy="xla_sort"), JCfg(
        sort_strategy="xla_sort")
    t, j = ts.PreprocService(fanouts=(2, 2)), js.PreprocService((2, 2))
    out = t.apply_delta(csc, d, cfg=cfg, mode="merge")
    jout = j.apply_delta(jcsc, jd, cfg=jcfg, mode="merge")
    assert out.idx.shape[0] == 512 == jout.idx.shape[0]
    np.testing.assert_array_equal(out.idx.numpy(), np.asarray(jout.idx))
    np.testing.assert_array_equal(out.ptr.numpy(), np.asarray(jout.ptr))
    _same_service(t, j)


# ------------------------------------------------------------ kernels, mesh
def test_kernel_library_gives_the_plain_library_s_subgraphs():
    """The library with the kernels routed (their twins here), as the card
    deployment builds it: DynPre picks the same entries, keyed ``_pl``,
    and samples the same subgraphs."""
    lib = [dataclasses.replace(c, use_pallas=True)
           for c in tcm.bitstream_library()]
    key = prng.PRNGKey(3)
    plain, pl = ts.PreprocService((3, 2)), ts.PreprocService((3, 2),
                                                             library=lib)
    for seed, e, cap in ((7, 300, 512), (8, 3000, 4096)):
        tc, _ = _graph(seed=seed, e=e, cap=cap)
        bn = torch.arange(8, dtype=torch.int32)
        a, b = plain.preprocess(tc, bn, key), pl.preprocess(tc, bn, key)
        for x, y in ((a.csc.ptr, b.csc.ptr), (a.csc.idx, b.csc.idx),
                     (a.order, b.order)):
            assert torch.equal(x, y)
        assert pl.active_cfg.key == plain.active_cfg.key + "_pl"


def _mesh(names, sizes):
    return SimpleNamespace(mesh_dim_names=names, ndim=len(sizes),
                           size=lambda i: sizes[i])


def test_a_data_parallel_mesh_names_the_sharded_engine(monkeypatch):
    """dp 2 routes preprocess through the shard engine's entry point for
    the mesh (``jit_shard_preprocess``, here recorded); a mesh with no dp
    extent, and no mesh, through the single-device table."""
    import repro_torch.engine.shard as tsh
    calls = []

    def entry(mesh):
        def fn(coo, bn, fanouts, key, cfg):
            calls.append((mesh, coo.capacity, tuple(bn.shape), fanouts,
                          key, cfg.key))
            return "sharded"
        return fn

    monkeypatch.setattr(tsh, "jit_shard_preprocess", entry)
    tc, _ = _graph(seed=2, e=300, cap=1000)
    key = prng.PRNGKey(4)
    cfg = tcm.EngineConfig()
    dp2 = _mesh(("data", "model"), (2, 1))
    got = ts.PreprocService((2,), mesh=dp2).preprocess(
        tc, torch.arange(5, dtype=torch.int32), key, cfg=cfg)
    assert got == "sharded"
    assert calls == [(dp2, 1024, (8,), (2,), key, cfg.key)]
    for mesh in (_mesh(("data", "model"), (1, 4)), None):
        sub = ts.PreprocService((2,), mesh=mesh).preprocess(
            tc, torch.arange(5, dtype=torch.int32), key, cfg=cfg)
        assert sub != "sharded" and len(calls) == 1


def test_submit_update_still_names_the_serve_half_of_delta_updates():
    """The serve half of delta updates goes through the service: a served
    update is one ``apply_delta_jit`` dispatch (a new table entry the
    first time, none for a second update of the same buckets), and the
    engine's graph after it equals ``pipeline.apply_delta`` of the same
    delta."""
    from repro_torch.configs.graphsage_reddit import smoke_config
    from repro_torch.models.gnn import GraphSAGE
    from repro_torch.serve import GnnServeEngine
    tc, _ = _graph(seed=9, n=64, e=300, cap=512)
    csc0 = tp.convert(tc, device="cpu")
    model = GraphSAGE(smoke_config(), d_in=4, n_classes=3, device="cpu")
    eng = GnnServeEngine(model, csc0, torch.zeros(64, 4), seed_cap=4,
                         device="cpu", delta_cap=4)
    updates = (([(0, 1), (5, 7)], [(int(tc.dst[0]), int(tc.src[0]))]),
               ([(2, 2)], []))
    before = ts.apply_delta_cache_size()
    for ins, dels in updates:
        eng.submit_update(ins, dels)
    eng.close_submissions()
    done = eng.run()
    assert [r.tokens_out for r in done] == [[], []]
    assert ts.apply_delta_cache_size() <= before + 1
    want = csc0
    for ins, dels in updates:
        delta = EdgeDelta.from_arrays(
            [d for d, _ in ins], [s for _, s in ins],
            [d for d, _ in dels], [s for _, s in dels], n_nodes=64,
            capacity=4, device="cpu")
        want = tp.apply_delta(want, delta, out_capacity=512)
    got = eng.params["csc"]
    assert torch.equal(got.ptr, want.ptr) and torch.equal(got.idx, want.idx)
    assert int(got.n_edges) == int(want.n_edges)


def test_engine_package_exports_the_reference_names_but_the_sharded_ones():
    import repro.engine as jeng
    import repro_torch.engine as teng
    assert set(teng.__all__) == {n for n in jeng.__all__
                                 if "shard" not in n}


@pytest.mark.parametrize("chunk", [32768, 65536])
def test_wide_chunks_route_through_sub_chunks_and_one_rung(chunk):
    """The library's widest ``w_upe`` chunks exceed one chunk-sort CTA
    (16,384 pairs, 32,768 keys): the routing sorts sub-chunks and merges
    them with one merge rung, the same output as one stable sort of the
    chunk (here on the twins; on the card a ``gpu`` test)."""
    from repro_torch.core.ordering import _chunk_sort
    from repro_torch.kernels import radix_sort as trs
    rng = np.random.default_rng(chunk)
    keys = torch.from_numpy(rng.integers(0, 1 << 12, 1 << 17).astype(
        np.int32))  # many equal keys: stability shows
    vals = torch.arange(1 << 17, dtype=torch.int32)
    fn = trs.make_chunk_sort_fn(4)
    for v in (vals, None):
        sub = trs.widest_sub_chunk(chunk, v is not None)
        assert sub == (16384 if v is not None else 32768)
        got = fn(keys, v, chunk, 12)
        want = _chunk_sort(keys, v, chunk, 12, 4)
        assert torch.equal(got[0], want[0])
        assert (got[1] is None) == (want[1] is None)
        if v is not None:
            assert torch.equal(got[1], want[1])
