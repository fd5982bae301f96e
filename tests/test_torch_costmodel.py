"""repro_torch core.costmodel and core.reconfig against the JAX reference:
every library entry x a workload grid (n up to Reddit's 232,965 nodes, e
from 2^10 to 2^27, b 1..1,024, l 1-3, k 2-25), under the default
Calibration and one drawn from a numpy seed. Every term, every
estimate_seconds dict and every delta term equals the reference's exactly
(plain Python arithmetic: the same floats, bit for bit); best_config and
choose_config are equal field for field; decide, DynPre, statpre and
autopre are equal over a sequence of diverse graphs. The HLO while
censuses have no torch counterpart and are not compared."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import costmodel as jcm  # noqa: E402
from repro.core import reconfig as jrc  # noqa: E402
from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.core import reconfig as trc  # noqa: E402

LIBRARY = list(zip(tcm.bitstream_library(), jcm.bitstream_library()))
STRATEGIES = ("chunked_merge", "global_radix", "xla_sort")


def _random_cal(seed):
    rng = np.random.default_rng(seed)
    base = dataclasses.asdict(tcm.Calibration())
    return {k: float(v * 10.0 ** rng.uniform(-2.0, 2.0))
            for k, v in base.items()}


CALS = {"default": dataclasses.asdict(tcm.Calibration()),
        "drawn": _random_cal(1234)}


def _cals(name):
    return tcm.Calibration(**CALS[name]), jcm.Calibration(**CALS[name])


def _grid():
    rng = np.random.default_rng(22)
    out = [(232_965, 1 << 27, 1024, 2, 25), (232_965, 114_615_892, 1024, 2,
                                             10),
           (100, 1 << 10, 1, 1, 2), (4096, 1 << 14, 16, 3, 5),
           (65_536, 1 << 20, 256, 2, 10), (1 << 17, 1 << 22, 64, 1, 25)]
    for _ in range(6):
        out.append((int(rng.integers(2, 232_966)),
                    int(2 ** rng.uniform(10, 27)), int(rng.integers(1, 1025)),
                    int(rng.integers(1, 4)), int(rng.integers(2, 26))))
    return out


GRID = _grid()


def _w(mod, g, **kw):
    n, e, b, l, k = g
    return mod.Workload(n=n, e=e, l=l, k=k, b=b, **kw)


def _fields(cfg):
    return dataclasses.asdict(cfg)


def test_constants_and_library_equal_the_reference():
    assert tcm.UPE_BUDGET == jcm.UPE_BUDGET
    assert tcm.SCR_BUDGET == jcm.SCR_BUDGET
    assert tcm.SORT_STRATEGIES == jcm.SORT_STRATEGIES
    assert tcm.REINDEX_STRATEGIES == jcm.REINDEX_STRATEGIES
    assert tcm.DELTA_MODES == jcm.DELTA_MODES
    assert dataclasses.asdict(tcm.Calibration()) == dataclasses.asdict(
        jcm.Calibration())
    assert len(LIBRARY) == 81
    for t, j in LIBRARY:
        assert _fields(t) == _fields(j) and t.key == j.key
    assert (trc.RECONFIG_S_FULL, trc.RECONFIG_S_PARTIAL) == (
        jrc.RECONFIG_S_FULL, jrc.RECONFIG_S_PARTIAL)
    from repro.core.delta import DELTA_RANK_PASSES as j_passes
    from repro_torch.core.delta import DELTA_RANK_PASSES as t_passes
    assert t_passes == j_passes


@pytest.mark.parametrize("cal", sorted(CALS))
@pytest.mark.parametrize("g", GRID, ids=lambda g: "n{}_e{}_b{}_l{}_k{}".format(
    *g))
def test_every_term_equals_the_reference(g, cal):
    """Each library entry (and the entry with every pinned strategy):
    the Table-I terms, the strategy resolvers, the reindex and capacity
    terms, the cycle counts and the estimate_seconds dict, exactly."""
    tc, jc = _cals(cal)
    tw, jw = _w(tcm, g), _w(jcm, g)
    n, e = g[0], g[1]
    assert tcm.sample_vid_capacity(tw) == jcm.sample_vid_capacity(jw)
    assert tcm.sample_edge_capacity(tw) == jcm.sample_edge_capacity(jw)
    for cap in (1, e, tcm.next_pow2(tcm.sample_vid_capacity(tw))):
        assert tcm.reindex_round_count(cap) == jcm.reindex_round_count(cap)
        assert tcm.reindex_query_count(cap, e) == jcm.reindex_query_count(
            cap, e)
        assert tcm.rename_gather_bytes(cap, e) == jcm.rename_gather_bytes(
            cap, e)
    for s in ("fused", "unfused"):
        assert tcm.reindex_dispatch_count(s) == jcm.reindex_dispatch_count(s)
    for t0, j0 in LIBRARY:
        for t, j in [(t0, j0)] + [
                (dataclasses.replace(t0, sort_strategy=s),
                 dataclasses.replace(j0, sort_strategy=s))
                for s in STRATEGIES]:
            assert tcm.sort_pass_count(t, tw) == jcm.sort_pass_count(j, jw)
            assert tcm.digit_pass_count(t, tw) == jcm.digit_pass_count(j, jw)
            for s in STRATEGIES:
                assert tcm._ordering_seconds(t, tw, tc, s) == \
                    jcm._ordering_seconds(j, jw, jc, s)
                assert tcm.relocation_bytes(t, tw, s) == \
                    jcm.relocation_bytes(j, jw, s)
                assert tcm.merge_round_count(t, tw, s) == \
                    jcm.merge_round_count(j, jw, s)
                assert tcm.sort_op_count(t, tw, s) == \
                    jcm.sort_op_count(j, jw, s)
            assert tcm.merge_round_count(t, tw) == jcm.merge_round_count(j, jw)
            assert tcm.sort_op_count(t, tw) == jcm.sort_op_count(j, jw)
            assert tcm.resolve_sort_strategy(t, tw, tc) == \
                jcm.resolve_sort_strategy(j, jw, jc)
            assert tcm.pointer_reindex_strategy(t, tw, tc) == \
                jcm.pointer_reindex_strategy(j, jw, jc)
            for q in (1, 375, n + 1, 2 * e):
                assert tcm.resolve_reindex_strategy(t, q, e, tc) == \
                    jcm.resolve_reindex_strategy(j, q, e, jc)
            assert tcm.reindex_sort_op_count(t, n, e, tc) == \
                jcm.reindex_sort_op_count(j, n, e, jc)
            assert tcm._reindex_seconds(t, tw, tc) == \
                jcm._reindex_seconds(j, jw, jc)
            assert tcm.ordering_cycles(t, tw) == jcm.ordering_cycles(j, jw)
            assert tcm.selecting_cycles(t, tw) == jcm.selecting_cycles(j, jw)
            assert tcm.reshaping_cycles(t, tw) == jcm.reshaping_cycles(j, jw)
            assert tcm.estimate_seconds(t, tw, tc) == \
                jcm.estimate_seconds(j, jw, jc)


@pytest.mark.parametrize("cal", sorted(CALS))
@pytest.mark.parametrize("g", GRID[:8], ids=lambda g: "n{}_e{}".format(*g))
def test_delta_terms_equal_the_reference(g, cal):
    tc, jc = _cals(cal)
    tw, jw = _w(tcm, g), _w(jcm, g)
    e = g[1]
    for d_cap in (1, 256, 4096, max(1, e // 8), e):
        assert dataclasses.asdict(tcm.delta_workload(tw, d_cap)) == \
            dataclasses.asdict(jcm.delta_workload(jw, d_cap))
        twd, jwd = tcm.delta_workload(tw, d_cap), jcm.delta_workload(jw,
                                                                     d_cap)
        for t0, j0 in LIBRARY[::4]:
            for t, j in ((t0, j0),
                         (dataclasses.replace(t0, sort_strategy="global_radix",
                                              reindex_strategy="unfused"),
                          dataclasses.replace(j0, sort_strategy="global_radix",
                                              reindex_strategy="unfused"))):
                assert tcm.resolve_delta_sort_strategy(t, twd, tc) == \
                    jcm.resolve_delta_sort_strategy(j, jwd, jc)
                assert tcm.delta_epilogue_strategy(t, tw, d_cap, tc) == \
                    jcm.delta_epilogue_strategy(j, jw, d_cap, jc)
                assert tcm.delta_merge_seconds(t, tw, d_cap, tc) == \
                    jcm.delta_merge_seconds(j, jw, d_cap, jc)
                assert tcm.delta_rebuild_seconds(t, tw, d_cap, tc) == \
                    jcm.delta_rebuild_seconds(j, jw, d_cap, jc)
                assert tcm.resolve_delta_mode(t, tw, d_cap, tc) == \
                    jcm.resolve_delta_mode(j, jw, d_cap, jc)
                assert math.isfinite(tcm.delta_merge_seconds(t, tw, d_cap,
                                                             tc))


@pytest.mark.parametrize("cal", sorted(CALS))
def test_best_and_chosen_config_equal_the_reference(cal):
    tc, jc = _cals(cal)
    for g in GRID:
        tw, jw = _w(tcm, g), _w(jcm, g)
        assert _fields(tcm.best_config(tw, None, tc)) == _fields(
            jcm.best_config(jw, None, jc))
        t, j = tcm.choose_config(tw, None, tc), jcm.choose_config(jw, None,
                                                                  jc)
        assert _fields(t) == _fields(j) and t.key == j.key
        half = [c for c, _ in LIBRARY[::2]]
        jhalf = [c for _, c in LIBRARY[::2]]
        assert _fields(tcm.choose_config(tw, half, tc)) == _fields(
            jcm.choose_config(jw, jhalf, jc))


class _Coo:
    """The two fields DynPre.profile reads."""

    def __init__(self, n_nodes, n_edges):
        self.n_nodes, self.n_edges = n_nodes, n_edges


# the paper's Fig. 28a scenario: diverse graphs one after another
SEQUENCE = [(4096, 1 << 14, 1024), (32_768, 1 << 20, 1024),
            (232_965, 114_615_892, 1024), (4096, 1 << 14, 1024),
            (232_965, 114_615_892, 16), (100, 700, 16),
            (232_965, 114_615_892, 1024)]


@pytest.mark.parametrize("cal", sorted(CALS))
def test_decide_and_dynpre_equal_the_reference_over_diverse_graphs(cal):
    tc, jc = _cals(cal)
    fan = (25, 10)
    tdyn, jdyn = trc.DynPre(fan, cal=tc), jrc.DynPre(fan, cal=jc)
    tcur = jcur = None
    for n, e, b in SEQUENCE:
        tw = tcm.Workload(n=n, e=e, l=2, k=25, b=b)
        jw = jcm.Workload(n=n, e=e, l=2, k=25, b=b)
        td = trc.decide(tw, tcur, tdyn.library, tc)
        jd = jrc.decide(jw, jcur, jdyn.library, jc)
        assert (td.reconfigure, _fields(td.config), td.predicted_gain_s,
                td.reconfig_cost_s) == (jd.reconfigure, _fields(jd.config),
                                        jd.predicted_gain_s,
                                        jd.reconfig_cost_s)
        tcur, jcur = td.config, jd.config
        te = tdyn.ensure(_Coo(n, torch.tensor(e)), b)
        je = jdyn.ensure(_Coo(n, np.int32(e)), b)
        assert _fields(te.cfg) == _fields(je.cfg) and te.fanouts == je.fanouts
        assert tdyn.n_reconfigs == jdyn.n_reconfigs


def test_statpre_and_autopre_equal_the_reference():
    for t, j in ((trc.statpre((25, 10)), jrc.statpre((25, 10))),
                 (trc.autopre((25, 10)), jrc.autopre((25, 10))),
                 (trc.statpre((3, 2), tcm.EngineConfig(w_upe=256)),
                  jrc.statpre((3, 2), jcm.EngineConfig(w_upe=256)))):
        assert _fields(t.cfg) == _fields(j.cfg) and t.fanouts == j.fanouts


def test_estimate_seconds_positive_and_monotone_for_every_library_config():
    cal = tcm.Calibration()
    for cfg, _ in LIBRARY:
        prev = None
        for e in (10**3, 10**5, 10**7, 10**9):
            t = tcm.estimate_seconds(cfg, tcm.Workload(n=10**4, e=e), cal)
            assert t["total"] > 0 and all(v >= 0 for v in t.values())
            if prev is not None:
                assert t["total"] >= prev
            prev = t["total"]
