"""repro_torch.analysis: the lint rules (positive, suppressed, clean, as
``tests/test_analysis.py`` holds the reference's), the port tree linting
clean, the census checker reporting planted violations (a scatter, a sort
census, a launch census, a collective ceiling), the smoke sweep through
the CLI with no violation, and the census side of the cost model and the
contract registry equal to the reference's over its grids."""
import collections
import dataclasses
import json
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import RULES, lint_source, lint_tree  # noqa: E402
from repro_torch.analysis import checker, contracts  # noqa: E402
from repro_torch.analysis.census import census  # noqa: E402
from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.core.costmodel import EngineConfig, Workload  # noqa: E402
from repro_torch.kernels import kernel_scope  # noqa: E402
from repro_torch.kernels import radix_sort as trs  # noqa: E402
from repro_torch.kernels import reindex_epilogue as tre  # noqa: E402
from repro_torch.kernels import set_count as tsc  # noqa: E402


def _rules(src: str, path: str = "core/ordering.py") -> list[str]:
    return [v.rule for v in lint_source(textwrap.dedent(src), path)]


# --------------------------------------------------------- lint: raw-jit
@pytest.mark.parametrize("src", [
    """
    import torch
    def capture(fn):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
    """,
    """
    from torch.cuda import CUDAGraph as G
    def capture():
        return G()
    """,
    """
    import ctypes
    def load(path):
        return ctypes.CDLL(path)
    """])
def test_raw_jit_flags_capture_and_library_outside_their_owner(src):
    rules = _rules(src, "serve/gnn.py")
    assert rules and set(rules) == {"raw-jit"}


def test_raw_jit_allows_the_owner_modules():
    cap = """
        import torch
        def capture(fn):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                fn()
    """
    lib = """
        import ctypes
        def load(path):
            return ctypes.CDLL(path)
    """
    assert _rules(cap, "serve/slots.py") == []
    assert _rules(lib, "kernels/_build.py") == []


def test_raw_jit_suppressed_with_reason():
    src = """
        import ctypes
        def probe(path):
            # repro: allow-raw-jit — a one-off probe of a scratch build
            return ctypes.CDLL(path)
    """
    assert _rules(src, "tools/probe.py") == []


def test_bare_suppression_is_itself_a_violation():
    src = """
        import ctypes
        def probe(path):
            return ctypes.CDLL(path)  # repro: allow-raw-jit
    """
    assert _rules(src, "tools/probe.py") == ["bare-suppression"]


def test_suppression_for_unknown_rule_is_flagged():
    src = "x = 1  # repro: allow-no-such-rule — because\n"
    assert _rules(src) == ["bare-suppression"]


# --------------------------------------------------- lint: scatter-write
@pytest.mark.parametrize("write", ["out.scatter_(0, idx, v)",
                                   "out.index_put_((idx,), v)",
                                   "out.index_add_(0, idx, v)",
                                   "out.index_copy_(0, idx, v)",
                                   "out[idx] = v"])
def test_scatter_write_flagged_in_spine_module_only(write):
    src = f"def f(out, idx, v):\n    {write}\n    return out\n"
    assert _rules(src, "core/ordering.py") == ["scatter-write"]
    assert _rules(src, "models/gnn.py") == []


def test_scatter_write_allows_slices_and_suppressed_with_reason():
    assert _rules("def f(out, v):\n    out[:, 0] = v\n    out[2] = v\n"
                  ) == []
    src = """
        def f(seen, v):
            # repro: allow-scatter-write — a host dict
            seen[v] = 1
    """
    assert _rules(src) == []


# ------------------------------------------------------ lint: traced-if
@pytest.mark.parametrize("sync", ["n = x.sum().item()", "xs = x.tolist()",
                                  "h = x.cpu()", "b = bool(x.any())",
                                  "if torch.any(x):\n        pass",
                                  "while x.all():\n        pass"])
def test_traced_if_flags_host_syncs_in_spine_and_captured_bodies(sync):
    src = f"import torch\ndef f(x):\n    {sync}\n"
    assert _rules(src, "core/pipeline.py") == ["traced-if"]
    assert _rules(src, "models/gnn.py") == []
    captured = (f"import torch\ndef build_step(n):\n    def step(x):\n"
                f"        {sync.replace(chr(10), chr(10) + '    ')}\n"
                f"    return step\n")
    assert _rules(captured, "serve/engine.py") == ["traced-if"]


def test_traced_if_allows_static_branches():
    src = """
        import torch
        def f(x, strategy, n):
            if strategy == "xla_sort" and n > 4:
                return torch.sort(x)
            while n > 1:
                n //= 2
            return x
    """
    assert _rules(src, "core/ordering.py") == []


# ---------------------------------------------- lint: host-numpy-in-jit
def test_host_numpy_flags_compute_but_not_metadata():
    bad = "import numpy as np\ndef f(x):\n    return np.asarray(x)\n"
    good = ("import numpy as np\ndef f(x):\n"
            "    return np.iinfo(np.int32).max\n")
    assert _rules(bad, "engine/shard.py") == ["host-numpy-in-jit"]
    assert _rules(good, "engine/shard.py") == []
    assert _rules(bad, "launch/train.py") == []


def test_mutable_default_flagged_and_none_clean():
    assert _rules("def f(x=[]):\n    return x\n", "serve/queue.py") == [
        "mutable-default"]
    assert _rules("def f(x=None):\n    return x\n", "serve/queue.py") == []


def test_rule_catalog_is_complete():
    for rule_id in ("raw-jit", "scatter-write", "traced-if",
                    "host-numpy-in-jit", "mutable-default",
                    "bare-suppression"):
        assert RULES[rule_id].history


def test_port_tree_is_lint_clean():
    violations = lint_tree()
    assert not violations, "\n".join(str(v) for v in violations)


# ------------------------------------------------- contract violations
def _toy_case(expect):
    return contracts.Case(contract="toy", label="toy", cfg=EngineConfig(),
                          workload=Workload(n=8, e=8),
                          strategy="chunked_merge", structure=("toy",),
                          expect=expect)


def _invariants(c, expect):
    return [v.invariant for v in checker.evaluate_census(c, _toy_case(
        expect))]


def test_checker_reports_a_planted_scatter_outside_the_scopes():
    """A scatter on the path is reported; the same op inside a kernel
    scope (a twin's) is the wrapper's and is not."""
    x = torch.zeros(16, dtype=torch.int32)
    idx = torch.arange(16).flip(0)
    expect = contracts.Expectation(forbidden_ops=contracts.SCATTER_WRITES)
    with census("cpu") as c:
        x.scatter_(0, idx, torch.arange(16, dtype=torch.int32))
    assert _invariants(c, expect) == ["no-aten::scatter"]
    with census("cpu") as c:
        with kernel_scope("chunk_sort", trs.chunk_sort):
            x.scatter_(0, idx, torch.arange(16, dtype=torch.int32))
        x[idx] = 1  # an index_put_
    assert _invariants(c, expect) == ["no-aten::index_put"]
    assert c.calls == {"chunk_sort": 1}
    assert c.scoped_ops["chunk_sort"]["aten::scatter_"] == 1


def test_census_names_an_accumulating_index_put():
    x = torch.zeros(4)
    with census("cpu") as c:
        x.index_put_((torch.tensor([1, 1]),), torch.ones(2), accumulate=True)
        x[torch.tensor([0])] = 2.0
    assert _invariants(c, contracts.serve_expectation(0)) == [
        "no-[accumulate]", "launch-census"]


def test_checker_reports_a_sort_census_mismatch():
    with census("cpu") as c:
        torch.sort(torch.arange(8).flip(0), stable=True)
    assert c.sort_count == 1
    assert _invariants(c, contracts.Expectation(sort_count=1)) == []
    assert _invariants(c, contracts.Expectation(sort_count=0)) == [
        "sort-census"]


def test_checker_reports_a_launch_census_mismatch():
    with census("cpu") as c:
        with kernel_scope("set_count_less", tsc.set_count_less, 2):
            pass
        with kernel_scope("rank_search", tre.rank_search, 0):  # no query
            pass
    ok = contracts.Expectation(launches=(("set_count_less", 2),))
    assert _invariants(c, ok) == []
    bad = contracts.Expectation(launches=(("rank_search", 1),))
    assert _invariants(c, bad) == ["launch-census"]
    assert c.launch_delta is None  # the CPU: no counter reading
    c.launch_delta = {"set_count_less": 1}  # the counters disagree
    assert _invariants(c, ok) == ["launch-counters"]


def test_checker_reports_declared_launches_the_counters_never_saw():
    """On the card a wrapper that declares a launch but takes its twin
    moves no counter: an empty reading against declared launches is a
    violation, where no reading (the CPU) is none."""
    with census("cpu") as c:
        with kernel_scope("chunk_sort", trs.chunk_sort, 1):
            pass
    ok = contracts.Expectation(launches=(("chunk_sort", 1),))
    assert _invariants(c, ok) == []
    c.launch_delta = {}  # a reading on the card: no counter moved
    assert _invariants(c, ok) == ["launch-counters"]


def test_a_scope_counts_on_the_counter_what_the_census_reads():
    """``scope.launched()`` adds the scope's declared launches to its
    wrapper's counter: the counter and the census read one number."""
    before = tsc.set_count_less.launches
    try:
        with census("cpu") as c:
            with kernel_scope("set_count_less", tsc.set_count_less,
                              2) as scope:
                scope.launched()
        assert tsc.set_count_less.launches - before == 2
        assert c.launches == {"set_count_less": 2}
    finally:
        tsc.set_count_less.launches = before


def test_checker_reports_a_collective_ceiling_breach():
    from repro_torch.dist.groups import Reduce
    t = torch.ones(64)
    with census("cpu") as c:
        Reduce().sum([t, t])
    assert c.collectives == [("all-reduce", 256)]
    assert _invariants(c, contracts.Expectation(
        collective_ceiling=8.0)) == ["collective-bytes"]
    assert _invariants(c, contracts.Expectation(
        collective_ceiling=1e9, required_ops=("all-reduce",))) == []


def test_census_counts_matmul_flops():
    a, b = torch.ones(3, 5), torch.ones(5, 7)
    with census("cpu") as c:
        a @ b
        torch.bmm(torch.ones(2, 3, 5), torch.ones(2, 5, 7))
    assert c.flops == 2 * 3 * 5 * 7 * 3


def test_plain_merges_and_partitions_are_gather_only():
    """The repaired spine relocations (``ordering.merge_sorted``,
    ``merge_sorted_k``, ``set_partition.partition_tiles``) issue no
    scatter-family write."""
    from repro_torch.core.ordering import merge_sorted_k
    from repro_torch.core.set_partition import partition_tiles
    runs = torch.sort(torch.randint(0, 50, (2, 3, 64), dtype=torch.int32),
                      dim=-1).values
    with census("cpu") as c:
        for k in (2, 3):
            merge_sorted_k(runs[:, :k], runs[:, :k] + 1)
        partition_tiles(runs.reshape(6, 64) % 16, 16)
    assert not [k for k in c.ops for p in contracts.SCATTER_WRITES
                if p in k], dict(c.ops)


# --------------------------------------------- the sweep and the CLI
def test_cli_smoke_sweep_is_violation_free(capsys):
    """``python -m repro_torch.analysis --grid smoke --device cpu``:
    the lint and every contract on both routings, exit 0."""
    from repro_torch.analysis.__main__ import main
    rc = main(["--grid", "smoke", "--device", "cpu", "--json"])
    report = json.loads(capsys.readouterr().out)
    assert report["lint"]["ok"], report["lint"]
    assert report["census"]["checks"] > 60, report["census"]
    assert rc == 0, report["census"]["violations"]


def test_cli_exits_nonzero_on_a_violation(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main
    (tmp_path / "core").mkdir()
    (tmp_path / "core" / "ordering.py").write_text(
        "def f(out, idx, v):\n    out.scatter_(0, idx, v)\n")
    assert main(["--lint", "--root", str(tmp_path)]) == 1
    assert "scatter-write" in capsys.readouterr().err


# ----------------------------- the census side of the model, vs the ref
jax = pytest.importorskip("jax")
from repro.analysis import contracts as jcontracts  # noqa: E402
from repro.core import costmodel as jcm  # noqa: E402


def _jcfg(cfg):
    return jcm.EngineConfig(**{f.name: getattr(cfg, f.name)
                               for f in dataclasses.fields(cfg)})


def _jw(w):
    return jcm.Workload(**dataclasses.asdict(w))


def test_delta_and_shard_arithmetic_equal_the_reference():
    """``delta_sort_op_count`` and ``shard_collective_bytes_budget`` over
    the reference's delta and shard grids, every library config."""
    configs = list(tcm.bitstream_library()) + list(contracts.EXTRA_CONFIGS)
    for base in configs:
        for strategy in tcm.SORT_STRATEGIES:
            cfg = dataclasses.replace(base, sort_strategy=strategy)
            for w, d_cap in contracts.DELTA_WORKLOADS:
                for s in (None, strategy):
                    assert tcm.delta_sort_op_count(cfg, w, d_cap, s) == \
                        jcm.delta_sort_op_count(_jcfg(cfg), _jw(w), d_cap, s)
            for w in contracts.CONVERT_WORKLOADS:
                for nd in (1, 2, 4, 8):
                    assert tcm.shard_collective_bytes_budget(cfg, w, nd) == \
                        jcm.shard_collective_bytes_budget(_jcfg(cfg), _jw(w),
                                                          nd)


def _keys(cases):
    return [(c.contract, c.label, c.structure, c.strategy, c.n_dev, c.d_cap,
             dataclasses.asdict(c.workload)) for c in cases]


def test_registry_case_keys_equal_the_reference():
    assert _keys(contracts.convert_cases("full")) == _keys(
        jcontracts.convert_cases("full"))
    assert _keys(contracts.convert_cases("smoke")) == _keys(
        jcontracts.convert_cases("smoke"))
    for grid in ("full", "smoke"):
        assert _keys(contracts.delta_cases(grid)) == _keys(
            jcontracts.delta_cases(grid))
        assert _keys(contracts.sample_cases(grid)) == _keys(
            jcontracts.sample_cases(grid))
        assert _keys(contracts.gnn_serve_cases(grid)) == _keys(
            jcontracts.gnn_serve_cases(grid))
        for nd in (2, 4, 8):
            assert _keys(contracts.shard_cases(nd, grid)) == _keys(
                jcontracts.shard_cases(nd, grid))
    assert contracts.registry_summary() == jcontracts.registry_summary()
    # and the sort census each case prices is the reference's
    for ours, ref in zip(contracts.convert_cases("full"),
                         jcontracts.convert_cases("full")):
        assert ours.expect.sort_count == ref.expect.sort_count


def test_launch_census_of_the_reddit_converts():
    """The card's route at Reddit's 2^27 COO: SLICE_CFG 6 + 6 digit passes
    and one rank search, MERGE_CFG 2 chunk sorts, 2 fused merges, 22 rungs
    and one set count (two launches); the CPU route runs the reference's
    10 passes of 4 bits a sort."""
    w = Workload(n=232_965, e=114_615_892)
    assert tcm.convert_launch_count(tcm.SLICE_CFG, w) == {
        "digit_hist": 6, "digit_scatter": 6, "rank_search": 1}
    assert tcm.convert_launch_count(tcm.MERGE_CFG, w) == {
        "chunk_sort": 2, "fused_merge": 2, "merge_rung": 22,
        "set_count_less": 2}
    assert tcm.convert_launch_count(tcm.SLICE_CFG, w, device="cpu")[
        "digit_hist"] == 2 * 5
    assert tcm.convert_launch_count(EngineConfig(), w) == {}
    # a chunk wider than one CTA holds: sub-chunks and one rung
    wide = dataclasses.replace(tcm.MERGE_CFG, w_upe=65536)
    got = tcm.convert_launch_count(wide, w)
    assert got["chunk_sort"] == 2 and got["merge_rung"] == 2 * (1 + 11)


@pytest.mark.parametrize("device", ("cuda", "cpu"))
def test_model_self_consistency_over_the_library(device):
    counts = collections.Counter()
    for base in list(tcm.bitstream_library())[::7] + list(
            contracts.EXTRA_CONFIGS):
        for w in contracts.CONVERT_WORKLOADS:
            for strategy in tcm.SORT_STRATEGIES:
                err = contracts.model_self_consistency(base, w, strategy,
                                                       device)
                assert err is None, (base.key, w, strategy, err)
                counts[strategy] += 1
    assert min(counts.values()) > 10
