"""Contract checker (port of ``repro/analysis/checker.py``): run each
registered hot path once a structure group under a census and evaluate
every member case against it.

The flow per contract:

1. ``contracts.*_cases`` enumerates (config, workload, strategy) cases,
   each with a model-derived ``Expectation`` and a ``structure`` key.
2. Cases are grouped by key; ONE representative call runs under
   ``census.census`` and every member is evaluated against that census (a
   group whose members' expectations disagree cannot pass: the group is
   also a consistency check of the model), with its
   ``model_self_consistency`` tie.
3. Cache guards stand in for the reference's recompile guards: a second
   ``engine.service.convert_jit`` / ``apply_delta_jit`` with a seen
   (cfg, bucket) adds no table entry, and a served stream builds one step
   program. On the card, a served step is captured once and its
   ``captured_launches()`` equals one eager step's census.

On the card every census also holds the launch counters' change against
the launches its kernel scopes declared. The sharded contract runs the
ranks in this process (``engine.shard.shard_convert_ranks``), so it needs
no process group.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.analysis import contracts
from repro_torch.analysis.census import Census, census
from repro_torch.analysis.contracts import Case, Violation
from repro_torch.core import pipeline, prng
from repro_torch.core.graph import COO, random_coo


# ---------------------------------------------------------------------------
# census evaluation
# ---------------------------------------------------------------------------
def evaluate_census(c: Census, case: Case) -> list[Violation]:
    """Evaluate one case's expectation against a call's census."""
    exp = case.expect
    out: list[Violation] = []

    def v(invariant: str, message: str) -> None:
        out.append(Violation(case.contract, case.label, invariant, message))

    for pat in exp.forbidden_ops:
        hits = c.hits(pat)
        if hits:
            v(f"no-{pat}", f"forbidden ops outside the kernel scopes: "
                           f"{hits}")
    kinds = {k for k, _ in c.collectives}
    for pat in exp.required_ops:
        if not (c.hits(pat) or any(pat in k for k in kinds)):
            v(f"has-{pat}", "required op or collective missing")
    want = exp.launch_dict
    if want is not None and dict(c.launches) != want:
        v("launch-census", f"the model prices launches {want}, the call "
                           f"made {dict(c.launches)}")
    if c.launch_delta is not None and dict(c.launches) != c.launch_delta:
        v("launch-counters", f"the kernel scopes declared "
                             f"{dict(c.launches)}, the counters moved "
                             f"{c.launch_delta}")
    if exp.sort_count is not None and c.sort_count != exp.sort_count:
        v("sort-census", f"the model prices {exp.sort_count} native sorts, "
                         f"the call issued {c.sort_count}")
    if (exp.collective_ceiling is not None
            and c.collective_bytes > exp.collective_ceiling):
        v("collective-bytes", f"{c.collective_bytes:.0f} collective bytes "
                              f"exceed the {exp.collective_ceiling:.0f} "
                              f"budget")
    return out


# ---------------------------------------------------------------------------
# the calls (one a structure group)
# ---------------------------------------------------------------------------
def _make_coo(w, device) -> COO:
    rng = np.random.default_rng(0)
    n_edges = max(1, min(w.e - w.e // 4, w.e))
    dst, src = random_coo(rng, w.n, n_edges)
    return COO.from_arrays(dst, src, w.n, capacity=w.e, device=device)


def _run_convert(case: Case, device) -> Census:
    coo = _make_coo(case.workload, device)
    with census(device) as c:
        pipeline.convert(coo, case.cfg, device=device)
    return c


def _run_sample(case: Case, device) -> Census:
    csc = pipeline.convert(_make_coo(case.workload, device), case.cfg,
                           device=device)
    batch = torch.arange(contracts.SAMPLE_BATCH, dtype=torch.int32,
                         device=device)
    key = prng.PRNGKey(0)
    with census(device) as c:
        pipeline.sample_subgraph(csc, batch, contracts.SAMPLE_FANOUTS, key,
                                 case.cfg)
    return c


def _make_delta(w, d_cap: int, device):
    from repro_torch.core.delta import EdgeDelta
    rng = np.random.default_rng(3)
    k = max(1, d_cap // 2)
    return EdgeDelta.from_arrays(
        rng.integers(0, w.n, k), rng.integers(0, w.n, k),
        rng.integers(0, w.n, k), rng.integers(0, w.n, k),
        n_nodes=w.n, capacity=d_cap, device=device)


def _run_delta(case: Case, device) -> Census:
    csc = pipeline.convert(_make_coo(case.workload, device), case.cfg,
                           device=device)
    delta = _make_delta(case.workload, case.d_cap, device)
    with census(device) as c:
        pipeline.apply_delta(csc, delta, case.cfg, mode="merge")
    return c


def _run_shard(case: Case, device) -> Census:
    from repro_torch.engine.shard import shard_convert_ranks
    coo = _make_coo(case.workload, device)
    with census(device) as c:
        shard_convert_ranks(coo, case.cfg, world=case.n_dev)
    return c


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Report:
    """Structured result of one checker run."""

    checks: int = 0
    groups: int = 0
    violations: list[Violation] = dataclasses.field(default_factory=list)
    # one record a census taken: its case, wrapper calls, declared
    # launches and the launch counters' change
    runs: list[dict] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def record(self, case: Case, c: Census) -> None:
        self.runs.append(dict(contract=case.contract, label=case.label,
                              use_pallas=case.cfg.use_pallas,
                              calls=dict(c.calls), launches=dict(c.launches),
                              launch_delta=c.launch_delta))

    def merge(self, other: "Report") -> "Report":
        self.checks += other.checks
        self.groups += other.groups
        self.violations.extend(other.violations)
        self.runs.extend(other.runs)
        return self

    def to_json(self) -> dict:
        return {"checks": self.checks, "groups": self.groups,
                "ok": self.ok,
                "violations": [dataclasses.asdict(v)
                               for v in self.violations]}


def _check_grouped(cases: list[Case], run, device, progress=None) -> Report:
    """Group cases by structure, run one representative a group under a
    census, evaluate every member (and its model tie)."""
    groups: dict[tuple, list[Case]] = {}
    for c in cases:
        groups.setdefault(c.structure, []).append(c)
    rep = Report(groups=len(groups))
    route = torch.device(device).type
    for key, members in sorted(groups.items(), key=lambda kv: str(kv[0])):
        if progress:
            progress(f"running {members[0].contract} group {key} "
                     f"({len(members)} cases)")
        c = run(members[0], device)
        rep.record(members[0], c)
        for m in members:
            rep.checks += 1
            rep.violations.extend(evaluate_census(c, m))
            err = contracts.model_self_consistency(m.cfg, m.workload,
                                                   m.strategy, route)
            if err:
                rep.violations.append(Violation(
                    m.contract, m.label, "model-consistency", err))
    return rep


def _table_guard(cases: list[Case], contract: str, call, size,
                 progress=None) -> Report:
    """A second call with a seen (cfg, bucket) must add no entry to the
    service's dispatch table."""
    rep = Report()
    seen: set[tuple] = set()
    for case in cases:
        if case.structure in seen:
            continue
        seen.add(case.structure)
        rep.checks += 1
        if progress:
            progress(f"{contract} cache guard {case.label}")
        call(case)
        mid = size()
        call(case)
        after = size()
        if after != mid:
            rep.violations.append(Violation(
                contract, case.label, "cache-size",
                f"re-dispatching an already-seen (cfg, bucket) grew the "
                f"dispatch table {mid} → {after}"))
    return rep


# ---------------------------------------------------------------------------
# per-contract entry points
# ---------------------------------------------------------------------------
def _route(device) -> str:
    return torch.device(device).type


def check_convert(grid: str = "full", device="cuda", use_pallas=False,
                  progress=None) -> Report:
    from repro_torch.engine import service
    cases = contracts.convert_cases(grid, use_pallas, _route(device))
    rep = _check_grouped(cases, _run_convert, device, progress)
    return rep.merge(_table_guard(
        cases, "convert",
        lambda c: service.convert_jit(_make_coo(c.workload, device),
                                      cfg=c.cfg),
        service.convert_cache_size, progress))


def check_sample(grid: str = "full", device="cuda", use_pallas=False,
                 progress=None) -> Report:
    return _check_grouped(
        contracts.sample_cases(grid, use_pallas, _route(device)),
        _run_sample, device, progress)


def check_delta(grid: str = "full", device="cuda", use_pallas=False,
                progress=None) -> Report:
    from repro_torch.engine import service
    cases = contracts.delta_cases(grid, use_pallas, _route(device))
    rep = _check_grouped(cases, _run_delta, device, progress)

    def call(case):
        csc = pipeline.convert(_make_coo(case.workload, device), case.cfg,
                               device=device)
        service.apply_delta_jit(csc, _make_delta(case.workload, case.d_cap,
                                                 device), cfg=case.cfg)

    return rep.merge(_table_guard(cases, "delta_update", call,
                                  service.apply_delta_cache_size, progress))


SHARD_WORLDS = (2, 4)


def check_shard(grid: str = "full", device="cuda", use_pallas=False,
                progress=None) -> Report:
    """The sharded convert at each world of ``SHARD_WORLDS``, its ranks run
    in this process (``shard_convert_ranks``)."""
    rep = Report()
    for nd in SHARD_WORLDS:
        rep.merge(_check_grouped(
            contracts.shard_cases(nd, grid, use_pallas, _route(device)),
            _run_shard, device, progress))
    return rep


def _step_guard(eng, contract: str, label: str, submit) -> Report:
    """Serve two heterogeneous requests: one step program; on the card
    the captured step's launches equal one eager step's census."""
    submit()
    eng.close_submissions()
    eng.run()
    rep = Report(checks=1)
    size = eng.step_cache_size()
    if size != 1:
        rep.violations.append(Violation(
            contract, label, "cache-size",
            f"step_cache_size()={size} after heterogeneous traffic "
            f"(expected exactly 1 step program)"))
    if eng.device.type == "cuda":
        rep.checks += 1
        with census(eng.device) as c:
            eng.step_fn(eng.params, eng.state)
        if eng.captured_launches() != dict(c.launches):
            rep.violations.append(Violation(
                contract, label, "captured-launches",
                f"the captured step launches {eng.captured_launches()}, "
                f"an eager step {dict(c.launches)}"))
    return rep


def _serve_engine(device):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config("gemma2-9b", smoke=True)
    model = LM(cfg, seed=0, device=device)
    return cfg, ServeEngine(cfg, model, n_slots=2, max_len=32, prompt_cap=8,
                            device=device)


def check_serve(grid: str = "full", device="cuda", use_pallas=False,
                progress=None) -> Report:
    """The LM decode step's census (one eager step of the smoke engine),
    then two heterogeneous requests served on one step program."""
    if progress:
        progress("building the smoke serve engine")
    cfg, eng = _serve_engine(device)
    case = Case(contract="serve", label="gemma2-9b smoke step",
                cfg=contracts.EngineConfig(),
                workload=contracts.Workload(n=0, e=0), strategy="-",
                structure=("serve",),
                expect=contracts.serve_expectation(cfg.n_layers))
    with census(device) as c:
        eng.step_fn(eng.params, eng.state)
    rep = Report(groups=1, checks=1, violations=evaluate_census(c, case))
    rep.record(case, c)
    _, eng = _serve_engine(device)

    def submit():
        eng.submit([1, 2, 3], 3)
        eng.submit([4, 5], 2)

    return rep.merge(_step_guard(eng, "serve", case.label, submit))


def _gnn_serve_engine(cfg, device):
    """A smoke GnnServeEngine on the contract workload's graph."""
    from repro_torch.configs.graphsage_reddit import smoke_config
    from repro_torch.models.gnn import gnn_model
    from repro_torch.serve.gnn import GnnServeEngine
    w = contracts._gnn_serve_workload()
    csc = pipeline.convert(_make_coo(w, device), device=device)
    rng = np.random.default_rng(1)
    feats = torch.from_numpy(rng.normal(size=(w.n, 8)).astype(np.float32))
    model = gnn_model(smoke_config(), 8, n_classes=5,
                      generator=torch.Generator().manual_seed(0),
                      device=device)
    return GnnServeEngine(model, csc, feats,
                          fanouts=contracts.GNN_SERVE_FANOUTS,
                          n_slots=contracts.GNN_SERVE_SLOTS,
                          seed_cap=contracts.GNN_SERVE_SEED_CAP, cfg=cfg,
                          device=device)


def _run_gnn_serve(case: Case, device) -> Census:
    eng = _gnn_serve_engine(case.cfg, device)
    with census(device) as c:
        eng.step_fn(eng.params, eng.state)
    return c


def check_gnn_serve(grid: str = "full", device="cuda", use_pallas=False,
                    progress=None) -> Report:
    """The GNN serve step's census once a sort strategy, then two
    heterogeneous requests served on one step program."""
    cases = contracts.gnn_serve_cases(grid, use_pallas, _route(device))
    rep = _check_grouped(cases, _run_gnn_serve, device, progress)
    eng = _gnn_serve_engine(cases[0].cfg, device)

    def submit():
        eng.submit([1, 2, 3])
        eng.submit([4, 5])

    return rep.merge(_step_guard(eng, "gnn_serve", cases[0].label, submit))


CONTRACT_CHECKS = {
    "convert": check_convert,
    "sample": check_sample,
    "shard": check_shard,
    "serve": check_serve,
    "gnn_serve": check_gnn_serve,
    "delta_update": check_delta,
}


def check_all(grid: str = "full",
              parts: tuple[str, ...] = ("convert", "sample", "shard",
                                        "serve", "gnn_serve",
                                        "delta_update"),
              device="cuda", progress=None) -> Report:
    """Run every registered contract on ``device`` under both routings:
    the plain path (``use_pallas`` off) and the kernel wrappers (on: the
    twins on the CPU, the kernels on the card); ``grid="smoke"`` shrinks
    the sweeps."""
    rep = Report()
    for pl in (False, True):
        for part in parts:
            if part == "serve" and pl:
                continue  # the decode step takes no EngineConfig
            rep.merge(CONTRACT_CHECKS[part](grid, device, pl, progress))
    return rep
