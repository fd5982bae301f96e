"""Declarative contracts over the port's hot paths (port of
``repro/analysis/contracts.py``).

Every hot path — ``pipeline.convert`` per sort strategy,
``sample_subgraph``, the rank-by-rank sharded convert, ``apply_delta``'s
merge path and the two serve steps — registers invariants over one call's
census (``analysis/census.py``), where the reference registers them over
its compiled HLO:

* **forbidden / required ops** — aten ops issued outside any kernel
  scope. On the convert, sample, delta and shard spines no scatter-family
  write at all (``SCATTER_WRITES``: the reference's gather-only
  relocation rule) and, on the radix strategies, no native sort. In the
  LM serve step the cache insert's plain index writes are the
  counterpart of ``dynamic-update-slice`` and allowed; the accumulating
  ones (``ACCUMULATING_WRITES``, float atomics on the card, which would
  break batched == sequential) and sorts are not.
* **launch census** (``launches``, in place of the reference's
  ``while_count``) — the kernel launches a path makes under
  ``use_pallas``, by wrapper name, computed FROM the cost model
  (``costmodel.convert_launch_count``, ``delta_launch_count``,
  ``shard_convert_launch_count``), which derives them from the functions
  the path dispatches with: the card's digit schedule, the chunk sort's
  sub-chunks, the merge ladder's split between the fused merge and the
  rungs. Model and program must agree for every config of
  ``bitstream_library()`` across the workload grid.
* **sort census** (``sort_count``) — native sorts outside the scopes,
  exactly the model's ``sort_op_count`` arithmetic.
* **collective-byte ceilings** — the sharded convert's collective operand
  bytes under ``costmodel.shard_collective_bytes_budget``.
* **cache guards** (in the checker) — re-dispatching
  ``engine.service.convert_jit`` / ``apply_delta_jit`` with a seen
  (cfg, bucket) adds no table entry; a served step is built once.

The registry is data and model arithmetic; ``checker.py`` runs one
representative call a structure group under a census and evaluates every
member case against it. ``device`` names the route the launch census
follows (on the CPU the twins run the reference's digit passes).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.costmodel import (EngineConfig, SORT_STRATEGIES,
                                        Workload, _merge_fan_ins,
                                        bitstream_library,
                                        convert_launch_count,
                                        delta_epilogue_strategy,
                                        delta_launch_count,
                                        delta_sort_op_count, delta_workload,
                                        digit_pass_count, merge_round_count,
                                        pointer_reindex_strategy,
                                        reindex_dispatch_count,
                                        reindex_sort_op_count,
                                        resolve_delta_mode,
                                        resolve_delta_sort_strategy,
                                        sample_edge_capacity,
                                        sample_vid_capacity,
                                        shard_collective_bytes_budget,
                                        shard_convert_launch_count,
                                        sort_launch_count, sort_op_count,
                                        sort_pass_count)
from repro_torch.core.graph import next_pow2
from repro_torch.core.ordering import supports_packed_keys

# scatter-family writes (substrings of aten op names): forbidden on the
# convert, sample, delta and shard spines
SCATTER_WRITES = ("aten::scatter", "aten::index_put", "aten::_index_put_impl",
                  "aten::index_add", "aten::index_copy", "aten::put")
# the float-atomic kind, forbidden in the LM serve step; an index_put_
# that accumulates is named ``...[accumulate]`` by the census
ACCUMULATING_WRITES = ("aten::index_add", "aten::scatter_add",
                       "aten::scatter_reduce", "[accumulate]")
SORTS = ("aten::sort", "aten::argsort", "aten::msort")


@dataclasses.dataclass(frozen=True)
class Expectation:
    """What the call's census must show. ``None`` = not asserted."""

    forbidden_ops: tuple[str, ...] = ()  # op-name substrings, off scope
    required_ops: tuple[str, ...] = ()  # ops or collective kinds
    launches: tuple | None = None  # sorted (wrapper, launches) pairs
    sort_count: int | None = None  # native sorts outside the scopes
    collective_ceiling: float | None = None  # collective operand bytes

    @property
    def launch_dict(self) -> dict[str, int] | None:
        return None if self.launches is None else dict(self.launches)


def _launches(d: dict[str, int]) -> tuple:
    return tuple(sorted(d.items()))


@dataclasses.dataclass(frozen=True)
class Case:
    """One (config, workload) point of one contract; ``structure`` is the
    reference's dedupe key (cases with equal keys run one program, so the
    checker runs one representative and evaluates every member)."""

    contract: str
    label: str
    cfg: EngineConfig
    workload: Workload
    strategy: str
    structure: tuple
    expect: Expectation
    n_dev: int = 1
    d_cap: int = 0  # delta bucket (delta_update contract only)


@dataclasses.dataclass(frozen=True)
class Violation:
    contract: str
    case: str
    invariant: str
    message: str

    def __str__(self) -> str:
        return (f"[{self.contract}] {self.case}: {self.invariant} — "
                f"{self.message}")


# Workload grid: three edge scales in the packed-key regime plus one node
# scale past the packed-key bound (2·bits(70000) > 31 → two passes).
CONVERT_WORKLOADS = (
    Workload(n=200, e=512),
    Workload(n=200, e=2048),
    Workload(n=200, e=8192),
    Workload(n=70000, e=2048),
)
SMOKE_WORKLOADS = (Workload(n=200, e=2048),)

# Off-library configs: a k-ary ladder, the reference's lax.map lane
# batching (0 < n_upe < n_chunks), a wide digit and the forced two-pass
# key scheme.
EXTRA_CONFIGS = (
    EngineConfig(w_upe=256, n_upe=8, merge_fan_in=4),
    EngineConfig(w_upe=256, n_upe=2),
    EngineConfig(w_upe=512, n_upe=8, radix_bits=8),
    EngineConfig(w_upe=256, n_upe=8, sort_mode="two_pass"),
)
SMOKE_CONFIGS = (
    EngineConfig(),
    EngineConfig(w_upe=256, n_upe=2),
    EngineConfig(w_upe=512, n_upe=8, merge_fan_in=4),
)


def _routed(cfg: EngineConfig, strategy: str, use_pallas: bool,
            **kw) -> EngineConfig:
    return dataclasses.replace(cfg, sort_strategy=strategy,
                               use_pallas=use_pallas, **kw)


def convert_structure(cfg: EngineConfig, w: Workload,
                      strategy: str) -> tuple:
    """The reference's program-identity key of ``pipeline.convert``:
    shapes (n, pow2 capacity), pass count, strategy and, on the radix
    paths, chunk, digit width, fan-in and the lane batching. SCR geometry
    never changes the program."""
    e = next_pow2(w.e)
    passes = sort_pass_count(cfg, w)
    if strategy == "xla_sort":
        extra: tuple = ()
    else:
        chunk = min(cfg.w_upe, e)
        n_chunks = e // chunk
        lax_map = 0 < cfg.n_upe < n_chunks
        extra = (chunk, cfg.radix_bits, cfg.merge_fan_in,
                 cfg.n_upe if lax_map else 0)
    return (strategy, passes, w.n, e) + extra


def convert_expectation(cfg: EngineConfig, w: Workload, strategy: str,
                        device: str = "cuda") -> Expectation:
    """Scatter-free always, native sorts only on xla_sort (exactly
    ``sort_op_count``), launches exactly ``convert_launch_count``."""
    forbidden = SCATTER_WRITES
    if strategy != "xla_sort":
        forbidden = SCATTER_WRITES + SORTS
    return Expectation(
        forbidden_ops=forbidden,
        launches=_launches(convert_launch_count(cfg, w, strategy, device)),
        sort_count=sort_op_count(cfg, w, strategy))


def convert_cases(grid: str = "full", use_pallas: bool = False,
                  device: str = "cuda") -> list[Case]:
    """Every library config × the workload grid × every sort strategy
    (forced), routed by ``use_pallas``."""
    if grid == "smoke":
        workloads, configs = SMOKE_WORKLOADS, SMOKE_CONFIGS
    else:
        workloads = CONVERT_WORKLOADS
        configs = tuple(bitstream_library()) + EXTRA_CONFIGS
    cases = []
    for w in workloads:
        for base in configs:
            for strategy in SORT_STRATEGIES:
                cfg = _routed(base, strategy, use_pallas)
                cases.append(Case(
                    contract="convert",
                    label=f"{cfg.key} n={w.n} e={w.e}",
                    cfg=cfg, workload=w, strategy=strategy,
                    structure=convert_structure(cfg, w, strategy),
                    expect=convert_expectation(cfg, w, strategy, device)))
    return cases


SAMPLE_FANOUTS = (2, 2)
SAMPLE_BATCH = 8


def _sample_case_workload() -> Workload:
    """The graph-level workload of the sample cases: (l, k, b) are the
    sampling knobs the capacity helpers read."""
    return Workload(n=200, e=2048, l=len(SAMPLE_FANOUTS),
                    k=max(SAMPLE_FANOUTS), b=SAMPLE_BATCH)


def _sample_sub_workload() -> Workload:
    """The padded subgraph ``sample_subgraph`` re-converts."""
    w = _sample_case_workload()
    return Workload(n=sample_vid_capacity(w), e=sample_edge_capacity(w))


def _lane_sorts(cfg: EngineConfig, w: Workload, sub: Workload,
                strategy: str) -> int:
    """One sample's native sorts: the shared reindex sort's and the
    sub-convert's."""
    return (reindex_sort_op_count(cfg, w.n, next_pow2(sub.n))
            + sort_op_count(cfg, sub, strategy))


def sample_expectation(cfg: EngineConfig, strategy: str) -> Expectation:
    """``sample_subgraph``: scatter-free relocation and the exact native
    sort census (the reindex sort plus the sub-convert's)."""
    return Expectation(
        forbidden_ops=SCATTER_WRITES,
        sort_count=_lane_sorts(cfg, _sample_case_workload(),
                               _sample_sub_workload(), strategy))


def sample_cases(grid: str = "full", use_pallas: bool = False,
                 device: str = "cuda") -> list[Case]:
    w = _sample_case_workload()
    cases = []
    for strategy in SORT_STRATEGIES:
        cfg = _routed(EngineConfig(w_upe=256, n_upe=8), strategy, use_pallas)
        cases.append(Case(
            contract="sample",
            label=f"{cfg.key} fanouts={SAMPLE_FANOUTS} b={SAMPLE_BATCH}",
            cfg=cfg, workload=w, strategy=strategy,
            structure=("sample", strategy),
            expect=sample_expectation(cfg, strategy)))
    return cases


GNN_SERVE_FANOUTS = (3, 2)  # = configs.graphsage_reddit smoke sample_sizes
GNN_SERVE_SEED_CAP = 8
GNN_SERVE_SLOTS = 2


def _gnn_serve_workload() -> Workload:
    """One slot lane of the GNN serve step, as a workload."""
    return Workload(n=200, e=2048, l=len(GNN_SERVE_FANOUTS),
                    k=max(GNN_SERVE_FANOUTS), b=GNN_SERVE_SEED_CAP)


def _gnn_serve_sub_workload() -> Workload:
    w = _gnn_serve_workload()
    return Workload(n=sample_vid_capacity(w), e=sample_edge_capacity(w))


def gnn_serve_expectation(cfg: EngineConfig, strategy: str) -> Expectation:
    """The ``GnnServeEngine`` step: every slot a lane, run one after the
    other (the reference batches them under vmap, which issues one lane's
    ops), so its sort census is ``GNN_SERVE_SLOTS`` lanes' of the sample
    arithmetic; scatter-free, the forward on the pointer sums."""
    return Expectation(
        forbidden_ops=SCATTER_WRITES,
        sort_count=GNN_SERVE_SLOTS * _lane_sorts(
            cfg, _gnn_serve_workload(), _gnn_serve_sub_workload(),
            strategy))


def gnn_serve_cases(grid: str = "full", use_pallas: bool = False,
                    device: str = "cuda") -> list[Case]:
    w = _gnn_serve_workload()
    cases = []
    for strategy in SORT_STRATEGIES:
        cfg = _routed(EngineConfig(w_upe=256, n_upe=8), strategy, use_pallas)
        cases.append(Case(
            contract="gnn_serve",
            label=(f"{cfg.key} fanouts={GNN_SERVE_FANOUTS} "
                   f"cap={GNN_SERVE_SEED_CAP}"),
            cfg=cfg, workload=w, strategy=strategy,
            structure=("gnn_serve", strategy),
            expect=gnn_serve_expectation(cfg, strategy)))
    return cases


# Delta grid: the convert smoke graph at two delta buckets, plus the
# pair-key regime (n=70000 defeats packing → 2 passes a delta sort).
DELTA_WORKLOADS = (
    (Workload(n=200, e=2048), 64),
    (Workload(n=200, e=2048), 256),
    (Workload(n=70000, e=2048), 64),
)
SMOKE_DELTA_WORKLOADS = ((Workload(n=200, e=2048), 64),)


def delta_structure(cfg: EngineConfig, w: Workload, d_cap: int,
                    strategy: str) -> tuple:
    """The reference's program-identity key of ``apply_delta``'s merge
    path: shapes, the delta sorts' pass count and knobs, and the rank
    passes' fused/unfused lowering."""
    wd = delta_workload(w, d_cap)
    fused = delta_epilogue_strategy(cfg, w, d_cap) == "fused"
    if strategy == "xla_sort":
        extra: tuple = ()
    else:
        chunk = min(cfg.w_upe, wd.e)
        extra = (chunk, cfg.radix_bits, cfg.merge_fan_in)
    return (("delta", strategy, sort_pass_count(cfg, wd), w.n,
             next_pow2(w.e), wd.e, fused) + extra)


def delta_expectation(cfg: EngineConfig, w: Workload, d_cap: int,
                      strategy: str, device: str = "cuda") -> Expectation:
    """Scatter-free like the whole spine; launches exactly
    ``delta_launch_count``; native sorts ``delta_sort_op_count``, less the
    event-zip rung under ``use_pallas`` (the port zips on the merge-rung
    kernel there, the reference on a native sort)."""
    return Expectation(
        forbidden_ops=SCATTER_WRITES,
        launches=_launches(delta_launch_count(cfg, w, d_cap, strategy,
                                              device)),
        sort_count=(delta_sort_op_count(cfg, w, d_cap, strategy)
                    - int(cfg.use_pallas)))


def delta_cases(grid: str = "full", use_pallas: bool = False,
                device: str = "cuda") -> list[Case]:
    """Every sort strategy forced × both rank lowerings (the full grid)
    over the delta workloads."""
    points = SMOKE_DELTA_WORKLOADS if grid == "smoke" else DELTA_WORKLOADS
    reindex = ("auto",) if grid == "smoke" else ("auto", "unfused")
    cases = []
    for w, d_cap in points:
        for rs in reindex:
            for strategy in SORT_STRATEGIES:
                cfg = _routed(EngineConfig(), strategy, use_pallas,
                              reindex_strategy=rs)
                cases.append(Case(
                    contract="delta_update",
                    label=f"{cfg.key} n={w.n} e={w.e} d={d_cap}",
                    cfg=cfg, workload=w, strategy=strategy,
                    structure=delta_structure(cfg, w, d_cap, strategy),
                    expect=delta_expectation(cfg, w, d_cap, strategy,
                                             device),
                    d_cap=d_cap))
    return cases


def shard_expectation(cfg: EngineConfig, w: Workload, n_dev: int,
                      strategy: str, device: str = "cuda") -> Expectation:
    """The sharded convert run rank by rank: scatter-free, launches
    ``shard_convert_launch_count``, an all-gather, collective bytes under
    ``shard_collective_bytes_budget``. Native sorts are allowed (xla_sort
    sorts each span)."""
    return Expectation(
        forbidden_ops=SCATTER_WRITES,
        required_ops=("all-gather",),
        launches=_launches(shard_convert_launch_count(cfg, w, n_dev,
                                                      strategy, device)),
        collective_ceiling=shard_collective_bytes_budget(cfg, w, n_dev))


def shard_cases(n_dev: int, grid: str = "full", use_pallas: bool = False,
                device: str = "cuda") -> list[Case]:
    w = Workload(n=200, e=2048)
    cases = []
    for strategy in SORT_STRATEGIES:
        cfg = _routed(EngineConfig(w_upe=256, n_upe=8), strategy, use_pallas)
        cases.append(Case(
            contract="shard",
            label=f"{cfg.key} e={w.e} nd={n_dev}",
            cfg=cfg, workload=w, strategy=strategy,
            structure=("shard", strategy, n_dev),
            expect=shard_expectation(cfg, w, n_dev, strategy, device),
            n_dev=n_dev))
    return cases


def serve_expectation(n_layers: int) -> Expectation:
    """The LM decode step: no accumulating write and no sort (the cache
    insert's plain index writes are allowed); two decode-kernel launches
    a layer."""
    return Expectation(
        forbidden_ops=ACCUMULATING_WRITES + SORTS,
        launches=_launches({"decode_attention": 2 * n_layers}))


def two_pass_boundary_nodes() -> int:
    """First workload-grid node count past the packed-key bound (why
    CONVERT_WORKLOADS carries n=70000)."""
    assert not supports_packed_keys(70000)
    return 70000


def registry_summary() -> dict:
    """Contract registry overview (the ``--json`` report header)."""
    convert = convert_cases("full")
    return {
        "contracts": ["convert", "sample", "shard", "serve", "gnn_serve",
                      "delta_update"],
        "convert_cases": len(convert),
        "convert_groups": len({c.structure for c in convert}),
        "delta_cases": len(delta_cases("full")),
        "workloads": [dataclasses.asdict(w) for w in CONVERT_WORKLOADS],
        "strategies": list(SORT_STRATEGIES),
        "library_size": len(bitstream_library()),
    }


def model_self_consistency(cfg: EngineConfig, w: Workload, strategy: str,
                           device: str = "cuda") -> str | None:
    """Tie the launch census to the model's own terms: the ladder the
    census launches has exactly ``merge_round_count``'s rounds, the
    global_radix digit passes are the route's schedule, the pointer term
    is the resolved pointer strategy's, and the delta census decomposes
    into its two streams' sorts, the zip and the rank passes. Returns an
    error string or None."""
    from repro_torch.core.delta import DELTA_RANK_PASSES
    from repro_torch.kernels.radix_sort import global_radix_schedule
    from repro_torch.core.ordering import _bits_for
    rounds = merge_round_count(cfg, w, strategy)
    want = (0 if strategy in ("global_radix", "xla_sort")
            else sort_pass_count(cfg, w) * len(_merge_fan_ins(cfg, w)))
    if rounds != want:
        return (f"merge_round_count={rounds} but the census ladder has "
                f"{want} rounds")
    routed = dataclasses.replace(cfg, use_pallas=True)
    conv = convert_launch_count(routed, w, strategy, device)
    sort = sort_launch_count(routed, w, strategy, device)
    ptr = {k: n - sort.get(k, 0) for k, n in conv.items()
           if n != sort.get(k, 0)}
    if ptr != ({"rank_search": 1}
               if pointer_reindex_strategy(cfg, w) == "fused"
               else {"set_count_less": 2}):
        return (f"convert pointer launches {ptr} inconsistent with the "
                f"resolved pointer strategy "
                f"{pointer_reindex_strategy(cfg, w)!r}")
    if strategy == "global_radix":
        bits = _bits_for(w.n)
        key_bits = 2 * bits if sort_pass_count(cfg, w) == 1 else bits
        passes = (sort_pass_count(cfg, w)
                  * len(global_radix_schedule(key_bits, cfg.radix_bits))
                  if device == "cuda" else digit_pass_count(cfg, w))
        if sort.get("digit_hist") != passes:
            return (f"{sort.get('digit_hist')} digit passes launched, the "
                    f"route's schedule runs {passes}")
    if reindex_dispatch_count("fused") != 0:
        return "fused reindex epilogue must price zero loop dispatches"
    # delta ties, at a canonical 64-edge bucket
    wd = delta_workload(w, 64)
    ds = resolve_delta_sort_strategy(cfg, wd)
    fused = delta_epilogue_strategy(cfg, w, 64) == "fused"
    dl = delta_launch_count(routed, w, 64, ds, device)
    if dl.get("rank_search") != 2 + (DELTA_RANK_PASSES if fused else 0):
        return "delta rank launches inconsistent with its epilogue strategy"
    if delta_sort_op_count(cfg, w, 64) != 2 * sort_op_count(cfg, wd, ds) + 1:
        return ("delta sort census must be 2·stream passes + the event-zip "
                "rung")
    if next_pow2(w.e) >= 2048 and resolve_delta_mode(cfg, w, 1) != "merge":
        return "a single-edge delta must never price above a full rebuild"
    return None
