"""Cost model (port of ``repro/core/costmodel.py``, paper §V-B, Table I).

The paper's closed forms, verbatim:

  Ordering:   m = log2(e / w_upe) - 1
              cycles = 2 * m * e / (n_upe * w_upe)
  Selecting:  s = b * k^(l+1) - 1
              cycles = s / n_upe
  Reshaping:  cycles = max(n / n_scr, e / w_scr)

``EngineConfig`` carries the reconfigurable knobs; ``resolve_sort_strategy``
and ``resolve_reindex_strategy`` turn its ``"auto"`` axes into the strategy
that runs, ``estimate_seconds`` prices a whole preprocess and
``choose_config`` picks a library entry (the engine service's decision),
and the delta terms price ``pipeline.apply_delta``'s merge against a
rebuild. Every term is the reference's own arithmetic, so it returns the
reference's floats bit for bit. The default ``Calibration`` is the
reference's CPU-measured one, so ``auto`` picks what the reference picks;
``chip_smoke.py``'s service phase fits one on the H100 but does not make
it the default.

The census side (``analysis/contracts.py``): the reference counts the
XLA ``while`` ops of each compiled path; here ``*_launch_count`` give the
kernel launches of a path under ``use_pallas``, by ``kernel_wrappers()``
name, derived from the functions the path dispatches with (the card's
digit schedule, the chunk sort's sub-chunks, the merge ladder's split).
``delta_sort_op_count`` and ``shard_collective_bytes_budget`` are the
reference's arithmetic.
"""
from __future__ import annotations

import dataclasses
import math

from .graph import next_pow2
from .ordering import (DEFAULT_CHUNK, _bits_for, merge_round_fan_ins,
                       supports_packed_keys)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The reconfigurable knobs (same fields and defaults as the reference).

    w_upe: radix chunk width / global-radix histogram tile
    n_upe: parallel sort lanes
    w_scr / n_scr: set-count element-block width / target-block height
    selection: node-wise selector, "floyd" | "keysort" | "reservoir"
    use_pallas: route the sort and rank epilogue through the hand-written
        kernels (``pipeline.kernel_fns``)
    radix_bits: digit width of every LSD radix pass
    sort_mode: "auto" | "packed" | "two_pass" edge-Ordering key scheme
    sort_strategy: "auto" | "chunked_merge" | "global_radix" | "xla_sort"
    merge_fan_in: runs merged per ladder rung on the chunked_merge path
    reindex_strategy: "auto" | "fused" | "unfused" rank-search epilogue
    """

    w_upe: int = DEFAULT_CHUNK
    n_upe: int = 8
    w_scr: int = 2048
    n_scr: int = 256
    selection: str = "floyd"
    use_pallas: bool = False
    radix_bits: int = 4
    sort_mode: str = "auto"
    sort_strategy: str = "auto"
    merge_fan_in: int = 2
    reindex_strategy: str = "auto"

    @property
    def key(self) -> str:
        mode = "" if self.sort_mode == "auto" else f"_{self.sort_mode}"
        strat = ("" if self.sort_strategy == "auto"
                 else f"_{self.sort_strategy}")
        fan = "" if self.merge_fan_in == 2 else f"_k{self.merge_fan_in}"
        ridx = ("" if self.reindex_strategy == "auto"
                else f"_{self.reindex_strategy}")
        return (f"u{self.n_upe}x{self.w_upe}_s{self.n_scr}x{self.w_scr}"
                f"_{self.selection}_r{self.radix_bits}{mode}{strat}{fan}"
                f"{ridx}{'_pl' if self.use_pallas else ''}")


# The two routed configurations the port runs on the card: global_radix
# sorts on the digit-pass kernels with the fused rank epilogue, and
# chunked_merge sorts on the chunk-sort and merge kernels with the
# unfused set-count pointer build
SLICE_CFG = EngineConfig(use_pallas=True, sort_strategy="global_radix",
                         reindex_strategy="fused")
MERGE_CFG = EngineConfig(use_pallas=True, sort_strategy="chunked_merge",
                         reindex_strategy="unfused")

# The resource budget analog of the paper's 70:30 UPE:SCR split: the
# product of width × lanes is bounded.
UPE_BUDGET = 4096 * 64
SCR_BUDGET = 2048 * 2048


def bitstream_library() -> list[EngineConfig]:
    """Pre-compiled configuration library: halve width / double count from
    one wide engine, for both the UPE and the SCR axis."""
    out = []
    w_upe, n_upe = 65536, 4
    upes = []
    while w_upe >= 256:
        upes.append((w_upe, n_upe))
        w_upe //= 2
        n_upe *= 2
    w_scr, n_scr = 65536, 64
    scrs = []
    while w_scr >= 256:
        scrs.append((w_scr, n_scr))
        w_scr //= 2
        n_scr *= 2
    for wu, nu in upes:
        for ws, ns in scrs:
            out.append(EngineConfig(w_upe=wu, n_upe=nu, w_scr=ws, n_scr=ns))
    return out


@dataclasses.dataclass
class Calibration:
    """Per-primitive throughput constants (the reference's CPU-measured
    defaults; see its docstring for what each one prices)."""

    upe_elems_per_s: float = 2.0e8
    scr_cmps_per_s: float = 5.0e9
    sel_nodes_per_s: float = 5.0e6
    reidx_elems_per_s: float = 1.0e8
    hbm_bytes_per_s: float = 1.0e8
    merge_step_weight: float = 1.0
    xla_cmp_per_s: float = 3.5e8
    sort_dispatch_s: float = 2.0e-4
    loop_trip_s: float = 1.0e-7
    unroll_bytes_per_s: float = 1.5e10


@dataclasses.dataclass(frozen=True)
class Workload:
    n: int  # nodes
    e: int  # edges
    l: int = 2  # GNN layers
    k: int = 10  # fanout
    b: int = 1024  # batch nodes


SORT_STRATEGIES = ("chunked_merge", "global_radix", "xla_sort")
REINDEX_STRATEGIES = ("fused", "unfused")
DELTA_MODES = ("merge", "rebuild")


def sort_pass_count(cfg: EngineConfig, w: Workload) -> int:
    """Global stable sorts per edge Ordering: 1 packed, 2 two-pass."""
    if cfg.sort_mode == "two_pass":
        return 2
    if cfg.sort_mode == "packed" or supports_packed_keys(w.n):
        return 1
    return 2


def digit_pass_count(cfg: EngineConfig, w: Workload) -> int:
    """Total radix digit passes per edge Ordering."""
    bits = _bits_for(w.n)
    key_bits = 2 * bits if sort_pass_count(cfg, w) == 1 else bits
    return sort_pass_count(cfg, w) * max(1, -(-key_bits // cfg.radix_bits))


def _merge_fan_ins(cfg: EngineConfig, w: Workload) -> list[int]:
    e = next_pow2(w.e)
    return merge_round_fan_ins(e, min(cfg.w_upe, e), cfg.merge_fan_in)


def merge_round_count(cfg: EngineConfig, w: Workload,
                      strategy: str | None = None) -> int:
    """Full-array merge rounds per edge Ordering: 0 for the radix and
    native strategies, ``sort_pass_count`` × the ladder's rungs for
    chunked_merge. ``strategy=None`` prices the cfg's resolved one."""
    strategy = strategy or resolve_sort_strategy(cfg, w)
    if strategy in ("global_radix", "xla_sort"):
        return 0
    return sort_pass_count(cfg, w) * len(_merge_fan_ins(cfg, w))


def sort_op_count(cfg: EngineConfig, w: Workload,
                  strategy: str | None = None) -> int:
    """Native sorts in the Ordering: one a global sort pass under
    xla_sort, none on the radix strategies."""
    strategy = strategy or resolve_sort_strategy(cfg, w)
    return sort_pass_count(cfg, w) if strategy == "xla_sort" else 0


def relocation_bytes(cfg: EngineConfig, w: Workload,
                     strategy: str | None = None) -> float:
    """Bytes the Ordering's full-array relocations stream."""
    strategy = strategy or resolve_sort_strategy(cfg, w)
    streams = 1 if sort_pass_count(cfg, w) == 1 else 2
    bytes_per_elem = 4 * streams * 2  # int32, read + write
    if strategy == "xla_sort":
        return 0.0
    if strategy == "global_radix":
        return float(digit_pass_count(cfg, w) * w.e * bytes_per_elem)
    passes = sort_pass_count(cfg, w)
    rounds = passes * len(_merge_fan_ins(cfg, w))
    return float((passes + rounds) * w.e * bytes_per_elem)


def _ordering_seconds(cfg: EngineConfig, w: Workload, cal: Calibration,
                      strategy: str) -> float:
    """Ordering latency under one concrete strategy."""
    passes = sort_pass_count(cfg, w)
    if strategy == "xla_sort":
        streams = 1 if passes == 1 else 2
        cmps = passes * streams**2 * w.e * math.log2(max(2.0, w.e))
        return passes * cal.sort_dispatch_s + cmps / cal.xla_cmp_per_s
    lanes = max(1, cfg.n_upe)
    digits = digit_pass_count(cfg, w)
    t = digits * w.e / (cal.upe_elems_per_s * lanes)
    if strategy == "chunked_merge":
        depth = math.log2(max(2.0, w.e))
        steps = passes * sum(k * k for k in _merge_fan_ins(cfg, w)) * depth
        t += (cal.merge_step_weight * steps * w.e
              / (cal.upe_elems_per_s * lanes))
    return t + relocation_bytes(cfg, w, strategy) / cal.hbm_bytes_per_s


def resolve_sort_strategy(cfg: EngineConfig, w: Workload,
                          cal: Calibration | None = None) -> str:
    """Resolve ``sort_strategy="auto"`` to the Table-I cheapest strategy."""
    if cfg.sort_strategy != "auto":
        return cfg.sort_strategy
    cal = cal or Calibration()
    return min(SORT_STRATEGIES,
               key=lambda s: _ordering_seconds(cfg, w, cal, s))


def reindex_round_count(capacity: int) -> int:
    """Rank-search rounds per pass over a ``capacity``-long sorted stream."""
    return max(1, int(capacity).bit_length())


def reindex_query_count(capacity: int, e: int) -> int:
    """Rank queries of one reindex build + edge rename."""
    return 2 * capacity + 2 * e


def resolve_reindex_strategy(cfg: EngineConfig, queries: int, stream: int,
                             cal: Calibration | None = None) -> str:
    """Resolve ``reindex_strategy="auto"`` for one rank-search pass of
    ``queries`` targets over a ``stream``-long sorted array."""
    if cfg.reindex_strategy != "auto":
        return cfg.reindex_strategy
    cal = cal or Calibration()
    rounds = reindex_round_count(stream)
    t_fused = rounds * queries * 4.0 / cal.unroll_bytes_per_s
    t_unfused = rounds * cal.loop_trip_s
    return "fused" if t_fused <= t_unfused else "unfused"


def pointer_reindex_strategy(cfg: EngineConfig, w: Workload,
                             cal: Calibration | None = None) -> str:
    """The convert pointer build's epilogue strategy (n+1 targets over the
    pow2 sorted-dst stream)."""
    return resolve_reindex_strategy(cfg, w.n + 1, next_pow2(w.e), cal)


# ---------------------------------------------------------------------------
# Delta-update terms. The merge path (core/delta.py) sorts two delta-sized
# streams (inserts and deletes) plus the one event-zip rung (a 2·d keys-only
# native sort), then splices positionally: three bounded row searches with
# delta-many queries, one full-width event rank and two (n+1)-query pointer
# corrections (the DELTA_RANK_PASSES whose lowering is the fused/unfused
# axis). ``resolve_delta_mode`` prices that against a full re-convert.
# ---------------------------------------------------------------------------

def delta_workload(w: Workload, d_cap: int) -> Workload:
    """The delta sorts' workload: the graph's VID space over the pow2
    delta bucket."""
    return Workload(n=w.n, e=next_pow2(d_cap), l=w.l, k=w.k, b=w.b)


def resolve_delta_sort_strategy(cfg: EngineConfig, wd: Workload,
                                cal: Calibration | None = None) -> str:
    """Sort strategy of the delta streams: each strategy's Ordering
    latency plus, for the radix ones, the materialising native sort the
    reference's splice gathers need, so the native sort wins at delta
    buckets; a pinned ``cfg.sort_strategy`` is honoured."""
    if cfg.sort_strategy != "auto":
        return cfg.sort_strategy
    cal = cal or Calibration()

    def price(s: str) -> float:
        t = _ordering_seconds(cfg, wd, cal, s)
        if s != "xla_sort":
            t += _ordering_seconds(cfg, wd, cal, "xla_sort")
        return t

    return min(SORT_STRATEGIES, key=price)


def delta_epilogue_strategy(cfg: EngineConfig, w: Workload,
                            d_cap: int | None = None,
                            cal: Calibration | None = None) -> str:
    """fused/unfused for the DELTA_RANK_PASSES full-width rank passes of one
    delta merge, resolved on the event rank plus the two pointer
    corrections (8 bytes a query a round fused, 24 and a loop trip
    unfused); a pinned ``cfg.reindex_strategy`` short-circuits."""
    if cfg.reindex_strategy != "auto":
        return cfg.reindex_strategy
    cal = cal or Calibration()
    wd = delta_workload(w, d_cap if d_cap is not None else 1)
    rounds = reindex_round_count(2 * wd.e)
    q = next_pow2(w.e) + 2 * (w.n + 1)
    t_fused = rounds * q * 8.0 / cal.unroll_bytes_per_s
    t_unfused = rounds * (q * 24.0 / cal.unroll_bytes_per_s
                          + cal.loop_trip_s)
    return "fused" if t_fused <= t_unfused else "unfused"


def delta_merge_seconds(cfg: EngineConfig, w: Workload, d_cap: int,
                        cal: Calibration | None = None) -> float:
    """Latency of one delta merge: two delta-bucket sorts and the event-zip
    rung (one shared dispatch), the bounded row searches, the full-width
    event rank and pointer corrections, the splice streams, and the
    resolved epilogue's own extra."""
    from .delta import DELTA_RANK_PASSES
    cal = cal or Calibration()
    wd = delta_workload(w, d_cap)
    strat = resolve_delta_sort_strategy(cfg, wd, cal)
    passes = sort_pass_count(cfg, wd)
    t_sort = (cal.sort_dispatch_s
              + 2 * max(0.0, _ordering_seconds(cfg, wd, cal, strat)
                        - passes * cal.sort_dispatch_s))
    zipn = 2 * wd.e
    t_zip = zipn * math.log2(max(2.0, zipn)) / cal.xla_cmp_per_s
    e_cap = next_pow2(w.e)
    log_e = reindex_round_count(e_cap)
    log_d = reindex_round_count(wd.e)
    log_2d = reindex_round_count(zipn)
    t_rows = 3 * min(log_e, 6) * wd.e * 4.0 / cal.hbm_bytes_per_s
    cmps = (e_cap * log_2d
            + 2 * (w.n + 1) * log_d
            + 3 * wd.e * log_d)
    t_rank = cmps / cal.scr_cmps_per_s
    t_mem = 6.0 * 4.0 * e_cap / cal.unroll_bytes_per_s
    rounds = log_2d + 2 * log_d
    q = e_cap + 2 * (w.n + 1)
    if delta_epilogue_strategy(cfg, w, d_cap, cal) == "fused":
        t_extra = rounds * q * 8.0 / cal.unroll_bytes_per_s / 3
    else:
        t_extra = (rounds * q * 24.0 / cal.unroll_bytes_per_s / 3
                   + DELTA_RANK_PASSES * rounds * cal.loop_trip_s / 3)
    return t_sort + t_zip + t_rows + t_rank + t_mem + t_extra


def delta_rebuild_seconds(cfg: EngineConfig, w: Workload, d_cap: int,
                          cal: Calibration | None = None) -> float:
    """Latency of the rebuild: sort the delete stream, match the
    tombstones, then re-convert the combined pow2 edge buffer."""
    cal = cal or Calibration()
    wd = delta_workload(w, d_cap)
    comb = Workload(n=w.n, e=next_pow2(w.e + wd.e), l=w.l, k=w.k, b=w.b)
    t = _ordering_seconds(cfg, wd, cal,
                          resolve_delta_sort_strategy(cfg, wd, cal))
    t /= 2  # one delete-stream sort, not both delta streams
    t += _ordering_seconds(cfg, comb, cal,
                           resolve_sort_strategy(cfg, comb, cal))
    log_d = reindex_round_count(wd.e)
    log_c = reindex_round_count(comb.e)
    cmps = (w.e * (reindex_round_count(w.n + 1) + 2 * log_d)
            + (w.n + 1) * log_c)
    t_rows = 2 * min(reindex_round_count(next_pow2(w.e)), 6) \
        * wd.e * 4.0 / cal.hbm_bytes_per_s
    t_mem = 6.0 * 4.0 * comb.e / cal.unroll_bytes_per_s
    return t + cmps / cal.scr_cmps_per_s + t_rows + t_mem


def resolve_delta_mode(cfg: EngineConfig, w: Workload, d_cap: int,
                       cal: Calibration | None = None) -> str:
    """``apply_delta(mode="auto")``: merge while it prices at or below a
    rebuild, else rebuild."""
    cal = cal or Calibration()
    return ("merge"
            if delta_merge_seconds(cfg, w, d_cap, cal)
            <= delta_rebuild_seconds(cfg, w, d_cap, cal)
            else "rebuild")


def sample_vid_capacity(w: Workload) -> int:
    """Collected-VID-list length of one ``sample_subgraph``: the seeds plus
    every frontier, b · Σ_{i≤l} k^i."""
    frontier = nodes = w.b
    for _ in range(w.l):
        frontier *= w.k
        nodes += frontier
    return nodes


def sample_edge_capacity(w: Workload) -> int:
    """Pow2 capacity of the sampled edge buffer, b · Σ_{1≤i≤l} k^i."""
    frontier, edges = w.b, 0
    for _ in range(w.l):
        frontier *= w.k
        edges += frontier
    return next_pow2(max(1, edges))


def reindex_dispatch_count(strategy: str) -> int:
    """Loop dispatches of the reindex epilogue: none fused, three unfused
    (first-occurrence rank, order compaction, the rename)."""
    return 0 if strategy == "fused" else 3


def rename_gather_bytes(capacity: int, e: int) -> float:
    """Bytes the rename lookups gather: one int32 pivot a query a round,
    plus the hit and table gathers."""
    return 4.0 * (reindex_round_count(capacity) + 2) * 2 * e


def reindex_sort_op_count(cfg: EngineConfig, vid_bound: int, capacity: int,
                          cal: Calibration | None = None) -> int:
    """Native sorts of the one shared reindex sort: 1 under xla_sort, 0 on
    the radix strategies."""
    strat = resolve_sort_strategy(
        cfg, Workload(n=vid_bound, e=capacity), cal)
    return 1 if strat == "xla_sort" else 0


def _reindex_seconds(cfg: EngineConfig, w: Workload,
                     cal: Calibration) -> float:
    """Reindexing latency: the shared VID-stream sort, the rank passes at
    SCR throughput, three element passes, the rename gathers and the
    resolved epilogue's own extra."""
    cap = next_pow2(sample_vid_capacity(w))
    e = sample_edge_capacity(w)
    wsub = Workload(n=w.n, e=cap)
    strat = resolve_sort_strategy(cfg, wsub, cal)
    t_sort = _ordering_seconds(cfg, wsub, cal, strat) / sort_pass_count(
        cfg, wsub)
    q = reindex_query_count(cap, e)
    rounds = reindex_round_count(cap)
    t_rank = rounds * q / cal.scr_cmps_per_s
    t_pass = 3 * cap / cal.reidx_elems_per_s  # head flags, prefix, order
    rstrat = resolve_reindex_strategy(cfg, q, cap, cal)
    if rstrat == "fused":
        t_extra = rounds * q * 4.0 / cal.unroll_bytes_per_s
    else:
        t_extra = reindex_dispatch_count(rstrat) * rounds * cal.loop_trip_s
    return (t_sort + t_rank + t_pass + t_extra
            + rename_gather_bytes(cap, e) / cal.unroll_bytes_per_s)


def ordering_cycles(cfg: EngineConfig, w: Workload) -> float:
    m = max(1.0, math.log2(max(2.0, w.e / cfg.w_upe)) - 1)
    return sort_pass_count(cfg, w) * m * w.e / (cfg.n_upe * cfg.w_upe)


def selecting_cycles(cfg: EngineConfig, w: Workload) -> float:
    s = w.b * (w.k ** (w.l + 1)) - 1
    return s / cfg.n_upe


def reshaping_cycles(cfg: EngineConfig, w: Workload) -> float:
    return max(w.n / cfg.n_scr, w.e / cfg.w_scr)


def estimate_seconds(cfg: EngineConfig, w: Workload,
                     cal: Calibration | None = None) -> dict[str, float]:
    """The cycle model in seconds, per stage and in total; an ``"auto"``
    sort strategy scores as its cheapest, which is what dispatch runs."""
    cal = cal or Calibration()
    if cfg.sort_strategy == "auto":
        t_order = min(_ordering_seconds(cfg, w, cal, s)
                      for s in SORT_STRATEGIES)
    else:
        t_order = _ordering_seconds(cfg, w, cal, cfg.sort_strategy)
    s = w.b * (w.k ** (w.l + 1)) - 1
    t_select = s / (cal.sel_nodes_per_s * cfg.n_upe)
    t_reshape = max(w.n / cfg.n_scr, w.e / cfg.w_scr) * (
        cfg.n_scr * cfg.w_scr / cal.scr_cmps_per_s)
    t_reindex = _reindex_seconds(cfg, w, cal)
    return {
        "ordering": t_order,
        "selecting": t_select,
        "reshaping": t_reshape,
        "reindexing": t_reindex,
        "total": t_order + t_select + t_reshape + t_reindex,
    }


def best_config(w: Workload, library: list[EngineConfig] | None = None,
                cal: Calibration | None = None) -> EngineConfig:
    """DynPre's decision: the library entry with the least total."""
    lib = library or bitstream_library()
    return min(lib, key=lambda c: estimate_seconds(c, w, cal)["total"])


def choose_config(w: Workload, library: list[EngineConfig] | None = None,
                  cal: Calibration | None = None) -> EngineConfig:
    """``best_config`` with its ``sort_strategy`` and its subgraph rename's
    ``reindex_strategy`` pinned, so the dispatched program is the one the
    model priced (the engine service's entry point)."""
    cal = cal or Calibration()
    best = best_config(w, library, cal)
    cap = next_pow2(sample_vid_capacity(w))
    q = reindex_query_count(cap, sample_edge_capacity(w))
    return dataclasses.replace(
        best, sort_strategy=resolve_sort_strategy(best, w, cal),
        reindex_strategy=resolve_reindex_strategy(best, q, cap, cal))


# ---------------------------------------------------------------------------
# The census side: kernel launches a path makes under ``use_pallas``, by
# ``kernels.kernel_wrappers()`` name. ``device`` is the route: on the card
# the global_radix sort runs the card's digit schedule
# (``kernels/radix_sort.py`` ``global_radix_schedule``), on the CPU the
# twins run the reference's passes of ``radix_bits``. Nothing here imports
# a kernel module at import time.
# ---------------------------------------------------------------------------

def _add(out: dict, name: str, n: int = 1) -> dict:
    if n:
        out[name] = out.get(name, 0) + n
    return out


def _merge_launches(out: dict, n: int, run: int, fan_in: int,
                    fused: bool = True) -> dict:
    """``ordering.merge_rounds`` from runs of ``run``: the fused merge
    takes the rungs whose super-block fits (``kernels/merge.py``
    ``_round_fan_ins``), one merge rung a rung after them."""
    from repro_torch.kernels.merge import DEFAULT_MAX_BLOCK, _round_fan_ins
    if fused and run < n:
        fans = _round_fan_ins(n, run, DEFAULT_MAX_BLOCK, fan_in)
        if fans:
            _add(out, "fused_merge")
            run *= math.prod(fans)
    return _add(out, "merge_rung", len(merge_round_fan_ins(n, run, fan_in)))


def _global_sort_launches(out: dict, cfg: EngineConfig, n: int,
                          key_bound: int, has_vals: bool, strategy: str,
                          device: str, chunk: int | None = None) -> dict:
    """One ``ordering.stable_sort_by_key`` of ``n`` elements under
    ``strategy`` with the config's kernels."""
    if not n or strategy == "xla_sort":
        return out
    key_bits = _bits_for(key_bound)
    if strategy == "global_radix":
        from repro_torch.kernels.radix_sort import global_radix_schedule
        passes = (len(global_radix_schedule(key_bits, cfg.radix_bits))
                  if device == "cuda"
                  else max(1, -(-key_bits // cfg.radix_bits)))
        _add(out, "digit_hist", passes)
        return _add(out, "digit_scatter", passes)
    from repro_torch.kernels.radix_sort import widest_sub_chunk
    chunk = min(cfg.w_upe if chunk is None else chunk, n)
    sub = widest_sub_chunk(chunk, has_vals)
    _add(out, "chunk_sort")
    _add(out, "merge_rung", int(sub < chunk))
    return _merge_launches(out, n, chunk, cfg.merge_fan_in)


def _ordering_sorts(cfg: EngineConfig, n_nodes: int):
    """(key bound, payload?) of each global sort of an edge Ordering: one
    packed keys-only sort, or two with a payload."""
    if sort_pass_count(cfg, Workload(n=n_nodes, e=1)) == 1:
        bits = _bits_for(n_nodes)
        return [((n_nodes << bits) | n_nodes, False)]
    return [(n_nodes, True)] * 2


def sort_launch_count(cfg: EngineConfig, w: Workload,
                      strategy: str | None = None,
                      device: str = "cuda") -> dict[str, int]:
    """Kernel launches of the edge Ordering (``ordering.edge_ordering``
    under ``pipeline.convert``'s routing), by wrapper name: none without
    ``use_pallas``; per global sort, ``digit_hist`` and ``digit_scatter``
    once a digit pass (global_radix), or one ``chunk_sort`` (with one
    ``merge_rung`` when the chunk is sorted as sub-chunks,
    ``widest_sub_chunk``), one ``fused_merge`` and the ladder's remaining
    rungs (chunked_merge); xla_sort launches nothing."""
    out: dict[str, int] = {}
    if not cfg.use_pallas:
        return out
    strategy = strategy or resolve_sort_strategy(cfg, w)
    e = next_pow2(w.e)
    for bound, has_vals in _ordering_sorts(cfg, w.n):
        _global_sort_launches(out, cfg, e, bound, has_vals, strategy, device)
    return out


def _pointer_launches(out: dict, cfg: EngineConfig, w: Workload,
                      blocks: int = 1) -> dict:
    """The pointer build, ``blocks`` target blocks: one ``rank_search``
    each when ``pointer_reindex_strategy`` resolves it fused, else one
    ``set_count_less`` each (a tile sort and a count: two launches)."""
    if pointer_reindex_strategy(cfg, w) == "fused":
        return _add(out, "rank_search", blocks)
    return _add(out, "set_count_less", 2 * blocks)


def convert_launch_count(cfg: EngineConfig, w: Workload,
                         strategy: str | None = None,
                         device: str = "cuda") -> dict[str, int]:
    """Kernel launches of ``pipeline.convert``: the Ordering's
    (``sort_launch_count``) and the pointer build's."""
    out = sort_launch_count(cfg, w, strategy, device)
    return _pointer_launches(out, cfg, w) if cfg.use_pallas else out


def delta_launch_count(cfg: EngineConfig, w: Workload, d_cap: int,
                       strategy: str | None = None,
                       device: str = "cuda") -> dict[str, int]:
    """Kernel launches of ``pipeline.apply_delta``'s merge path: the two
    delta streams' sorts on the pow2 delta bucket (under
    ``resolve_delta_sort_strategy``), the event zip on the merge rung, two
    rank passes always fused, and ``DELTA_RANK_PASSES`` more when
    ``delta_epilogue_strategy`` resolves fused."""
    from .delta import DELTA_RANK_PASSES
    out: dict[str, int] = {}
    if not cfg.use_pallas:
        return out
    wd = delta_workload(w, d_cap)
    if strategy is None:
        strategy = resolve_delta_sort_strategy(cfg, wd)
    for _stream in range(2):
        for bound, has_vals in _ordering_sorts(
                dataclasses.replace(cfg, sort_mode="auto"), w.n):
            _global_sort_launches(out, cfg, d_cap, bound, has_vals,
                                  strategy, device)
    _add(out, "merge_rung")
    fused = delta_epilogue_strategy(cfg, w, d_cap) == "fused"
    return _add(out, "rank_search", 2 + (DELTA_RANK_PASSES if fused else 0))


def shard_convert_launch_count(cfg: EngineConfig, w: Workload, n_dev: int,
                               strategy: str | None = None,
                               device: str = "cuda") -> dict[str, int]:
    """Kernel launches of ``engine.shard.shard_convert_ranks`` at a world
    of ``n_dev`` (every rank's share run in one process): per global sort,
    each rank's span sorted to one run, then the cross-rank rungs
    (fan-in 2, the merge rung); each rank's pointer block. Where the
    buffer cannot be cut (``_shardable``), ``convert_launch_count``."""
    from repro_torch.engine.shard import _shardable
    e = next_pow2(w.e)
    if not _shardable(e, n_dev):
        return convert_launch_count(cfg, w, strategy, device)
    out: dict[str, int] = {}
    if not cfg.use_pallas:
        return out
    strategy = strategy or resolve_sort_strategy(cfg, w)
    local = e // n_dev
    for bound, has_vals in _ordering_sorts(cfg, w.n):
        for _rank in range(n_dev):
            _global_sort_launches(out, cfg, local, bound, has_vals,
                                  strategy, device)
        _merge_launches(out, e, local, 2, fused=False)
    return _pointer_launches(out, cfg, w, blocks=n_dev)


def delta_sort_op_count(cfg: EngineConfig, w: Workload, d_cap: int,
                        strategy: str | None = None,
                        cal: Calibration | None = None) -> int:
    """Native sorts of the delta merge (the reference's arithmetic): the
    two delta sorts' passes under xla_sort plus the one event-zip rung,
    a native sort in the reference (under ``use_pallas`` the port zips on
    the merge-rung kernel instead)."""
    wd = delta_workload(w, d_cap)
    if strategy is None:
        strategy = resolve_delta_sort_strategy(cfg, wd, cal)
    return 2 * sort_op_count(cfg, wd, strategy) + 1


def shard_collective_bytes_budget(cfg: EngineConfig, w: Workload,
                                  n_dev: int) -> float:
    """Ceiling on the sharded convert's collective bytes (the reference's
    arithmetic): one int32 stream all-gathered a cross-rank merge round a
    global sort (two with the two-pass payload), times 2 of slack for the
    pointer blocks' gather."""
    passes = sort_pass_count(cfg, w)
    streams = 1 if passes == 1 else 2
    e = next_pow2(w.e)
    rounds = max(1, len(merge_round_fan_ins(e, e // max(1, n_dev), 2)))
    return 2.0 * passes * streams * rounds * 4.0 * e
