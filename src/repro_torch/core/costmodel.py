"""Cost model (port of the part of ``repro/core/costmodel.py`` the serve
path resolves through).

``EngineConfig`` carries the reconfigurable knobs; ``resolve_sort_strategy``
and ``resolve_reindex_strategy`` turn its ``"auto"`` axes into the strategy
that runs, scored by the paper's Table-I terms under a ``Calibration``.
The default calibration is the reference's CPU-measured one, so ``auto``
picks what the reference picks; it has not been recalibrated on a GPU.
The delta-update terms and the HLO censuses are not ported yet.
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
    selection: selector algorithm (only "floyd" is ported)
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
