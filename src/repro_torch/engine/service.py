"""PreprocService, the preprocessing engine's front end (port of
``repro/engine/service.py``).

One service object does what the paper's runtime does end to end:

1. **profile** the workload (graph metadata, on the host),
2. **score** the configuration library with the Table-I cost model and
   switch configurations when the predicted gain amortises the
   reconfiguration,
3. **bucket** inputs to power-of-two capacities, so the number of
   distinct dispatches stays O(log(max_e) · log(max_b) · |library|),
4. **dispatch** through one module-level table keyed by (entry point,
   ``EngineConfig.key``, input shapes): the bitstreams-staged-in-DRAM
   analog. Torch has no jit; an entry holds its configuration's
   ``KernelFns`` (``pipeline.kernel_fns``), built once, and every service
   shares the table, so re-dispatching a pair already seen adds no entry,
   builds no routing and loads no kernel library.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import pipeline
from repro_torch.core.costmodel import (Calibration, EngineConfig, Workload,
                                        bitstream_library)
from repro_torch.core.delta import EdgeDelta
from repro_torch.core.graph import COO, SENTINEL, next_pow2, pad_to
from repro_torch.core.reconfig import (RECONFIG_S_PARTIAL, ReconfigDecision,
                                       decide)

# (entry point, cfg.key, input shapes) -> the entry's KernelFns
_DISPATCH: dict[tuple, pipeline.KernelFns] = {}


def _dispatch(entry: str, cfg: EngineConfig, shapes: tuple) -> None:
    key = (entry, cfg.key, shapes)
    if key not in _DISPATCH:
        _DISPATCH[key] = pipeline.kernel_fns(cfg)


def _entries(entry: str) -> int:
    return sum(1 for k in _DISPATCH if k[0] == entry)


# ---------------------------------------------------------------------------
# Module-level entry points (one table a process, not one a service).
# ---------------------------------------------------------------------------

def preprocess_jit(coo: COO, batch_nodes, fanouts: tuple[int, ...], key,
                   cfg: EngineConfig = EngineConfig()):
    """``pipeline.preprocess`` on the COO's device, through the table."""
    seeds = torch.as_tensor(batch_nodes, dtype=torch.int32)
    _dispatch("preprocess", cfg, (coo.capacity, coo.n_nodes,
                                  tuple(seeds.shape), tuple(fanouts)))
    return pipeline.preprocess(coo, seeds, tuple(fanouts), key, cfg,
                               device=coo.device)


def sample_jit(csc, batch_nodes: torch.Tensor, fanouts: tuple[int, ...],
               key, cfg: EngineConfig | None = None):
    """``pipeline.sample_subgraph`` through the table."""
    cfg = cfg or EngineConfig()
    _dispatch("sample", cfg, (csc.idx.shape[0], csc.n_nodes,
                              tuple(batch_nodes.shape), tuple(fanouts)))
    return pipeline.sample_subgraph(csc, batch_nodes, tuple(fanouts), key,
                                    cfg)


def sample_batched_jit(csc, batch_nodes: torch.Tensor,
                       fanouts: tuple[int, ...], keys,
                       cfg: EngineConfig | None = None):
    """``pipeline.sample_subgraph_batched`` through the table; ``keys`` is
    one key (or [K, 2] schedule) a row."""
    cfg = cfg or EngineConfig()
    _dispatch("sample_batched", cfg, (csc.idx.shape[0], csc.n_nodes,
                                      tuple(batch_nodes.shape),
                                      tuple(fanouts)))
    return pipeline.sample_subgraph_batched(csc, batch_nodes, tuple(fanouts),
                                            keys, cfg)


def convert_jit(coo: COO, cfg: EngineConfig | None = None):
    """``pipeline.convert`` on the COO's device, through the table."""
    cfg = cfg or EngineConfig()
    _dispatch("convert", cfg, (coo.capacity, coo.n_nodes))
    return pipeline.convert(coo, cfg, device=coo.device)


def apply_delta_jit(csc, delta: EdgeDelta, cfg: EngineConfig | None = None,
                    mode: str = "auto", out_capacity: int | None = None):
    """``pipeline.apply_delta`` through the table."""
    cfg = cfg or EngineConfig()
    _dispatch("apply_delta", cfg, (csc.idx.shape[0], csc.ptr.shape[0],
                                   csc.n_nodes, delta.capacity, mode,
                                   out_capacity))
    return pipeline.apply_delta(csc, delta, cfg, mode=mode,
                                out_capacity=out_capacity)


def convert_cache_size() -> int:
    """Entries behind ``convert_jit``."""
    return _entries("convert")


def preprocess_cache_size() -> int:
    """Entries behind ``preprocess_jit`` (what the zero-recompile checks
    hold still)."""
    return _entries("preprocess")


def sample_batched_cache_size() -> int:
    """Entries behind ``sample_batched_jit``."""
    return _entries("sample_batched")


def apply_delta_cache_size() -> int:
    """Entries behind ``apply_delta_jit``."""
    return _entries("apply_delta")


# ---------------------------------------------------------------------------
# pow2 buckets: every pad is SENTINEL, on the tensor's own device
# ---------------------------------------------------------------------------

def bucket_coo(coo: COO) -> COO:
    """Pad the edge buffer to its pow2 capacity (SENTINEL tail); a pow2
    buffer passes through as it is."""
    cap = next_pow2(coo.capacity)
    if cap == coo.capacity:
        return coo
    return COO(dst=pad_to(coo.dst, cap, SENTINEL),
               src=pad_to(coo.src, cap, SENTINEL),
               n_edges=coo.n_edges, n_nodes=coo.n_nodes)


def bucket_batch(batch_nodes: torch.Tensor) -> torch.Tensor:
    """Pad the seed list to its pow2 bucket with SENTINEL (padding seeds
    have degree 0 and never claim a VID, so the real seeds keep the first
    new VIDs)."""
    cap = next_pow2(batch_nodes.shape[0])
    if cap == batch_nodes.shape[0]:
        return batch_nodes
    return pad_to(batch_nodes, cap, SENTINEL)


def bucket_seed_rows(seed_rows: torch.Tensor) -> torch.Tensor:
    """Pad [S, B] seed rows to the pow2 row bucket with SENTINEL."""
    cap = next_pow2(seed_rows.shape[1])
    if cap == seed_rows.shape[1]:
        return seed_rows
    return torch.nn.functional.pad(seed_rows, (0, cap - seed_rows.shape[1]),
                                   value=SENTINEL)


def bucket_delta(delta: EdgeDelta) -> EdgeDelta:
    """Pad both delta streams to the pow2 delta bucket (SENTINEL tails):
    every delta up to the bucket re-enters one dispatch entry."""
    cap = next_pow2(delta.capacity)
    if cap == delta.capacity:
        return delta
    return EdgeDelta(ins_dst=pad_to(delta.ins_dst, cap, SENTINEL),
                     ins_src=pad_to(delta.ins_src, cap, SENTINEL),
                     del_dst=pad_to(delta.del_dst, cap, SENTINEL),
                     del_src=pad_to(delta.del_src, cap, SENTINEL),
                     n_ins=delta.n_ins, n_del=delta.n_del,
                     n_nodes=delta.n_nodes)


def _dp_size(mesh) -> int:
    """The mesh's data-parallel extent: the product of every axis but
    ``model`` (a ``torch.distributed`` ``DeviceMesh``; None is one
    device)."""
    if mesh is None:
        return 1
    names = mesh.mesh_dim_names or tuple(
        f"dim{i}" for i in range(mesh.ndim))
    n = 1
    for i, name in enumerate(names):
        if name != "model":
            n *= mesh.size(i)
    return n


@dataclasses.dataclass
class ServiceStats:
    """Dispatch counters one :class:`PreprocService` accumulates."""

    n_dispatches: int = 0
    n_reconfigs: int = 0
    n_unique_keys: int = 0  # distinct (EngineConfig.key, bucket) pairs


class PreprocService:
    """The preprocessing engine as a long-lived service.

    One instance a workload stream; every instance shares the module-level
    dispatch table. Dispatches run on the device that holds their inputs.
    With a ``mesh`` whose data-parallel extent is above 1, ``preprocess``
    runs the sharded engine (``engine.shard.jit_shard_preprocess``):
    every rank calls it with the same inputs and gets the same subgraph.
    """

    def __init__(self, fanouts: tuple[int, ...],
                 library: list[EngineConfig] | None = None,
                 cal: Calibration | None = None,
                 mesh=None,
                 switch_threshold: float = 1.5,
                 reconfig_cost_s: float = RECONFIG_S_PARTIAL):
        self.fanouts = tuple(fanouts)
        self.library = library or bitstream_library()
        self.cal = cal or Calibration()
        self.mesh = mesh
        self.threshold = switch_threshold
        self.reconfig_cost_s = reconfig_cost_s
        self.active_cfg: EngineConfig | None = None
        self.stats = ServiceStats()
        self._keys_seen: set[tuple[str, tuple[int, ...]]] = set()

    # ------------------------------------------------------------- profiling
    def profile(self, coo: COO, batch_size: int,
                bucketed: bool = False) -> Workload:
        """Graph metadata capture. ``bucketed`` scores the pow2 capacity
        instead of the edge count (one host read), so the selected
        configuration is a function of the bucket alone."""
        e = next_pow2(coo.capacity) if bucketed else int(coo.n_edges)
        return Workload(n=coo.n_nodes, e=e, l=len(self.fanouts),
                        k=max(self.fanouts), b=batch_size)

    def decide(self, w: Workload) -> ReconfigDecision:
        """Score ``w`` against the library and decide whether the predicted
        gain amortises the reconfiguration; the candidate has both
        dispatch axes pinned (``costmodel.choose_config``)."""
        return decide(w, self.active_cfg, self.library, self.cal,
                      self.threshold, self.reconfig_cost_s)

    def _adopt(self, w: Workload) -> EngineConfig:
        d = self.decide(w)
        if d.reconfigure or self.active_cfg is None:
            self.active_cfg = d.config
            self.stats.n_reconfigs += 1
        return self.active_cfg

    def select(self, coo: COO, batch_size: int) -> EngineConfig:
        """Profile and score; switch the active configuration if
        warranted."""
        return self._adopt(self.profile(coo, batch_size, bucketed=True))

    def _account(self, cfg: EngineConfig, bucket: tuple[int, ...]) -> None:
        self.stats.n_dispatches += 1
        self._keys_seen.add((cfg.key, bucket))
        self.stats.n_unique_keys = len(self._keys_seen)

    # ------------------------------------------------------------- dispatch
    def preprocess(self, coo: COO, batch_nodes, key,
                   cfg: EngineConfig | None = None):
        """Bucket, select, dispatch; returns the sampled ``Subgraph``. An
        explicit ``cfg`` pins the configuration (StatPre / AutoPre);
        without it DynPre selects."""
        coo_b = bucket_coo(coo)
        seeds = torch.as_tensor(batch_nodes, dtype=torch.int32).to(
            coo_b.device)
        bn_b = bucket_batch(seeds)
        cfg = cfg or self.select(coo_b, int(bn_b.shape[0]))
        self._account(cfg, (coo_b.capacity, int(bn_b.shape[0])))
        if _dp_size(self.mesh) > 1:
            from .shard import jit_shard_preprocess
            return jit_shard_preprocess(self.mesh)(coo_b, bn_b, self.fanouts,
                                                   key, cfg)
        return preprocess_jit(coo_b, bn_b, self.fanouts, key, cfg)

    def sample_batched(self, csc, seed_rows, keys,
                       cfg: EngineConfig | None = None):
        """Slot-batched sampling: ``seed_rows`` [S, B] padded per row to
        the pow2 bucket, the configuration pinned or selected on the
        sampling workload, accounted under (``cfg.key``, (S, B bucket))."""
        rows = bucket_seed_rows(torch.as_tensor(seed_rows, dtype=torch.int32)
                                .to(csc.idx.device))
        if cfg is None:
            cfg = self._adopt(Workload(
                n=csc.n_nodes, e=int(csc.idx.shape[0]), l=len(self.fanouts),
                k=max(self.fanouts), b=int(rows.shape[1])))
        self._account(cfg, (int(rows.shape[0]), int(rows.shape[1])))
        return sample_batched_jit(csc, rows, self.fanouts, keys, cfg)

    def apply_delta(self, csc, delta: EdgeDelta,
                    cfg: EngineConfig | None = None, mode: str = "auto"):
        """A streamed graph update: bucket the delta, dispatch the
        incremental conversion, return the post-update CSC, accounted under
        (``cfg.key``, (e_cap, d_bucket, out_cap)). When the surviving-edge
        bound ``n_edges + n_ins`` (read on the host: a sync) would overflow
        the index buffer, the output capacity grows to the next pow2."""
        delta_b = bucket_delta(delta)
        if cfg is None:
            if self.active_cfg is None:
                w = Workload(n=csc.n_nodes, e=int(csc.idx.shape[0]),
                             l=len(self.fanouts), k=max(self.fanouts))
                self.active_cfg = self.decide(w).config
                self.stats.n_reconfigs += 1
            cfg = self.active_cfg
        e_cap = int(csc.idx.shape[0])
        need = int(csc.n_edges) + int(delta_b.n_ins)
        out_cap = e_cap if need <= e_cap else next_pow2(need)
        self._account(cfg, (e_cap, delta_b.capacity, out_cap))
        return apply_delta_jit(csc, delta_b, cfg=cfg, mode=mode,
                               out_capacity=out_cap)

    @staticmethod
    def cache_size() -> int:
        """:func:`preprocess_cache_size` (every service shares it)."""
        return preprocess_cache_size()
