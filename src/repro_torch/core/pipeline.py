"""End-to-end preprocessing pipeline (port of ``repro/core/pipeline.py``).

COO → [Ordering] → sorted COO → [Reshaping] → CSC → [Selecting] → sampled
nodes/edges → [Reindexing] → sampled Subgraph, itself re-converted to CSC
by a second Ordering + Reshaping pass. Everything runs on the device that
holds the graph; ``convert`` and ``preprocess`` default to the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .costmodel import (EngineConfig, Workload, delta_epilogue_strategy,
                        delta_workload, pointer_reindex_strategy,
                        reindex_query_count, resolve_delta_mode,
                        resolve_delta_sort_strategy, resolve_reindex_strategy,
                        resolve_sort_strategy)
from .delta import EdgeDelta, delta_merge, rebuild_coo
from .graph import (COO, CSC, SENTINEL, Subgraph, next_pow2, pad_to,
                    resolve_device, take)
from .ordering import edge_ordering, edge_ordering_xla, stable_sort_by_key
from .reindexing import build_reindex_map, reindex_edges
from .reshaping import build_pointer_array, data_reshaping
from .sampling import sample_khop


class KernelFns(NamedTuple):
    chunk_sort_fn: object
    count_fn: object
    merge_fn: object
    rank_fn: object
    rename_fn: object
    rung_fn: object
    radix_sort_fn: object


# cfg.key -> its KernelFns, built once a configuration (the staged
# bitstreams: every later convert, sample or service dispatch reuses them)
_KERNEL_FNS: dict[str, KernelFns] = {}


def kernel_fns(cfg: EngineConfig) -> KernelFns:
    """The kernel routing rule, built once a ``cfg.key`` and kept in
    ``_KERNEL_FNS`` (a caller that swaps a kernel module's function clears
    it around the swap): ``use_pallas`` swaps in the chunk-sort
    kernel (digit width ``cfg.radix_bits``), the set-count kernel, the
    fused-merge kernel (ladder fan-in ``cfg.merge_fan_in``), the
    rank-epilogue kernels, the merge-rung kernel (the ladder's rungs above
    the fused merge, which the reference runs in jnp) and the whole
    global_radix sort (the card's histogram and scatter kernels on their
    own digit schedule, where the reference routes each digit pass). Each
    wrapper launches its kernel on a CUDA tensor and runs its plain twin on
    a CPU tensor."""
    kf = _KERNEL_FNS.get(cfg.key)
    if kf is None:
        # repro: allow-scatter-write — a host dict of closures, no tensor
        kf = _KERNEL_FNS[cfg.key] = _build_kernel_fns(cfg)
    return kf


def _build_kernel_fns(cfg: EngineConfig) -> KernelFns:
    if not cfg.use_pallas:
        return KernelFns(None, None, None, None, None, None, None)
    from repro_torch.kernels.merge import make_merge_fn, merge_rung
    from repro_torch.kernels.radix_sort import (make_chunk_sort_fn,
                                                make_radix_sort_fn)
    from repro_torch.kernels.reindex_epilogue import rank_fn, rename_fn
    from repro_torch.kernels.set_count import count_fn
    return KernelFns(make_chunk_sort_fn(cfg.radix_bits), count_fn,
                     make_merge_fn(cfg.merge_fan_in),
                     rank_fn, rename_fn, merge_rung,
                     make_radix_sort_fn(cfg.radix_bits, cfg.w_upe))


def _sort_kwargs(cfg: EngineConfig, kf: KernelFns, chunk_sort_fn) -> dict:
    """The sort knobs every global sort of a config shares."""
    return dict(radix_bits=cfg.radix_bits, chunk_sort_fn=chunk_sort_fn,
                merge_fn=kf.merge_fn, rung_fn=kf.rung_fn,
                fan_in=cfg.merge_fan_in, radix_sort_fn=kf.radix_sort_fn)


def convert(coo: COO, cfg: EngineConfig | None = None, device="cuda",
            count_fn=None, chunk_sort_fn=None) -> CSC:
    """Graph conversion: Ordering + Reshaping under an engine config, on
    ``device`` (the COO is moved there; a missing card raises). Explicit
    ``count_fn`` / ``chunk_sort_fn`` override the config's routing."""
    coo = coo.to(resolve_device(device))
    cfg = cfg or EngineConfig()
    kf = kernel_fns(cfg)
    count_fn = count_fn or kf.count_fn
    w = Workload(n=coo.n_nodes, e=coo.capacity)
    sorted_coo = edge_ordering(
        coo, chunk=min(cfg.w_upe, coo.capacity), mode=cfg.sort_mode,
        strategy=resolve_sort_strategy(cfg, w),
        **_sort_kwargs(cfg, kf, chunk_sort_fn or kf.chunk_sort_fn))
    ptr_fused = pointer_reindex_strategy(cfg, w) == "fused"
    return data_reshaping(sorted_coo, count_fn=count_fn, unroll=ptr_fused,
                          rank_fn=kf.rank_fn if ptr_fused else None)


def _node_pointers(sorted_dst: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """ptr[v] = the first slot of dst v in the sorted column, by the
    library's binary search (the baselines' Reshaping)."""
    targets = torch.arange(n_nodes + 1, dtype=torch.int32,
                           device=sorted_dst.device)
    return torch.searchsorted(sorted_dst, targets).to(torch.int32)


def convert_xla(coo: COO, device="cuda") -> CSC:
    """The baseline conversion, on ``device``: ``edge_ordering_xla``'s two
    library sorts, then ``torch.searchsorted`` for the pointers. No
    hand-written kernel runs; it equals :func:`convert` bit for bit."""
    coo = coo.to(resolve_device(device))
    sorted_coo = edge_ordering_xla(coo)
    return CSC(ptr=_node_pointers(sorted_coo.dst, coo.n_nodes),
               idx=sorted_coo.src, n_edges=coo.n_edges, n_nodes=coo.n_nodes)


def apply_delta(csc: CSC, delta: EdgeDelta, cfg: EngineConfig | None = None,
                mode: str = "auto", out_capacity: int | None = None) -> CSC:
    """Incremental conversion: splice one insert/delete batch into a sorted
    CSC, on the device that holds it.

    ``mode="merge"`` runs the O(delta) path (``delta.delta_merge``);
    ``"rebuild"`` tombstones the deletes, appends the inserts and
    re-converts; ``"auto"`` takes the one the cost model prices cheaper
    (``costmodel.resolve_delta_mode``) on this (capacity, delta bucket).
    Both modes return a CSC with ``out_capacity`` (default: the input's)
    index slots, bit-identical to a fresh :func:`convert` of the
    post-update edge list. The delta sorts run under
    ``costmodel.resolve_delta_sort_strategy`` with this config's kernel
    routing, the rank passes fused or unfused as
    ``costmodel.delta_epilogue_strategy`` prices them. The caller makes
    sure the surviving edges fit ``out_capacity``
    (``engine.service.PreprocService.apply_delta`` grows it).
    """
    cfg = cfg or EngineConfig()
    kf = kernel_fns(cfg)
    e_cap = csc.idx.shape[0]
    d_cap = delta.capacity
    w = Workload(n=csc.n_nodes, e=e_cap)
    if mode == "auto":
        mode = resolve_delta_mode(cfg, w, d_cap)
    if mode not in ("merge", "rebuild"):
        raise ValueError(f"unknown delta mode {mode!r}")
    d_strategy = resolve_delta_sort_strategy(cfg, delta_workload(w, d_cap))
    fused = delta_epilogue_strategy(cfg, w, d_cap) == "fused"
    sort_kw = _sort_kwargs(cfg, kf, kf.chunk_sort_fn)

    def delta_sort_fn(k, v, bound):
        return stable_sort_by_key(k, v, bound, chunk=min(cfg.w_upe, d_cap),
                                  strategy=d_strategy, **sort_kw)

    if mode == "merge":
        return delta_merge(csc, delta, sort_fn=delta_sort_fn, unroll=fused,
                           out_capacity=out_capacity, rank_fn=kf.rank_fn,
                           rung_fn=kf.rung_fn)
    coo = rebuild_coo(csc, delta, sort_fn=delta_sort_fn, unroll=fused,
                      rank_fn=kf.rank_fn)
    wc = Workload(n=coo.n_nodes, e=coo.capacity)
    sorted_coo = edge_ordering(
        coo, chunk=min(cfg.w_upe, coo.capacity), mode=cfg.sort_mode,
        strategy=resolve_sort_strategy(cfg, wc), **sort_kw)
    ptr_fused = pointer_reindex_strategy(cfg, wc) == "fused"
    full = data_reshaping(sorted_coo, count_fn=kf.count_fn, unroll=ptr_fused,
                          rank_fn=kf.rank_fn if ptr_fused else None)
    out_cap = e_cap if out_capacity is None else out_capacity
    idx = (full.idx[:out_cap] if out_cap <= full.idx.shape[0]
           else pad_to(full.idx, out_cap, SENTINEL))
    ptr = full.ptr
    if csc.ptr.shape[0] > ptr.shape[0]:  # keep a padded pointer tail
        ptr = torch.cat([ptr, ptr[-1:].expand(csc.ptr.shape[0]
                                              - ptr.shape[0])])
    return CSC(ptr=ptr, idx=idx, n_edges=full.n_edges, n_nodes=csc.n_nodes)


def sample_subgraph(csc: CSC, batch_nodes: torch.Tensor,
                    fanouts: tuple[int, ...], key,
                    cfg: EngineConfig | None = None, count_fn=None,
                    chunk_sort_fn=None) -> Subgraph:
    """Selecting + Reindexing + subgraph conversion → sampled CSC subgraph,
    on the device that holds ``csc``. ``key`` is the request key or its
    [K, 2] schedule (``prng.key_schedule`` under ``cfg.selection``).
    Explicit ``count_fn`` / ``chunk_sort_fn`` override the config's
    routing."""
    cfg = cfg or EngineConfig()
    kf = kernel_fns(cfg)
    count_fn = count_fn or kf.count_fn
    sort_kw = _sort_kwargs(cfg, kf, chunk_sort_fn or kf.chunk_sort_fn)
    nodes, e_dst, e_src = sample_khop(csc, batch_nodes, fanouts, key,
                                      selection=cfg.selection)
    n_cap = nodes.shape[0]
    r_sort_strat = resolve_sort_strategy(
        cfg, Workload(n=csc.n_nodes, e=next_pow2(n_cap)))

    def reindex_sort_fn(k, v, bound):
        return stable_sort_by_key(k, v, bound, chunk=min(cfg.w_upe, k.shape[0]),
                                  strategy=r_sort_strat, **sort_kw)

    r_strat = resolve_reindex_strategy(
        cfg, reindex_query_count(n_cap, e_dst.shape[0]), n_cap)
    r_fused = r_strat == "fused"
    rmap = build_reindex_map(nodes, vid_bound=csc.n_nodes, strategy=r_strat,
                             sort_fn=reindex_sort_fn,
                             rank_fn=kf.rank_fn if r_fused else None,
                             rename_fn=kf.rename_fn if r_fused else None)
    raw = reindex_edges(rmap, e_dst, e_src, n_nodes_cap=n_cap)
    e_cap = next_pow2(raw.dst.shape[0])
    sub_coo = COO(dst=pad_to(raw.dst, e_cap, SENTINEL),
                  src=pad_to(raw.src, e_cap, SENTINEL),
                  n_edges=raw.n_edges, n_nodes=n_cap)
    strategy = resolve_sort_strategy(cfg, Workload(n=n_cap, e=e_cap))
    sub_sorted = edge_ordering(sub_coo, chunk=min(cfg.w_upe, e_cap),
                               mode=cfg.sort_mode, strategy=strategy,
                               **sort_kw)
    sub_ptr_fused = resolve_reindex_strategy(cfg, n_cap + 1, e_cap) == "fused"
    sub_csc = data_reshaping(sub_sorted, count_fn=count_fn,
                             unroll=sub_ptr_fused,
                             rank_fn=kf.rank_fn if sub_ptr_fused else None)
    return Subgraph(csc=sub_csc, order=rmap.order, n_sub_nodes=rmap.n_unique)


def sample_subgraph_batched(csc: CSC, batch_nodes: torch.Tensor,
                            fanouts: tuple[int, ...], schedules: torch.Tensor,
                            cfg: EngineConfig | None = None) -> Subgraph:
    """Slot-batched sampling, the reference's stacked form: one
    ``sample_subgraph`` lane per row of ``batch_nodes`` [S, B] with its
    schedule ``schedules[i]`` ([S, K, 2]); every leaf of the result
    carries a leading [S] axis. Lane i runs the single-request program on
    its own row and keys, so it equals ``sample_subgraph(csc,
    batch_nodes[i], fanouts, schedules[i], cfg)`` bit for bit, whatever
    the other lanes hold. (The serve step runs its lanes one by one and
    stacks nothing.)"""
    lanes = [sample_subgraph(csc, batch_nodes[i], fanouts, schedules[i], cfg)
             for i in range(batch_nodes.shape[0])]
    return Subgraph(
        csc=CSC(ptr=torch.stack([s.csc.ptr for s in lanes]),
                idx=torch.stack([s.csc.idx for s in lanes]),
                n_edges=torch.stack([s.csc.n_edges for s in lanes]),
                n_nodes=lanes[0].csc.n_nodes),
        order=torch.stack([s.order for s in lanes]),
        n_sub_nodes=torch.stack([s.n_sub_nodes for s in lanes]))


def transpose_layout(edge_src: torch.Tensor, n_nodes: int,
                     cfg: EngineConfig | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The transposed layout of a sampled subgraph's edges, for the
    backward of its forward's gathers and sums (``models/gnn.py``):
    (rev_perm [E] int32, the edge positions stably sorted by ``edge_src``,
    SENTINEL sources last; rev_ptr [n_nodes + 1] int32, its pointers).
    One sort and one pointer build under ``cfg``'s routing, as the
    subgraph convert runs them (the card's sort and rank kernels)."""
    cfg = cfg or EngineConfig()
    kf = kernel_fns(cfg)
    e = edge_src.shape[0]
    pos = torch.arange(e, dtype=torch.int32, device=edge_src.device)
    sorted_src, rev_perm = stable_sort_by_key(
        edge_src, pos, n_nodes, chunk=min(cfg.w_upe, e),
        strategy=resolve_sort_strategy(cfg, Workload(n=n_nodes, e=e)),
        **_sort_kwargs(cfg, kf, kf.chunk_sort_fn))
    fused = resolve_reindex_strategy(cfg, n_nodes + 1, e) == "fused"
    rev_ptr = build_pointer_array(sorted_src, n_nodes, count_fn=kf.count_fn,
                                  unroll=fused,
                                  rank_fn=kf.rank_fn if fused else None)
    return rev_perm, rev_ptr


def preprocess(coo: COO, batch_nodes, fanouts: tuple[int, ...], key,
               cfg: EngineConfig | None = None, device="cuda") -> Subgraph:
    """The full workflow: convert, then sample one subgraph."""
    dev = resolve_device(device)
    csc = convert(coo, cfg, device=dev)
    seeds = torch.as_tensor(batch_nodes, dtype=torch.int32).to(dev)
    return sample_subgraph(csc, seeds, fanouts, key, cfg)


def preprocess_xla_baseline(coo: COO, batch_nodes, fanouts: tuple[int, ...],
                            key, device="cuda") -> Subgraph:
    """The paper's GPU baseline of the whole workflow, on ``device``:
    :func:`convert_xla`, keysort selection, the reindex map's library sort,
    and the subgraph's CSC by the same two sorts and ``searchsorted``."""
    dev = resolve_device(device)
    csc = convert_xla(coo, device=dev)
    seeds = torch.as_tensor(batch_nodes, dtype=torch.int32).to(dev)
    nodes, e_dst, e_src = sample_khop(csc, seeds, fanouts, key,
                                      selection="keysort")
    n_cap = nodes.shape[0]
    rmap = build_reindex_map(nodes)
    sub = edge_ordering_xla(reindex_edges(rmap, e_dst, e_src,
                                          n_nodes_cap=n_cap))
    sub_csc = CSC(ptr=_node_pointers(sub.dst, n_cap), idx=sub.src,
                  n_edges=sub.n_edges, n_nodes=n_cap)
    return Subgraph(csc=sub_csc, order=rmap.order, n_sub_nodes=rmap.n_unique)


def gather_features(sub: Subgraph, features: torch.Tensor) -> torch.Tensor:
    """Feature rows of the sampled subgraph's nodes (zero on padding)."""
    rows = take(features, sub.order)
    return rows.masked_fill_((sub.order == SENTINEL)[:, None], 0)
