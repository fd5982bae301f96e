"""Mesh-sharded preprocessing: data-parallel Ordering and tiled Reshaping
(port of ``repro/engine/shard.py``).

The paper's UPE lanes are the ranks of the mesh's data-parallel axes.
Every rank runs the same program (explicit SPMD) on the whole COO and
returns the whole CSC; in between, each rank does its share and one
all-gather over the dp group joins the shares:

* **Ordering** — the edge buffer is cut into one contiguous span a rank.
  Each rank sorts its span to one run (``local_sorted_run``: the chunk
  sort and the local merge ladder under ``chunked_merge``, the digit
  passes under ``global_radix``, one stable sort under ``xla_sort``),
  the runs are all-gathered in rank order, and ``log2(n_dev)`` merge
  rounds finish the global sort on every rank (``merge_runs``; the
  merge-rung kernel on the card). A stable sort has one output, so the
  result is bit-identical to single-device ``pipeline.convert``'s.
* **Reshaping** — the pointer targets, padded with ``n_nodes`` to a
  multiple of the world, are cut into one block a rank; each rank ranks
  its block against the whole sorted dst stream (the rank-search or
  set-count kernel, or the search), and the blocks are all-gathered.
* **Selecting and Reindexing** run ``pipeline.sample_subgraph`` on the
  whole CSC with the same key, so ``shard_preprocess`` equals
  ``pipeline.preprocess`` bit for bit.

The fallbacks are the reference's, no others: with no dp extent, a dp
extent or a span that is not a power of two, or a buffer that does not
divide, the single-device sort (or pipeline) runs.

The stages are separate functions so that one process can run them rank
by rank (``shard_convert_ranks``: every rank's share in turn, the
gather a concatenation), which is how a single card holds a world of 2
or 4 against ``convert``.
"""
from __future__ import annotations

from functools import lru_cache, partial

import torch

from repro_torch.core import pipeline
from repro_torch.core.costmodel import (EngineConfig, Workload,
                                        pointer_reindex_strategy,
                                        resolve_sort_strategy)
from repro_torch.core.graph import COO, CSC, SENTINEL, Subgraph
from repro_torch.core.ordering import (DEFAULT_CHUNK, _bits_for, _chunk_sort,
                                       _global_radix_passes, edge_ordering,
                                       merge_rounds, stable_sort_by_key)
from repro_torch.core.set_count import rank_in_sorted
from repro_torch.dist.groups import (all_gather_cat, check_device, dp_group,
                                     dp_rank, note_collective)
from repro_torch.dist.sharding import _axes_size, dp_axes


def _dp(mesh) -> tuple[tuple[str, ...], int]:
    if mesh is None:
        return (), 1
    dp = dp_axes(mesh)
    return dp, _axes_size(mesh, dp)


class _Gather:
    """The one collective of a sharded stage: ``gather(fn)`` concatenates
    ``fn(r)`` (a tuple of tensors or Nones, rank r's share) over the
    ranks in rank order. On a mesh this rank computes its own share and
    all-gathers over the dp group; with no group (``ranks``) one process
    computes every share in turn."""

    def __init__(self, n: int, rank: int | None = None, group=None):
        self.n, self.rank, self.group = n, rank, group

    @classmethod
    def of_mesh(cls, mesh) -> "_Gather":
        _, nd = _dp(mesh)
        return cls(nd, dp_rank(mesh), dp_group(mesh))

    def __call__(self, fn):
        if self.group is None:
            shares = [fn(r) for r in range(self.n)]
            for t in shares[0]:
                if t is not None:
                    note_collective("all-gather", t)
            return tuple(None if s[0] is None else torch.cat(list(s))
                         for s in zip(*shares))
        return tuple(None if t is None else all_gather_cat(t, self.group)
                     for t in fn(self.rank))


def _mesh_gather(mesh, t: torch.Tensor) -> _Gather:
    """The mesh's gather (none with no dp extent); ``t`` must lie on the
    mesh's device type."""
    _, nd = _dp(mesh)
    if nd <= 1:
        return _Gather(1)
    check_device(mesh, t)
    return _Gather.of_mesh(mesh)


def _shardable(n: int, nd: int) -> bool:
    """The merge tree needs power-of-two run counts: the rank count and
    the span."""
    return not (nd <= 1 or nd & (nd - 1) or n % nd
                or (n // nd) & (n // nd - 1))


def local_sorted_run(span_keys: torch.Tensor, span_vals: torch.Tensor | None,
                     key_bound: int, *, chunk: int, strategy: str,
                     radix_bits: int = 4, chunk_sort_fn=None, merge_fn=None,
                     fan_in: int = 2, rung_fn=None, radix_sort_fn=None):
    """One rank's span (keys already clipped to ``key_bound``) → one
    stably sorted run, per ``strategy``; the kernels come in through the
    same knobs as ``ordering.stable_sort_by_key``'s. ``span_vals=None``
    sorts keys alone."""
    if strategy == "xla_sort":
        if span_vals is None:
            return torch.sort(span_keys).values, None
        ks, order = torch.sort(span_keys, stable=True)
        return ks, span_vals[order]
    key_bits = _bits_for(key_bound)
    if strategy == "global_radix":
        if radix_sort_fn is not None:
            return radix_sort_fn(span_keys, span_vals, key_bits)
        return _global_radix_passes(span_keys, span_vals, key_bits, chunk,
                                    radix_bits)
    if strategy != "chunked_merge":
        raise ValueError(f"unknown sort strategy {strategy!r}")
    if chunk_sort_fn is None:
        ks, vs = _chunk_sort(span_keys, span_vals, chunk, key_bits,
                             radix_bits)
    else:
        ks, vs = chunk_sort_fn(span_keys, span_vals, chunk, key_bits)
    return merge_rounds(ks, vs, chunk, merge_fn=merge_fn, fan_in=fan_in,
                        rung_fn=rung_fn)


def merge_runs(ks: torch.Tensor, vs: torch.Tensor | None, run: int,
               key_bound: int, rung_fn=None):
    """The global stage: the gathered runs of ``run`` merged pairwise
    (``log2`` of their count rounds, ``rung_fn`` a rung: the merge-rung
    kernel), then the SENTINEL restore."""
    ks, vs = merge_rounds(ks, vs, run, fan_in=2, rung_fn=rung_fn)
    return torch.where(ks >= key_bound, torch.full_like(ks, SENTINEL),
                       ks), vs


def _sort_by_key(gather: _Gather, keys, vals, key_bound: int,
                 chunk: int | None = None, radix_bits: int = 4,
                 strategy: str = "chunked_merge", chunk_sort_fn=None,
                 merge_fn=None, fan_in: int = 2, rung_fn=None,
                 radix_sort_fn=None):
    n, nd = keys.shape[0], gather.n
    chunk = DEFAULT_CHUNK if chunk is None else chunk
    kw = dict(radix_bits=radix_bits, strategy=strategy,
              chunk_sort_fn=chunk_sort_fn, merge_fn=merge_fn, fan_in=fan_in,
              rung_fn=rung_fn, radix_sort_fn=radix_sort_fn)
    if not _shardable(n, nd):
        return stable_sort_by_key(keys, vals, key_bound, chunk=min(chunk, n),
                                  **kw)
    local = n // nd
    clipped = torch.clamp(keys, max=key_bound)

    def share(r):
        k_l = clipped[r * local:(r + 1) * local]
        v_l = None if vals is None else vals[r * local:(r + 1) * local]
        return local_sorted_run(k_l, v_l, key_bound,
                                chunk=min(chunk, local), **kw)

    ks, vs = gather(share)
    return merge_runs(ks, vs, local, key_bound, rung_fn=rung_fn)


def shard_sort_by_key(mesh, keys: torch.Tensor, vals: torch.Tensor | None,
                      key_bound: int, **kw):
    """Global stable sort with the local sort stage cut over the mesh's
    dp ranks; ``kw`` are ``ordering.stable_sort_by_key``'s knobs
    (``chunk``, ``radix_bits``, ``strategy``, ``chunk_sort_fn``,
    ``merge_fn``, ``fan_in``, ``rung_fn``, ``radix_sort_fn``). Falls back
    to the single-device sort where the mesh cannot cut the buffer.
    ``vals=None`` sorts keys alone: no payload is gathered."""
    return _sort_by_key(_mesh_gather(mesh, keys), keys, vals, key_bound,
                        **kw)


def pointer_targets(n_nodes: int, world: int, device) -> torch.Tensor:
    """The targets 0..n_nodes padded with ``n_nodes`` to a multiple of
    the world."""
    t = torch.arange(n_nodes + 1, dtype=torch.int32, device=device)
    pad = (-(n_nodes + 1)) % world
    if pad:
        t = torch.cat([t, torch.full((pad,), n_nodes, dtype=torch.int32,
                                     device=device)])
    return t


def pointer_block(sorted_dst: torch.Tensor, targets: torch.Tensor,
                  count_fn=None, unroll: bool = False,
                  rank_fn=None) -> torch.Tensor:
    """One rank's pointer block: each target's rank in the whole sorted
    dst stream (``rank_fn`` the rank-search kernel, else ``count_fn`` the
    set-count kernel, else the search, unrolled when ``unroll``)."""
    targets = targets.contiguous()
    if rank_fn is not None:
        return rank_fn(sorted_dst, targets, "left")
    if count_fn is not None:
        return count_fn(sorted_dst, targets)
    return rank_in_sorted(sorted_dst, targets, side="left", unroll=unroll)


def _pointer_array(gather: _Gather, sorted_dst, n_nodes: int, **kw):
    nd = gather.n
    if nd <= 1:
        return pointer_block(sorted_dst, pointer_targets(
            n_nodes, 1, sorted_dst.device), **kw)
    t = pointer_targets(n_nodes, nd, sorted_dst.device)
    blk = t.shape[0] // nd
    (ptr,) = gather(lambda r: (pointer_block(
        sorted_dst, t[r * blk:(r + 1) * blk], **kw),))
    return ptr[:n_nodes + 1]


def shard_pointer_array(mesh, sorted_dst: torch.Tensor, n_nodes: int,
                        count_fn=None, unroll: bool = False,
                        rank_fn=None) -> torch.Tensor:
    """Sharded Reshaping: ptr[v] = rank of v in the sorted dst stream,
    the targets cut into one block a dp rank."""
    return _pointer_array(_mesh_gather(mesh, sorted_dst), sorted_dst,
                          n_nodes, count_fn=count_fn, unroll=unroll,
                          rank_fn=rank_fn)


def _edge_ordering(gather: _Gather, coo: COO, cfg: EngineConfig) -> COO:
    kf = pipeline.kernel_fns(cfg)
    strategy = resolve_sort_strategy(cfg, Workload(n=coo.n_nodes,
                                                   e=coo.capacity))
    kw = dict(chunk=cfg.w_upe, strategy=strategy,
              **pipeline._sort_kwargs(cfg, kf, kf.chunk_sort_fn))

    def sort_fn(k, v, bound):
        return _sort_by_key(gather, k, v, bound, **kw)

    return edge_ordering(coo, sort_fn=sort_fn, mode=cfg.sort_mode)


def _convert(gather: _Gather, coo: COO, cfg: EngineConfig) -> CSC:
    kf = pipeline.kernel_fns(cfg)
    sorted_coo = _edge_ordering(gather, coo, cfg)
    fused = pointer_reindex_strategy(
        cfg, Workload(n=coo.n_nodes, e=coo.capacity)) == "fused"
    ptr = _pointer_array(gather, sorted_coo.dst, coo.n_nodes,
                         count_fn=kf.count_fn, unroll=fused,
                         rank_fn=kf.rank_fn if fused else None)
    return CSC(ptr=ptr, idx=sorted_coo.src, n_edges=coo.n_edges,
               n_nodes=coo.n_nodes)


def shard_edge_ordering(mesh, coo: COO,
                        cfg: EngineConfig | None = None) -> COO:
    """Sharded edge Ordering: ``ordering.edge_ordering``'s key scheme
    (packed or two passes, per ``cfg.sort_mode``) with every global sort
    cut over the mesh."""
    return _edge_ordering(_mesh_gather(mesh, coo.dst), coo,
                          cfg or EngineConfig())


def shard_convert(mesh, coo: COO, cfg: EngineConfig | None = None) -> CSC:
    """Sharded graph conversion, Ordering then Reshaping over the dp
    ranks; the COO (whole, on every rank) on the mesh's device type. The
    whole CSC on every rank, equal to ``pipeline.convert``'s."""
    return _convert(_mesh_gather(mesh, coo.dst), coo, cfg or EngineConfig())


def shard_convert_ranks(coo: COO, cfg: EngineConfig | None = None,
                        world: int = 2) -> CSC:
    """``shard_convert`` at a world of ``world`` ranks run in this
    process: each rank's share in turn, the all-gathers concatenations
    (the fallbacks are the mesh's)."""
    return _convert(_Gather(world), coo, cfg or EngineConfig())


def shard_preprocess(mesh, coo: COO, batch_nodes, fanouts: tuple[int, ...],
                     key, cfg: EngineConfig | None = None) -> Subgraph:
    """The whole workflow with conversion cut over the mesh, then
    ``pipeline.sample_subgraph`` on the whole CSC with the same key: equal
    to ``pipeline.preprocess(coo, batch_nodes, fanouts, key, cfg)`` bit
    for bit. Falls back to that pipeline where the mesh cannot cut the
    buffer."""
    cfg = cfg or EngineConfig()
    _, nd = _dp(mesh)
    if nd <= 1 or coo.capacity % nd:
        return pipeline.preprocess(coo, batch_nodes, tuple(fanouts), key,
                                   cfg, device=coo.device)
    csc = shard_convert(mesh, coo, cfg)
    seeds = torch.as_tensor(batch_nodes, dtype=torch.int32).to(coo.device)
    return pipeline.sample_subgraph(csc, seeds, tuple(fanouts), key, cfg)


@lru_cache(maxsize=None)
def jit_shard_preprocess(mesh):
    """The mesh's entry point for ``shard_preprocess``, one callable a
    mesh for the process's lifetime (the sharded counterpart of the
    service's dispatch table): ``fn(coo, batch_nodes, fanouts, key,
    cfg)``."""
    return partial(shard_preprocess, mesh)
