"""Subgraph Reindexing (port of ``repro/core/reindexing.py``).

Map sampled original VIDs to compact new VIDs without a hash map:

1. One shared sort of the collected VID list — the packed key
   ``(vid << pos_bits) | pos`` when it fits one int32 (the position makes
   any sort stable and carries the payload), else a pair sort with the
   position as payload.
2. Rank arithmetic instead of a second sort: a left rank of every original
   element lands on its run head, whose carried position is the first
   occurrence; a prefix sum over the first-occurrence flags numbers the
   runs, and one more rank search over that monotone sum compacts
   ``order``.
3. Lookups are a left rank into the sorted stream plus one gather from the
   slot → new-VID table.

New VIDs follow first-occurrence order (or sorted order on request).
"""
from __future__ import annotations

import numpy as np
import torch

from .graph import COO, SENTINEL, next_pow2, take
from .ordering import _bits_for, stable_sort_by_key
from .set_count import rank_in_sorted
from .set_partition import prefix_sum


def _pos_bits(capacity: int) -> int:
    return max(1, int(capacity - 1).bit_length()) if capacity > 1 else 1


def reindex_supports_packed(vid_bound: int, capacity: int) -> bool:
    """True when (vid, position) pairs fit one non-negative int32 key."""
    return _bits_for(vid_bound) + _pos_bits(capacity) <= 31


class ReindexMap:
    """Static-shape reindex mapping (all padded to the VID-list length):
    ``sorted_vids`` the full sorted stream (duplicates, SENTINEL tail),
    ``slot_to_new`` the new VID of each run-head slot, ``order`` the
    original VID of each new VID, ``n_unique`` the valid count."""

    def __init__(self, sorted_vids, slot_to_new, order, n_unique,
                 unroll: bool = False, rank_fn=None, rename_fn=None):
        self.sorted_vids = sorted_vids
        self.slot_to_new = slot_to_new
        self.order = order
        self.n_unique = n_unique
        self.unroll = unroll
        self.rank_fn = rank_fn
        self.rename_fn = rename_fn

    def lookup(self, vids: torch.Tensor) -> torch.Tensor:
        """Original VIDs → new VIDs (SENTINEL where not in the map)."""
        if self.rename_fn is not None:
            return self.rename_fn(self.sorted_vids, self.slot_to_new, vids)
        if self.rank_fn is not None:
            rank = self.rank_fn(self.sorted_vids, vids, "left")
        else:
            rank = rank_in_sorted(self.sorted_vids, vids, side="left",
                                  unroll=self.unroll)
        rank_c = torch.clamp(rank, 0, self.sorted_vids.shape[0] - 1)
        hit = take(self.sorted_vids, rank_c) == vids
        new = take(self.slot_to_new, rank_c)
        return torch.where(hit & (vids != SENTINEL), new,
                           torch.full_like(new, SENTINEL))


def _sort_vid_stream(vids: torch.Tensor, vid_bound: int | None, sort_fn
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The one shared sort → (sorted vids, their original positions)."""
    n = vids.shape[0]
    m = next_pow2(n)  # the sorter's tile machinery wants pow2
    dev = vids.device
    vp = torch.cat([vids, torch.full((m - n,), SENTINEL, dtype=torch.int32,
                                     device=dev)])
    pos = torch.arange(m, dtype=torch.int32, device=dev)
    bound = SENTINEL if vid_bound is None else int(vid_bound)
    if vid_bound is not None and reindex_supports_packed(bound, m):
        pb = _pos_bits(m)
        packed = (torch.clamp(vp, max=bound) << pb) | pos
        pk, _ = sort_fn(packed, None, bound << pb)
        valid = pk != SENTINEL
        sv = torch.where(valid, pk >> pb, torch.full_like(pk, SENTINEL))
        sp = torch.where(valid, pk & ((1 << pb) - 1),
                         torch.full_like(pk, n - 1))
    else:
        # pair mode: sort by vid with the position riding as payload
        sv, sp = sort_fn(vp, pos, bound)
        sp = torch.where(sv != SENTINEL, sp, torch.full_like(sp, n - 1))
    return sv[:n], sp[:n]


def build_reindex_map(vids: torch.Tensor, numbering: str = "first_occurrence",
                      vid_bound: int | None = None,
                      strategy: str = "unfused", sort_fn=None,
                      rank_fn=None, rename_fn=None) -> ReindexMap:
    """Build the mapping from a (duplicated, SENTINEL-padded) VID list.

    ``vid_bound`` (the graph's node count) enables the packed shared sort;
    ``strategy`` is "fused" (unrolled rank rounds) or "unfused";
    ``sort_fn`` overrides the shared sorter; ``rank_fn`` / ``rename_fn``
    swap in the rank-epilogue kernels.
    """
    if numbering not in ("first_occurrence", "sorted"):
        raise ValueError(numbering)
    if strategy not in ("fused", "unfused"):
        raise ValueError(strategy)
    unroll = strategy == "fused"
    if sort_fn is None:
        def sort_fn(k, v, bound):
            return stable_sort_by_key(k, v, bound, strategy="xla_sort")

    def rank(arr, q, side="left"):
        if rank_fn is not None:
            return rank_fn(arr, q, side)
        return rank_in_sorted(arr, q, side=side, unroll=unroll)

    n = vids.shape[0]
    dev = vids.device
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    sen = torch.full((n,), SENTINEL, dtype=torch.int32, device=dev)
    sv, sp = _sort_vid_stream(vids, vid_bound, sort_fn)
    if numbering == "first_occurrence":
        i0c = torch.clamp(rank(sv, vids), 0, n - 1)
        hit = (take(sv, i0c) == vids) & (vids != SENTINEL)
        occ_first = hit & (take(sp, i0c) == pos)
        cum = prefix_sum(occ_first.to(torch.int32))  # inclusive
        n_unique = cum[-1]
        slot_to_new = take(cum, sp) - 1
        src = rank(cum, pos + 1)
        order = torch.where(pos < n_unique, take(vids, src), sen)
    else:  # "sorted": new VID = rank among sorted uniques
        is_head = (sv != SENTINEL) & torch.cat(
            [torch.ones(1, dtype=torch.bool, device=dev), sv[1:] != sv[:-1]])
        headcnt = prefix_sum(is_head.to(torch.int32))
        n_unique = headcnt[-1]
        slot_to_new = headcnt - 1
        src = rank(headcnt, pos + 1)
        order = torch.where(pos < n_unique, take(sv, src), sen)
    return ReindexMap(sv, slot_to_new, order, n_unique, unroll=unroll,
                      rank_fn=rank_fn, rename_fn=rename_fn)


def reindex_edges(rmap: ReindexMap, edge_dst: torch.Tensor,
                  edge_src: torch.Tensor, n_nodes_cap: int) -> COO:
    """Renumber edge endpoints through one lookup of the concatenated
    columns; an edge with an unmapped endpoint becomes SENTINEL."""
    e = edge_dst.shape[0]
    both = rmap.lookup(torch.cat([edge_dst, edge_src]))
    nd, ns = both[:e], both[e:]
    bad = (nd == SENTINEL) | (ns == SENTINEL)
    sen = torch.full_like(nd, SENTINEL)
    nd = torch.where(bad, sen, nd)
    ns = torch.where(bad, sen, ns)
    n_edges = (~bad).sum(dtype=torch.int32)
    return COO(dst=nd, src=ns, n_edges=n_edges, n_nodes=n_nodes_cap)


def reindex_serial_oracle(vids) -> tuple:
    """Hash-map style sequential numbering (the tests' oracle)."""
    seen: dict[int, int] = {}
    order = []
    # repro: allow-host-numpy-in-jit — the tests' serial oracle runs on
    # the host by design
    for v in np.asarray(vids):
        v = int(v)
        if v == SENTINEL:
            continue
        if v not in seen:
            # repro: allow-scatter-write — a host dict (the oracle)
            seen[v] = len(order)
            order.append(v)
    return seen, order
