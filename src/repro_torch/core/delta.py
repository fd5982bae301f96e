"""Incremental conversion: delta-merge CSC updates at cost O(delta) (port
of ``repro/core/delta.py``).

The sorted CSC is a sorted (dst, src) stream plus a rank-arithmetic
pointer table, so an insert/delete batch splices in positionally. Every
search runs over the delta-sized streams or with delta-many queries; the
existing edge array is never re-sorted, only streamed once at the end:

1. one **delta sort** of each stream (packed ``(dst << bits) | src`` keys
   when the VID space fits int32, the two-pass pair scheme otherwise);
2. **delete resolution**: each delete kills at most one matching existing
   edge (multiset semantics; misses are no-ops). Its victim's slot is a
   two-level row search (``ptr`` bounds the dst row, a bounded rank over
   ``idx`` the src run) plus the delete's occurrence index inside its run
   of equal keys; the tombstone positions are compacted by
   ``set_partition``;
3. **one merge rung**: a delta-sized sort zips insert slots and delete
   activation points into one sorted event table of 2·|delta| entries;
4. **splice and pointer patch**: one rank of every output position over
   the event table routes each slot to its source (a surviving ``idx``
   entry or a sorted insert), and ``ptr'[v] = ptr[v] + |inserts < v| -
   |effective deletes < v|``.

Deletes apply to the pre-update edge set. The result is bit-identical to
a from-scratch ``pipeline.convert`` of the final edge list. The rank
passes take the rank-search kernel (``rank_fn``) where they are lowered
fused, the one merge rung the merge-rung kernel (``rung_fn``), and the
delta sorts go through ``sort_fn``, which ``pipeline.apply_delta`` routes
like any Ordering.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .graph import COO, CSC, SENTINEL, next_pow2, pad_to, resolve_device, take
from .ordering import _bits_for, supports_packed_keys
from .set_count import rank_in_sorted
from .set_partition import prefix_sum, set_partition

# Rank passes whose fused/unfused lowering the epilogue strategy controls:
# the splice's event rank and the two pointer corrections (the cost model's
# delta terms price this constant).
DELTA_RANK_PASSES = 3

# Even event-table pad: sorts after every real event key (insert events are
# odd ``2*slot + 1``, delete events even ``2*slot``) and never equals an
# insert key.
_EVENT_PAD = 0x7FFFFFFE


@dataclasses.dataclass
class EdgeDelta:
    """One batched graph update: edge inserts and deletes, SENTINEL-padded
    to one pow2 ``capacity`` (the delta bucket). ``n_ins`` / ``n_del``
    (0-d int32) count the valid leading entries."""

    ins_dst: torch.Tensor  # int32 [D_cap]
    ins_src: torch.Tensor  # int32 [D_cap]
    del_dst: torch.Tensor  # int32 [D_cap]
    del_src: torch.Tensor  # int32 [D_cap]
    n_ins: torch.Tensor  # int32 scalar
    n_del: torch.Tensor  # int32 scalar
    n_nodes: int

    @property
    def capacity(self) -> int:
        return self.ins_dst.shape[0]

    @property
    def device(self) -> torch.device:
        return self.ins_dst.device

    def to(self, device) -> "EdgeDelta":
        return EdgeDelta(*(t.to(device) for t in (
            self.ins_dst, self.ins_src, self.del_dst, self.del_src,
            self.n_ins, self.n_del)), n_nodes=self.n_nodes)

    @staticmethod
    def from_arrays(ins_dst, ins_src, del_dst, del_src, n_nodes: int,
                    capacity: int | None = None,
                    device="cuda") -> "EdgeDelta":
        dev = resolve_device(device)

        def col(a):
            return torch.as_tensor(np.asarray(a, np.int32).reshape(-1),
                                   dtype=torch.int32).to(dev)

        ins_dst, ins_src = col(ins_dst), col(ins_src)
        del_dst, del_src = col(del_dst), col(del_src)
        n_ins, n_del = ins_dst.shape[0], del_dst.shape[0]
        cap = capacity or next_pow2(max(1, n_ins, n_del))
        return EdgeDelta(
            ins_dst=pad_to(ins_dst, cap, SENTINEL),
            ins_src=pad_to(ins_src, cap, SENTINEL),
            del_dst=pad_to(del_dst, cap, SENTINEL),
            del_src=pad_to(del_src, cap, SENTINEL),
            n_ins=torch.tensor(n_ins, dtype=torch.int32, device=dev),
            n_del=torch.tensor(n_del, dtype=torch.int32, device=dev),
            n_nodes=n_nodes)


def _rank(sorted_arr, queries, side: str, fused: bool, rank_fn):
    """One rank pass: the rank-search kernel when it is routed and the pass
    is lowered fused, else ``rank_in_sorted`` (the same ranks)."""
    if fused and rank_fn is not None:
        return rank_fn(sorted_arr, queries, side)
    return rank_in_sorted(sorted_arr, queries, side=side, unroll=fused)


def reconstruct_sorted_dst(csc: CSC, unroll: bool = False,
                           rank_fn=None) -> torch.Tensor:
    """The sorted dst column the Reshaping consumed: slot j's dst is the
    number of pointer entries ≤ j, minus one; padded slots land at
    ``n_nodes``. Only the rebuild pays this."""
    e_cap = csc.idx.shape[0]
    j = torch.arange(e_cap, dtype=torch.int32, device=csc.idx.device)
    d = _rank(csc.ptr, j, "right", unroll, rank_fn) - 1
    return torch.clamp(d, 0, csc.n_nodes)


def _run_occurrence(is_new_run: torch.Tensor) -> torch.Tensor:
    """occ[j] = j - the start of j's run of equal keys (a cumulative max
    over the run heads' positions)."""
    j = torch.arange(is_new_run.shape[0], dtype=torch.int32,
                     device=is_new_run.device)
    head_pos = torch.where(is_new_run, j, 0)
    return j - torch.cummax(head_pos, 0).values


def _rank_in_rows(arr: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                  queries: torch.Tensor, side: str = "left") -> torch.Tensor:
    """Bounded batched binary search: query t's rank over
    ``arr[lo[t]:hi[t])`` only, as an absolute index into ``arr``
    (delta-many queries, ``bits(len(arr))`` rounds)."""
    n = arr.shape[0]
    l, h = lo, hi
    for _ in range(max(1, int(n).bit_length())):
        active = l < h
        mid = (l + h) >> 1
        pivot = take(arr, torch.clamp(mid, 0, n - 1))
        go_right = (pivot < queries) if side == "left" else \
            (pivot <= queries)
        l = torch.where(active & go_right, mid + 1, l)
        h = torch.where(active & ~go_right, mid, h)
    return l


def _sorted_delta_stream(dst, src, n_nodes: int, sort_fn):
    """Sort one (dst, src) delta stream lexicographically: one packed sort
    when the VID space fits an int32 key, the two-pass pair scheme
    otherwise. SENTINEL pads sort to the tail."""
    bound = n_nodes
    if supports_packed_keys(n_nodes):
        bits = _bits_for(bound)
        key_bound = (bound << bits) | bound
        mask = (1 << bits) - 1
        k = ((torch.clamp(dst, max=bound) << bits)
             | torch.clamp(src, max=bound))
        ks, _ = sort_fn(k, None, key_bound)  # pads restored to SENTINEL
        pad = ks == SENTINEL
        return (torch.where(pad, SENTINEL, ks >> bits),
                torch.where(pad, SENTINEL, ks & mask))
    s1, d1 = sort_fn(src, dst, bound)
    d2, s2 = sort_fn(d1, s1, bound)
    return d2, s2


def _delete_positions(csc: CSC, delta: EdgeDelta, *, sort_fn):
    """The delete stream as tombstone positions: the sorted absolute slots
    of the victims in the existing CSC (SENTINEL tail) and the effective
    delete count. A delete kills a copy only while its occurrence index
    among equal delete keys stays below the key's multiplicity."""
    n = csc.n_nodes
    d_cap = delta.capacity
    dd, ds = _sorted_delta_stream(delta.del_dst, delta.del_src, n, sort_fn)
    k = torch.arange(d_cap, dtype=torch.int32, device=dd.device)
    row = torch.clamp(dd, 0, n - 1)
    lo = take(csc.ptr, row)
    hi = take(csc.ptr, row + 1)
    rl = _rank_in_rows(csc.idx, lo, hi, ds, side="left")
    rr = _rank_in_rows(csc.idx, lo, hi, ds, side="right")
    prev_d = torch.cat([dd[:1] - 1, dd[:-1]])
    prev_s = torch.cat([ds[:1] - 1, ds[:-1]])
    occ = _run_occurrence((dd != prev_d) | (ds != prev_s))
    valid = (k < delta.n_del) & (dd < n) & (ds < n) & (occ < rr - rl)
    # rl + occ rises strictly over the valid entries, so routing the misses
    # to the tail leaves the positions sorted
    pos, _ = set_partition(torch.where(valid, rl + occ, SENTINEL), valid)
    return pos, valid.sum(dtype=torch.int32)


def delta_merge(csc: CSC, delta: EdgeDelta, *, sort_fn,
                unroll: bool = False, out_capacity: int | None = None,
                rank_fn=None, rung_fn=None) -> CSC:
    """Splice one EdgeDelta into a sorted CSC, the O(delta) update path.

    ``sort_fn(keys, vals, key_bound) -> (keys, vals)`` is the one stable
    sorter, used on delta-sized streams only (the two delta streams and
    the event-zip rung). ``unroll`` lowers the DELTA_RANK_PASSES
    full-width rank passes fused, through ``rank_fn`` (the rank-search
    kernel) where it is given. The event table is two sorted runs of
    ``capacity`` (inserts, deletes), so the zip is one fan-in-2 merge rung:
    ``rung_fn`` (the merge-rung kernel) where it is given, else a native
    sort, as the reference zips. ``out_capacity`` (default the input's edge
    capacity) sizes the output index buffer; the caller makes sure the
    surviving edges fit.

    Sorted inserts land at output slots ``outb[k] = |survivors before
    insert k| + k``; each effective delete shifts sources one slot from
    its activation point on. In the event table (inserts odd-coded,
    deletes even-coded) slot j is one left rank g of ``2j + 1``: with
    ``ci`` inserts among those g events, slot j reads ``inserts[ci]`` when
    the next event sits at j, else ``idx[j + g - 2·ci]``.
    """
    n = csc.n_nodes
    e_cap = csc.idx.shape[0]
    d_cap = delta.capacity
    out_cap = e_cap if out_capacity is None else out_capacity
    dev = csc.idx.device
    k = torch.arange(d_cap, dtype=torch.int32, device=dev)

    # deletes → sorted tombstone positions (delta-sized)
    pos, n_del_eff = _delete_positions(csc, delta, sort_fn=sort_fn)

    # inserts → output slots (delta-sized)
    bd, bs = _sorted_delta_stream(delta.ins_dst, delta.ins_src, n, sort_fn)
    valid_i = (k < delta.n_ins) & (bd < n) & (bs < n)
    pairs, _ = set_partition(torch.stack([bd, bs], dim=1), valid_i)
    n_ins_eff = valid_i.sum(dtype=torch.int32)
    live_i = k < n_ins_eff
    bd_c = torch.where(live_i, pairs[:, 0], SENTINEL)
    bs_c = torch.where(live_i, pairs[:, 1], SENTINEL)
    row = torch.clamp(bd_c, 0, n - 1)
    lo = take(csc.ptr, row)
    hi = take(csc.ptr, row + 1)
    # the right rank among all existing edges, minus the tombstones before
    # it: the survivors before
    ra = _rank_in_rows(csc.idx, lo, hi, bs_c, side="right")
    surv_before = ra - _rank(pos, ra, "left", True, rank_fn)
    outb = torch.where(live_i, surv_before + k, _EVENT_PAD >> 1)

    # deletes → activation points in output coordinates
    live_d = k < n_del_eff
    q_thresh = torch.where(live_d, pos - k, SENTINEL)  # survivor-index space
    r_tab = torch.where(live_i, surv_before, SENTINEL)  # = outb[k] - k
    c_t = _rank(r_tab, q_thresh - 1, "right", True, rank_fn)
    jdel = torch.where(live_d, q_thresh + c_t, _EVENT_PAD >> 1)

    # the one merge rung: zip the events into one sorted table
    e_ins = torch.where(live_i, (outb << 1) | 1, _EVENT_PAD)  # odd
    e_del = torch.where(live_d, jdel << 1, _EVENT_PAD)  # even
    events = torch.cat([e_ins, e_del])  # two sorted runs of d_cap
    b2 = (torch.sort(events).values if rung_fn is None
          else rung_fn(events, None, d_cap, 2)[0])
    ci_tab = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                        prefix_sum(b2 & 1)])

    # splice: one event rank a output slot, then gathers
    j = torch.arange(out_cap, dtype=torch.int32, device=dev)
    g = _rank(b2, (j << 1) | 1, "left", unroll, rank_fn)
    b2_ext = torch.cat([b2, torch.full((1,), _EVENT_PAD, dtype=torch.int32,
                                       device=dev)])
    nxt, ci = take(b2_ext, g), take(ci_tab, g)
    is_ins = nxt == ((j << 1) | 1)
    src = j + g - 2 * ci  # ci inserts pushed j back, g-ci deletes skipped
    n_edges_new = csc.n_edges + n_ins_eff - n_del_eff
    idx_new = torch.where(
        j >= n_edges_new, SENTINEL,
        torch.where(is_ins, take(bs_c, torch.clamp(ci, 0, d_cap - 1)),
                    take(csc.idx, torch.clamp(src, 0, e_cap - 1))))

    # pointer patch: delta-only rank corrections
    targets = torch.arange(n + 1, dtype=torch.int32, device=dev)
    ptr_v = take(csc.ptr, targets)
    ins_lt = _rank(bd_c, targets, "left", unroll, rank_fn)
    del_lt = _rank(pos, ptr_v, "left", unroll, rank_fn)
    ptr_new = ptr_v + ins_lt - del_lt
    pad = csc.ptr.shape[0] - (n + 1)
    if pad > 0:
        ptr_new = torch.cat([ptr_new, ptr_new[-1:].expand(pad)])
    return CSC(ptr=ptr_new, idx=idx_new, n_edges=n_edges_new, n_nodes=n)


def rebuild_coo(csc: CSC, delta: EdgeDelta, *, sort_fn,
                unroll: bool = False, rank_fn=None) -> COO:
    """The rebuild's front half: the deletes as SENTINEL tombstones, the
    inserts appended, in one pow2 COO for a full re-convert. Shares the
    delete matching with :func:`delta_merge` (``sort_fn`` sorts only the
    delete stream here)."""
    n = csc.n_nodes
    e_cap = csc.idx.shape[0]
    pos, n_del_eff = _delete_positions(csc, delta, sort_fn=sort_fn)
    d_ex = reconstruct_sorted_dst(csc, unroll=unroll, rank_fn=rank_fn)
    slot = torch.arange(e_cap, dtype=torch.int32, device=csc.idx.device)
    hit = take(pos, _rank(pos, slot, "left", True, rank_fn))
    live = (d_ex < n) & (hit != slot)
    dst_all = torch.cat([torch.where(live, d_ex, SENTINEL), delta.ins_dst])
    src_all = torch.cat([torch.where(live, csc.idx, SENTINEL),
                         delta.ins_src])
    cap = next_pow2(dst_all.shape[0])
    n_edges_new = csc.n_edges + delta.n_ins - n_del_eff
    return COO(dst=pad_to(dst_all, cap, SENTINEL),
               src=pad_to(src_all, cap, SENTINEL),
               n_edges=n_edges_new, n_nodes=n)
