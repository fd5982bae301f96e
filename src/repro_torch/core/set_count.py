"""Set-counting (port of ``repro/core/set_count.py``).

``count_less_than`` and ``count_equal`` are the SCR comparator array +
adder tree: a blocked all-pairs compare-reduce, correct on unsorted input.
``rank_in_sorted`` is the batched rank search over a sorted stream: every
query is independent, log₂(n) rounds of one compare against a gathered
pivot; ``rank_in_sorted2`` the same over lexicographic (a, b) pairs. Both
lowerings of the reference are kept, and both land on the exact
searchsorted rank, so they are bit-identical.
"""
from __future__ import annotations

import torch

from .graph import pad_to, take

INT32_MIN = -(1 << 31)
FILTER_BLOCK = 2048  # the reference's block, and csrc/set_count.cu kTile


def count_less_than(elements: torch.Tensor, targets: torch.Tensor,
                    block: int = 2048) -> torch.Tensor:
    """counts[t] = |{x in elements : x < targets[t]}| (int32) by blocked
    compare-reduce: a [T, block] comparator tile per element block, summed
    along the block. The input need not be sorted; on sorted input this is
    ``searchsorted(side="left")``."""
    counts = torch.zeros(targets.shape, dtype=torch.int32,
                         device=targets.device)
    for lo in range(0, elements.shape[0], block):
        chunk = elements[lo:lo + block]
        counts += (chunk[None, :] < targets[:, None]).sum(1, dtype=torch.int32)
    return counts


def count_equal(values: torch.Tensor, targets: torch.Tensor,
                block: int = 2048) -> torch.Tensor:
    """counts[t] = |{x in values : x == targets[t]}| (int32), the SCR with
    equality comparators, by blocks of ``block`` elements; the last block
    pads with INT32_MIN as the reference pads it (a target equal to
    INT32_MIN counts those pads too)."""
    e = values.shape[0]
    xs = pad_to(values, e + (-e) % block, INT32_MIN).reshape(-1, block)
    counts = torch.zeros(targets.shape, dtype=torch.int32,
                         device=targets.device)
    for chunk in xs:
        counts += (chunk[None, :] == targets[:, None]).sum(1,
                                                           dtype=torch.int32)
    return counts


def rank_in_sorted(sorted_arr: torch.Tensor, queries: torch.Tensor,
                   side: str = "left", unroll: bool = False) -> torch.Tensor:
    """rank[t] = searchsorted(sorted_arr, queries[t], side) as int32.

    ``unroll=True`` is the reference's single-carry binary lifting (``pos
    += 2^s`` while the pivot still ranks below the query); ``unroll=False``
    its two-sided (lo, hi) bisection with the converged-lane freeze.
    """
    n = sorted_arr.shape[0]
    steps = max(1, int(n).bit_length())  # search range is n+1 wide
    if unroll:
        pos = torch.zeros(queries.shape, dtype=torch.int32,
                          device=queries.device)
        for s in reversed(range(steps)):
            cand = pos + (1 << s)
            pivot = take(sorted_arr, torch.clamp(cand - 1, max=n - 1))
            ok = (pivot < queries) if side == "left" else (pivot <= queries)
            pos = torch.where(ok & (cand <= n), cand, pos)
        return pos
    lo = torch.zeros(queries.shape, dtype=torch.int32, device=queries.device)
    hi = torch.full(queries.shape, n, dtype=torch.int32,
                    device=queries.device)
    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) >> 1
        pivot = take(sorted_arr, mid)
        go_right = (pivot < queries) if side == "left" else (pivot <= queries)
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def searchsorted_oracle(sorted_arr: torch.Tensor, targets: torch.Tensor,
                        side: str = "left") -> torch.Tensor:
    """The library's binary search, the oracle the tests hold the
    compare-reduce paths against (int32)."""
    return torch.searchsorted(sorted_arr, targets,
                              right=side == "right").to(torch.int32)


def rank_in_sorted2(sorted_a: torch.Tensor, sorted_b: torch.Tensor,
                    query_a: torch.Tensor, query_b: torch.Tensor,
                    side: str = "left", unroll: bool = False) -> torch.Tensor:
    """``rank_in_sorted`` over lexicographic (a, b) pairs: the rank of each
    query pair in the pair-sorted columns ``(sorted_a, sorted_b)`` (int32),
    for VID spaces too wide to pack (dst, src) into one int32 key. Each
    round compares the query against one gathered pivot pair; ``unroll``
    and the bisection's converged-lane freeze as in ``rank_in_sorted``."""
    n = sorted_a.shape[0]
    steps = max(1, int(n).bit_length())

    def below(i):  # pivot pair i orders before the query (left side)
        pa, pb = take(sorted_a, i), take(sorted_b, i)
        lt_b = (pb < query_b) if side == "left" else (pb <= query_b)
        return (pa < query_a) | ((pa == query_a) & lt_b)

    if unroll:
        pos = torch.zeros(query_a.shape, dtype=torch.int32,
                          device=query_a.device)
        for s in reversed(range(steps)):
            cand = pos + (1 << s)
            ok = below(torch.clamp(cand - 1, max=n - 1))
            pos = torch.where(ok & (cand <= n), cand, pos)
        return pos
    lo = torch.zeros(query_a.shape, dtype=torch.int32, device=query_a.device)
    hi = torch.full(query_a.shape, n, dtype=torch.int32,
                    device=query_a.device)
    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) >> 1
        go_right = below(mid)
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def filter_lookup(keys: torch.Tensor, payloads: torch.Tensor,
                  targets: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Reindexer's filter (OR) tree: each target's payload.

    Returns (payload or -1 [T] int32, hit [T] bool). Keys are unique (the
    mapping table keyed by original VID). Per block of FILTER_BLOCK keys a
    [T, block] equality comparator tile encodes ``payload + 1`` where it
    fires and 0 elsewhere, reduced by max (at most one comparator fires per
    target, so max is the OR tree). Keys pad with INT32_MIN, payloads with
    0, as in the reference (the filter kernel pads its last tile alike).
    """
    e = keys.shape[0]
    size = e + (-e) % FILTER_BLOCK
    ks = pad_to(keys, size, INT32_MIN).reshape(-1, FILTER_BLOCK)
    ps = pad_to(payloads, size, 0).reshape(-1, FILTER_BLOCK)
    enc = torch.zeros(targets.shape, dtype=torch.int32, device=targets.device)
    for k, p in zip(ks, ps):
        hit = k[None, :] == targets[:, None]  # [T, block]
        enc = torch.maximum(enc, torch.where(hit, p[None, :] + 1,
                                             0).amax(dim=1))
    hit = enc > 0
    return torch.where(hit, enc - 1, -1), hit
