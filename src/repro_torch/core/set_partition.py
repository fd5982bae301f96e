"""Set-partitioning — the UPE primitive (port of
``repro/core/set_partition.py``).

A stable digit pass is a multi-way set-partition: per-bucket inclusive
prefix sums give each element its rank inside its bucket, and the
relocation is a gather by the inverse permutation. ``tiled_digit_sources``
splits one pass over a large array into per-tile partitions plus rank
arithmetic over small [T, B] histogram tables — the merge-free
``global_radix`` Ordering and the plain twin of the digit-pass kernels.
"""
from __future__ import annotations

import torch

from .graph import take


def prefix_sum(x: torch.Tensor, axis: int = 0,
               exclusive: bool = False) -> torch.Tensor:
    """Inclusive (or exclusive) prefix sum along ``axis``, dtype kept."""
    incl = torch.cumsum(x, dim=axis, dtype=x.dtype)
    return incl - x if exclusive else incl


def displacement(cond: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum of a boolean condition (int32): the number of
    selected elements strictly left of each position, the paper's
    "displacement array"."""
    return prefix_sum(cond.to(torch.int32), exclusive=True)


def partition_indices(cond: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Destination of every element under a stable two-way partition
    (selected ones first, in order, then the rest, in order), and the
    selected count: (dest [N] int32, n_selected 0-d int32)."""
    c = cond.to(torch.int32)
    left = prefix_sum(c, exclusive=True)  # rank among the selected
    right = prefix_sum(1 - c, exclusive=True)  # rank among the rest
    n_sel = c.sum(dtype=torch.int32)
    return torch.where(cond.to(torch.bool), left, n_sel + right), n_sel


def gather_sources_from_counts(incl_counts: torch.Tensor,
                               base: torch.Tensor) -> torch.Tensor:
    """Inverse-permutation router: source index of every output slot.

    ``incl_counts`` [..., N, B] inclusive per-bucket prefix sums, ``base``
    [..., B] exclusive bucket starts (leading axes are independent
    partitions). Slot j belongs to the last bucket whose base is ≤ j, at
    local rank r = j - base[b]; its source is the first i with
    ``incl_counts[i, b] == r + 1`` (log₂ N bisection rounds per slot).
    """
    *lead, n, nb = incl_counts.shape
    dev = incl_counts.device
    j = torch.arange(n, dtype=torch.int32, device=dev)
    b = (base[..., None, :] <= j[:, None]).sum(-1, dtype=torch.int32) - 1
    target = j - base.gather(-1, b.to(torch.int64)) + 1
    flat = incl_counts.reshape(*lead, n * nb)
    lo = torch.zeros(b.shape, dtype=torch.int32, device=dev)
    hi = torch.full(b.shape, n, dtype=torch.int32, device=dev)
    for _ in range(max(1, int(n).bit_length())):
        mid = (lo + hi) >> 1
        pivot = flat.gather(-1, (torch.clamp(mid, 0, n - 1) * nb
                                 + b).to(torch.int64))
        go_right = pivot < target
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return lo


def set_partition(values: torch.Tensor, cond: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable two-way partition of ``values`` ([N] or [N, k]; rows move
    together) by ``cond``: the selected rows first, in order, then the
    rest. Returns (partitioned, n_selected as a 0-d int32), relocated by
    the gather router."""
    c = cond.to(torch.int32)
    incl = torch.stack([prefix_sum(c), prefix_sum(1 - c)], dim=1)  # [N, 2]
    n_sel = incl[-1, 0]
    base = torch.stack([torch.zeros_like(n_sel), n_sel])
    src = gather_sources_from_counts(incl, base)
    return take(values, src), n_sel


def digit_relocation_sources(digit: torch.Tensor, n_buckets: int
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sources, bucket bases) for one stable digit pass over ``digit``."""
    onehot = (digit[:, None] == torch.arange(
        n_buckets, dtype=digit.dtype, device=digit.device)[None, :])
    incl = prefix_sum(onehot.to(torch.int32), axis=0)  # [N, B]
    counts = incl[-1]
    base = prefix_sum(counts) - counts
    return gather_sources_from_counts(incl, base), base


def radix_partition(values: torch.Tensor, keys: torch.Tensor,
                    n_buckets: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Multi-way stable partition of ``values`` ([N] or [N, k]) by small
    integer ``keys`` in [0, n_buckets): one LSD digit pass. Returns the
    partitioned values and the buckets' start offsets [n_buckets]."""
    src, base = digit_relocation_sources(keys, n_buckets)
    return take(values, src), base


def partition_tiles(digit: torch.Tensor, n_buckets: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tile stable partition of ``digit`` [T, tile] by bucket.

    Returns (local_src [T, tile], lbase [T, B]): ``local_src[t, s]`` is the
    in-tile position of the element landing in slot s, which is what
    ``digit_relocation_sources`` gives per tile (the inverse of the unique
    stable-partition permutation). Gather-only, as the reference relocates:
    slot s of bucket b at rank r holds the first position whose inclusive
    count of b reaches r + 1, found by one search a slot in the tile's
    counts laid out bucket-major, ``b · (tile + 1) + count`` (ascending;
    the counts scanned along the last axis, which the card scans in
    parallel), its bucket by one search a slot in ``lbase``.
    """
    t, tile = digit.shape
    dev = digit.device
    buckets = torch.arange(n_buckets, dtype=torch.int32, device=dev)
    keys = torch.cumsum(digit[:, None, :] == buckets[:, None], dim=2,
                        dtype=torch.int32)  # [T, B, tile]
    counts = keys[:, :, -1]
    lbase = torch.cumsum(counts, dim=1, dtype=torch.int32) - counts
    keys += (buckets * (tile + 1))[:, None]
    slot = torch.arange(tile, dtype=torch.int32, device=dev).expand(t, tile)
    b = torch.searchsorted(lbase, slot.contiguous(), right=True,
                           out_int32=True) - 1
    rank = slot - lbase.gather(1, b.to(torch.int64))
    at = torch.searchsorted(keys.view(t, n_buckets * tile),
                            b * (tile + 1) + rank + 1)
    return (at - b.to(torch.int64) * tile).to(torch.int32), lbase


def tiled_digit_sources(digit: torch.Tensor, n_buckets: int,
                        tile: int) -> torch.Tensor:
    """Global one-digit-pass relocation sources via two-level rank
    arithmetic: in-tile partitions plus the [T, B] histogram tables.

    Output slot j of the stable pass lies in bucket b (last bucket with
    global base ≤ j) at rank r = j - gbase[b]; its tile is the first t with
    inclusive-over-tiles count ≥ r + 1, and its source is that tile's
    in-tile permutation at ``lbase[t, b] + r - excl[t, b]``.
    """
    n = digit.shape[0]
    if tile >= n:
        return digit_relocation_sources(digit, n_buckets)[0]
    assert n % tile == 0, (n, tile)
    local_src, lbase = partition_tiles(digit.reshape(-1, tile), n_buckets)
    hist = torch.diff(lbase, dim=1, append=torch.full(
        (lbase.shape[0], 1), tile, dtype=torch.int32, device=digit.device))
    incl_t = prefix_sum(hist, axis=0)
    excl_t = incl_t - hist
    counts = incl_t[-1]
    gbase = prefix_sum(counts) - counts
    part_src = rank_gather_sources(gbase, incl_t, excl_t, lbase, tile)
    t = part_src // tile
    return t * tile + take(local_src.reshape(-1), part_src)


def rank_gather_sources(gbase: torch.Tensor, incl_t: torch.Tensor,
                        excl_t: torch.Tensor, lbase: torch.Tensor,
                        tile: int, j: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Output slot → source in the tile-partitioned layout (every slot
    independent: log₂ T bisection rounds over the [T, B] tables).
    ``j=None`` = all slots."""
    n_tiles, nb = incl_t.shape
    dev = incl_t.device
    if j is None:
        j = torch.arange(n_tiles * tile, dtype=torch.int32, device=dev)
    b = (gbase[None, :] <= j[:, None]).sum(1, dtype=torch.int32) - 1
    r = j - take(gbase, b)
    target = r + 1
    flat_incl = incl_t.reshape(-1)
    lo = torch.zeros(j.shape, dtype=torch.int32, device=dev)
    hi = torch.full(j.shape, n_tiles, dtype=torch.int32, device=dev)
    for _ in range(max(1, int(n_tiles).bit_length())):
        mid = (lo + hi) >> 1
        pivot = take(flat_incl, torch.clamp(mid, 0, n_tiles - 1) * nb + b)
        go_right = pivot < target
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    t = lo
    r_in_tile = r - take(excl_t.reshape(-1), t * nb + b)
    return t * tile + take(lbase.reshape(-1), t * nb + b) + r_in_tile


def radix_sort_by_key(values: torch.Tensor, keys: torch.Tensor,
                      key_bits: int, radix_bits: int = 4
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable LSD radix sort of (keys, values) along the last axis:
    ``ceil(key_bits / radix_bits)`` digit passes, each a stable
    set-partition of every row (``partition_tiles``) and one gather of
    keys and values by its source permutation. A ``[C, chunk]`` view sorts
    every chunk at once — the plain twin of the chunk-sort kernel."""
    n_buckets = 1 << radix_bits
    n_passes = max(1, -(-key_bits // radix_bits))
    shape = keys.shape
    k = keys.reshape(-1, shape[-1])
    v = values.reshape(-1, shape[-1])
    for p in range(n_passes):
        digit = (k >> (p * radix_bits)) & (n_buckets - 1)
        src = partition_tiles(digit, n_buckets)[0].to(torch.int64)
        k, v = k.gather(1, src), v.gather(1, src)
    return k.reshape(shape), v.reshape(shape)


def radix_sort_keys(keys: torch.Tensor, key_bits: int,
                    radix_bits: int = 4) -> torch.Tensor:
    """Keys-only ``radix_sort_by_key``: no payload gather per pass."""
    n_buckets = 1 << radix_bits
    n_passes = max(1, -(-key_bits // radix_bits))
    shape = keys.shape
    k = keys.reshape(-1, shape[-1])
    for p in range(n_passes):
        digit = (k >> (p * radix_bits)) & (n_buckets - 1)
        k = k.gather(1, partition_tiles(digit, n_buckets)[0].to(torch.int64))
    return k.reshape(shape)
