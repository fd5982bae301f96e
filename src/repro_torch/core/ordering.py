"""Edge Ordering (port of ``repro/core/ordering.py``, global_radix and
xla_sort strategies).

Sort the COO edge array by (dst, src), either as one packed int32 key
``(dst << src_bits) | src`` when ``2 · bits(n_nodes) ≤ 31`` or as two stable
passes (by src, then by dst). Both give the same output. Every global sort
runs under a strategy:

* ``"global_radix"`` — merge-free LSD radix sort: each digit pass
  stable-partitions the whole array through the tiled two-level router
  (``set_partition.tiled_digit_sources``), or through the digit-pass
  kernels when ``digit_pass_fn`` is given (``EngineConfig.use_pallas``).
* ``"xla_sort"`` — the platform's native sort, here ``torch.sort``.
* ``"chunked_merge"`` — not ported yet; it raises.

Sentinel handling: keys are clipped to ``key_bound`` (one past any valid
key) before sorting so the radix width stays ``bits(key_bound)``, and
restored to SENTINEL afterwards.
"""
from __future__ import annotations

import torch

from .graph import COO, SENTINEL, take
from .set_partition import tiled_digit_sources

# The chunk-width default (``EngineConfig.w_upe``), also the global-radix
# histogram tile.
DEFAULT_CHUNK = 4096

CHUNKED_MERGE_TODO = (
    "sort_strategy 'chunked_merge' is not ported yet: it needs the "
    "radix_sort_chunks and fused_merge_rounds kernels (repro/kernels/"
    "radix_sort.py, repro/kernels/merge.py), the next slice of the port; "
    "use sort_strategy='global_radix' or 'xla_sort'")


def _bits_for(n: int) -> int:
    return max(1, int(n).bit_length())


def supports_packed_keys(n_nodes: int) -> bool:
    """True when (dst, src) pairs fit one non-negative int32 packed key."""
    return 2 * _bits_for(n_nodes) <= 31


def merge_round_fan_ins(n: int, run: int, fan_in: int = 2) -> list[int]:
    """Per-round fan-ins of the chunked_merge ladder for ``n`` elements in
    sorted runs of ``run`` (the cost model prices its length)."""
    out = []
    while run < n:
        count = n // run
        if count < 2:
            break
        k = min(max(2, fan_in), count)
        while count % k and k > 2:
            k -= 1
        if count % k:
            k = next(d for d in range(2, count + 1) if count % d == 0)
        out.append(k)
        run *= k
    return out


def _global_radix_passes(keys, vals, key_bits: int, tile: int,
                         radix_bits: int, digit_pass_fn=None):
    """The merge-free digit-pass loop; ``digit_pass_fn(keys, vals, shift)``
    swaps in the digit-pass kernels."""
    n_buckets = 1 << radix_bits
    n_passes = max(1, -(-key_bits // radix_bits))
    for p in range(n_passes):
        shift = p * radix_bits
        if digit_pass_fn is not None:
            keys, vals = digit_pass_fn(keys, vals, shift)
            continue
        src = tiled_digit_sources((keys >> shift) & (n_buckets - 1),
                                  n_buckets, tile)
        keys = take(keys, src)
        if vals is not None:
            vals = take(vals, src)
    return keys, vals


def _restore_sentinels(ks: torch.Tensor, key_bound: int) -> torch.Tensor:
    return torch.where(ks >= key_bound, torch.full_like(ks, SENTINEL), ks)


def global_radix_sort_by_key(keys: torch.Tensor, vals: torch.Tensor | None,
                             key_bound: int, tile: int | None = None,
                             radix_bits: int = 4, digit_pass_fn=None):
    """Global stable LSD radix sort with zero merge rounds."""
    n = keys.shape[0]
    tile = min(DEFAULT_CHUNK if tile is None else tile, n)
    clipped = torch.clamp(keys, max=key_bound)
    ks, vs = _global_radix_passes(clipped, vals, _bits_for(key_bound), tile,
                                  radix_bits, digit_pass_fn=digit_pass_fn)
    return _restore_sentinels(ks, key_bound), vs


def xla_stable_sort_by_key(keys: torch.Tensor, vals: torch.Tensor | None,
                           key_bound: int):
    """The native-sort strategy: one stable ``torch.sort``, same
    clip/restore sentinel contract, keys-only when ``vals is None``."""
    clipped = torch.clamp(keys, max=key_bound)
    if vals is None:
        ks, vs = torch.sort(clipped).values, None
    else:
        ks, order = torch.sort(clipped, stable=True)
        vs = vals[order]
    return _restore_sentinels(ks, key_bound), vs


def stable_sort_by_key(keys: torch.Tensor, vals: torch.Tensor | None,
                       key_bound: int, chunk: int | None = None,
                       radix_bits: int = 4, strategy: str = "global_radix",
                       digit_pass_fn=None):
    """Global stable sort under a ``strategy``; ``key_bound`` is the
    exclusive bound of valid keys, ``chunk`` the global-radix tile."""
    n = keys.shape[0]
    chunk = min(DEFAULT_CHUNK if chunk is None else chunk, n)
    if strategy == "global_radix":
        return global_radix_sort_by_key(keys, vals, key_bound, tile=chunk,
                                        radix_bits=radix_bits,
                                        digit_pass_fn=digit_pass_fn)
    if strategy == "xla_sort":
        return xla_stable_sort_by_key(keys, vals, key_bound)
    if strategy == "chunked_merge":
        raise NotImplementedError(CHUNKED_MERGE_TODO)
    raise ValueError(f"unknown sort strategy {strategy!r}")


def edge_ordering(coo: COO, chunk: int | None = None, radix_bits: int = 4,
                  sort_fn=None, mode: str = "auto", keys_only: bool = True,
                  strategy: str = "global_radix", digit_pass_fn=None) -> COO:
    """Sort edges by (dst, src) — packed single pass or two-pass LSD.

    ``sort_fn(keys, vals, key_bound) -> (keys, vals)`` overrides the global
    stable sorter. ``keys_only`` (packed mode): sort the packed key with no
    payload; False carries the edge id along (same output).
    """
    if sort_fn is None:
        def sort_fn(k, v, bound):
            return stable_sort_by_key(k, v, bound, chunk=chunk,
                                      radix_bits=radix_bits,
                                      strategy=strategy,
                                      digit_pass_fn=digit_pass_fn)
    bound = coo.n_nodes
    if mode == "auto":
        mode = "packed" if supports_packed_keys(bound) else "two_pass"
    sen = torch.full_like(coo.dst, SENTINEL)
    if mode == "packed":
        if not supports_packed_keys(bound):
            raise ValueError(
                f"packed-key ordering needs 2*bits(n_nodes) <= 31; "
                f"n_nodes={bound} does not fit — use mode='two_pass'")
        bits = _bits_for(bound)
        d = torch.clamp(coo.dst, max=bound)
        s = torch.clamp(coo.src, max=bound)
        packed = (d << bits) | s
        payload = None if keys_only else torch.arange(
            coo.capacity, dtype=torch.int32, device=coo.device)
        pk, _ = sort_fn(packed, payload, (bound << bits) | bound)
        sent = pk == SENTINEL
        dst2 = torch.where(sent, sen, pk >> bits)
        src2 = torch.where(sent, sen, pk & ((1 << bits) - 1))
        dst2 = torch.where(dst2 >= bound, sen, dst2)
        src2 = torch.where((src2 >= bound) | (dst2 == SENTINEL), sen, src2)
        return COO(dst=dst2, src=src2, n_edges=coo.n_edges,
                   n_nodes=coo.n_nodes)
    if mode != "two_pass":
        raise ValueError(f"unknown ordering mode {mode!r}")
    # pass 1 by src (secondary key), pass 2 by dst; stability keeps src order
    src1, dst1 = sort_fn(coo.src, coo.dst, bound)
    dst2, src2 = sort_fn(dst1, src1, bound)
    src2 = torch.where(dst2 == SENTINEL, sen, src2)
    return COO(dst=dst2, src=src2, n_edges=coo.n_edges, n_nodes=coo.n_nodes)
