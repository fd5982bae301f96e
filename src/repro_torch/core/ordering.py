"""Edge Ordering (port of ``repro/core/ordering.py``).

Sort the COO edge array by (dst, src), either as one packed int32 key
``(dst << src_bits) | src`` when ``2 · bits(n_nodes) ≤ 31`` or as two stable
passes (by src, then by dst). Both give the same output. Every global sort
runs under a strategy:

* ``"chunked_merge"`` — the UPE's splitting and merging: a stable LSD radix
  sort of every ``chunk`` block (``_chunk_sort``, or the chunk-sort kernel
  through ``chunk_sort_fn``), then a ladder of k-ary stable merge rungs
  (``merge_rounds``; the fused-merge kernel takes the first rungs through
  ``merge_fn``, the merge-rung kernel the rest through ``rung_fn``). An
  element's slot in a merged run is its own index plus its rank in every
  sibling run, earlier runs winning ties; each slot then reads its element
  by gathers (no scatter, the reference's rule).
* ``"global_radix"`` — merge-free LSD radix sort: each digit pass
  stable-partitions the whole array through the tiled two-level router
  (``set_partition.tiled_digit_sources``); ``radix_sort_fn`` takes the
  whole sort instead (``EngineConfig.use_pallas``: the card's histogram and
  scatter kernels on their own digit schedule).
* ``"xla_sort"`` — the platform's native sort, here ``torch.sort``.

All three give the same output. ``edge_ordering_xla`` is the paper's
GPU baseline: two library sorts, no hand-written kernel.

Sentinel handling: keys are clipped to ``key_bound`` (one past any valid
key) before sorting so the radix width stays ``bits(key_bound)``, and
restored to SENTINEL afterwards.
"""
from __future__ import annotations

import torch

from .graph import COO, SENTINEL, take
from .set_partition import (radix_sort_by_key, radix_sort_keys,
                            tiled_digit_sources)

# The chunk-width default (``EngineConfig.w_upe``), also the global-radix
# histogram tile.
DEFAULT_CHUNK = 4096

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


def _rank_rows(sorted_rows: torch.Tensor, queries: torch.Tensor,
               right: bool) -> torch.Tensor:
    """Row-wise searchsorted (int64): the rank of every query of a row in
    the same row of ``sorted_rows``."""
    return torch.searchsorted(sorted_rows.contiguous(), queries.contiguous(),
                              right=right)


def _slot_sources(pos: torch.Tensor, n: int):
    """The inverse-rank router of a merge (a search a slot, then gathers;
    no scatter): for every output slot j < n, with ``pos`` [..., run] the
    strictly increasing slots one run's elements land at, (j; cnt: how
    many of them land at or before j; ia: the one j would read; hit:
    whether it lands at j). Where none lands at or before j, ia is 0 and
    pos[0] > j: no hit."""
    j = torch.arange(n, device=pos.device)
    cnt = _rank_rows(pos, j.expand(pos.shape[:-1] + (n,)), True)
    ia = (cnt - 1).clamp_(min=0)
    return j, cnt, ia, pos.gather(-1, ia) == j


def merge_sorted(a_keys, a_vals, b_keys, b_vals):
    """Stable merge of two sorted runs along the last axis (any equal
    leading batch axes); A wins ties. Element i of A lands at i plus its
    rank in B; slot j reads A where one lands there, else B at j less the
    A elements before it — two gathers by the inverse permutation, as the
    reference relocates. ``a_vals``/``b_vals`` both None merges the keys
    alone."""
    la, lb = a_keys.shape[-1], b_keys.shape[-1]
    if not (la and lb):
        return ((a_keys, a_vals) if lb == 0 else (b_keys, b_vals))
    pos_a = _rank_rows(b_keys, a_keys, False).add_(
        torch.arange(la, device=a_keys.device))
    j, cnt, ia, from_a = _slot_sources(pos_a, la + lb)
    ib = torch.sub(j, cnt).clamp_(0, lb - 1)

    def place(a, b):
        return torch.where(from_a, a.gather(-1, ia), b.gather(-1, ib))

    return (place(a_keys, b_keys),
            None if a_vals is None else place(a_vals, b_vals))


def merge_sorted_k(kr: torch.Tensor, vr: torch.Tensor | None):
    """Stable k-way merge of ``k`` sorted runs — one ladder rung of fan-in
    k. ``kr`` [..., k, run] (``vr`` the same, or None); earlier runs win
    ties, so the output equals folding ``merge_sorted`` left to right. The
    slot of element i of run r is i plus its rank in every sibling run
    (right against earlier runs, left against later ones); each slot reads
    the run that lands there (``_slot_sources``: gathers, no scatter)."""
    k, run = kr.shape[-2:]
    if k == 2:  # the two-way merge needs half the searches
        return merge_sorted(kr[..., 0, :], None if vr is None else
                            vr[..., 0, :], kr[..., 1, :],
                            None if vr is None else vr[..., 1, :])
    n = k * run
    out_k = torch.zeros(kr.shape[:-2] + (n,), dtype=kr.dtype,
                        device=kr.device)
    out_v = None if vr is None else torch.zeros_like(out_k, dtype=vr.dtype)
    for r in range(k):
        p = torch.arange(run, device=kr.device)
        for s in range(k):
            if s != r:
                p = p + _rank_rows(kr[..., s, :], kr[..., r, :], s < r)
        _, _, ia, hit = _slot_sources(p, n)
        out_k = torch.where(hit, kr[..., r, :].gather(-1, ia), out_k)
        if vr is not None:
            out_v = torch.where(hit, vr[..., r, :].gather(-1, ia), out_v)
    return out_k, out_v


def _chunk_sort(keys, vals, chunk: int, key_bits: int, radix_bits: int):
    """Stable LSD radix sort of every ``chunk`` block, all chunks at once as
    a [C, chunk] view; the chunk-sort kernel's plain twin. ``vals=None``
    sorts the keys alone."""
    n = keys.shape[0]
    if n % chunk:
        raise ValueError(f"size {n} is not a multiple of chunk {chunk}")
    kc = keys.reshape(-1, chunk)
    if vals is None:
        return radix_sort_keys(kc, key_bits, radix_bits).reshape(n), None
    ks, vs = radix_sort_by_key(vals.reshape(-1, chunk), kc, key_bits,
                               radix_bits)
    return ks.reshape(n), vs.reshape(n)


def merge_ladder(ks: torch.Tensor, vs: torch.Tensor | None, run: int,
                 fan_ins: list[int]):
    """Merge sorted runs of ``run`` on the given rungs (``merge_sorted_k``
    with fan-in k per rung); returns the keys and vals, ``vs=None`` merges
    keys alone."""
    n = ks.shape[0]
    for k in fan_ins:
        ks, vs = merge_sorted_k(ks.reshape(-1, k, run),
                                None if vs is None else vs.reshape(-1, k, run))
        ks = ks.reshape(n)
        vs = None if vs is None else vs.reshape(n)
        run *= k
    return ks, vs


def merge_rounds(ks: torch.Tensor, vs: torch.Tensor | None, run: int,
                 merge_fn=None, fan_in: int = 2, rung_fn=None):
    """k-ary merge ladder: sorted runs of ``run`` → one sorted array, on
    the rungs ``merge_round_fan_ins`` prescribes. ``merge_fn(ks, vs, run)
    -> (ks, vs, new_run)`` takes the first rungs (the fused-merge kernel);
    ``rung_fn(ks, vs, run, k) -> (ks, vs)`` each rung after them (the
    merge-rung kernel), else ``merge_sorted_k`` here. ``vs=None`` merges
    keys alone."""
    if merge_fn is not None and run < ks.shape[0]:
        ks, vs, run = merge_fn(ks, vs, run)
    fan_ins = merge_round_fan_ins(ks.shape[0], run, fan_in)
    if rung_fn is None:
        return merge_ladder(ks, vs, run, fan_ins)
    for k in fan_ins:
        ks, vs = rung_fn(ks, vs, run, k)
        run *= k
    return ks, vs


def _global_radix_passes(keys, vals, key_bits: int, tile: int,
                         radix_bits: int):
    """The merge-free digit-pass loop."""
    n_buckets = 1 << radix_bits
    n_passes = max(1, -(-key_bits // radix_bits))
    for p in range(n_passes):
        shift = p * radix_bits
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
                             radix_bits: int = 4, radix_sort_fn=None):
    """Global stable LSD radix sort with zero merge rounds;
    ``radix_sort_fn(keys, vals, key_bits) -> (keys, vals)`` runs the whole
    digit-pass loop in place of ``_global_radix_passes``."""
    n = keys.shape[0]
    tile = min(DEFAULT_CHUNK if tile is None else tile, n)
    clipped = torch.clamp(keys, max=key_bound)
    if radix_sort_fn is not None:
        ks, vs = radix_sort_fn(clipped, vals, _bits_for(key_bound))
    else:
        ks, vs = _global_radix_passes(clipped, vals, _bits_for(key_bound),
                                      tile, radix_bits)
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
                       chunk_sort_fn=None, merge_fn=None,
                       fan_in: int = 2, rung_fn=None, radix_sort_fn=None):
    """Global stable sort under a ``strategy``; ``key_bound`` is the
    exclusive bound of valid keys, ``chunk`` the UPE chunk (chunked_merge)
    or the histogram tile (global_radix). ``chunk_sort_fn(keys, vals,
    chunk, key_bits)``, ``merge_fn`` and ``rung_fn`` swap in the
    chunk-sort, fused-merge and merge-rung kernels, ``radix_sort_fn`` the
    whole global_radix sort."""
    n = keys.shape[0]
    chunk = min(DEFAULT_CHUNK if chunk is None else chunk, n)
    if strategy == "global_radix":
        return global_radix_sort_by_key(keys, vals, key_bound, tile=chunk,
                                        radix_bits=radix_bits,
                                        radix_sort_fn=radix_sort_fn)
    if strategy == "xla_sort":
        return xla_stable_sort_by_key(keys, vals, key_bound)
    if strategy != "chunked_merge":
        raise ValueError(f"unknown sort strategy {strategy!r}")
    key_bits = _bits_for(key_bound)
    clipped = torch.clamp(keys, max=key_bound)
    if chunk_sort_fn is None:
        ks, vs = _chunk_sort(clipped, vals, chunk, key_bits, radix_bits)
    else:
        ks, vs = chunk_sort_fn(clipped, vals, chunk, key_bits)
    ks, vs = merge_rounds(ks, vs, chunk, merge_fn=merge_fn, fan_in=fan_in,
                          rung_fn=rung_fn)
    return _restore_sentinels(ks, key_bound), vs


def edge_ordering(coo: COO, chunk: int | None = None, radix_bits: int = 4,
                  sort_fn=None, mode: str = "auto", keys_only: bool = True,
                  strategy: str = "global_radix",
                  chunk_sort_fn=None, merge_fn=None, fan_in: int = 2,
                  rung_fn=None, radix_sort_fn=None) -> COO:
    """Sort edges by (dst, src) — packed single pass or two-pass LSD.

    ``sort_fn(keys, vals, key_bound) -> (keys, vals)`` overrides the global
    stable sorter; the other knobs feed ``stable_sort_by_key``.
    ``keys_only`` (packed mode): sort the packed key with no payload; False
    carries the edge id along (same output).
    """
    if sort_fn is None:
        def sort_fn(k, v, bound):
            return stable_sort_by_key(k, v, bound, chunk=chunk,
                                      radix_bits=radix_bits,
                                      strategy=strategy,
                                      chunk_sort_fn=chunk_sort_fn,
                                      merge_fn=merge_fn, fan_in=fan_in,
                                      rung_fn=rung_fn,
                                      radix_sort_fn=radix_sort_fn)
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


def edge_ordering_xla(coo: COO) -> COO:
    """The comparison-sort baseline (what DGL on a GPU does): the edges
    ordered by (dst, src), as ``jnp.lexsort((src, dst))`` orders them — a
    stable ``torch.sort`` by src, then a stable one by dst. SENTINEL pads
    sort last."""
    src1, by_src = torch.sort(coo.src, stable=True)
    dst2, by_dst = torch.sort(coo.dst[by_src], stable=True)
    return COO(dst=dst2, src=src1[by_dst], n_edges=coo.n_edges,
               n_nodes=coo.n_nodes)
