"""The UPE chunk sort and the global_radix digit pass (port of
``repro/kernels/radix_sort.py``).

``chunk_sort`` (behind ``radix_sort_chunks`` / ``radix_sort_chunks_keys``)
sorts every chunk of the chunked_merge Ordering. The reference's digit pass
is a tiled partition + histogram, a [T, B] table scan, the rank-gather of
output-slot sources, and one gather: ``digit_partition_hist`` and
``digit_rank_gather`` are its one-to-one kernels, which no path runs any
more. The card's pass is ``digit_hist`` (bucket-major counts per card
tile), one exclusive cumsum of them, and ``digit_scatter`` (each tile's
stable partition written straight to its global slots); the whole sort
(``make_radix_sort_fn``) runs it on its own digit schedule. Each wrapper
launches its kernel of ``csrc/digit_pass.cu`` on CUDA tensors and runs its
plain-torch twin on CPU tensors. The table scans and the old pass's final
gather are plain torch on whichever device holds the data, as they were
jnp in the reference.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.graph import take
from repro_torch.core.ordering import DEFAULT_CHUNK, _chunk_sort
from repro_torch.core.set_partition import (partition_tiles,
                                            rank_gather_sources)

from . import _build, kernel_scope

# Dynamic shared memory one CTA of an H100 can use.
MAX_SMEM_BYTES = 232448
MAX_RADIX_BITS = 8
# The card's own tile of digit_hist / digit_scatter (the stable partition of
# the whole array does not depend on it), held in registers by 16 warps of
# 8 items a lane; at most MAX_DIGIT_TILE
SCATTER_TILE = 4096
MAX_DIGIT_TILE = 16384

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "digit_partition_hist": (ctypes.c_int, (_P, _P, _P, _P, _P, _P, _I, _I,
                                            _I, _I, _P)),
    "digit_rank_gather": (ctypes.c_int, (_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                         _P)),
    "digit_partition_smem_bytes": (ctypes.c_size_t, (_I, _I, _I)),
    "digit_hist": (ctypes.c_int, (_P, _P, _I, _I, _I, _I, _P)),
    "digit_hist_smem_bytes": (ctypes.c_size_t, (_I, _I)),
    "digit_scatter": (ctypes.c_int, (_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                     _P)),
    "digit_scatter_smem_bytes": (ctypes.c_size_t, (_I, _I, _I)),
    "chunk_sort": (ctypes.c_int, (_P, _P, _P, _P, _I, _I, _I, _P)),
    "chunk_sort_smem_bytes": (ctypes.c_size_t, (_I, _I, _I)),
}
# the chunk-sort kernel's instantiations, (warps, items a lane), by the
# chunks they hold (csrc/digit_pass.cu kSortShapes): the smallest that
# holds a chunk sorts it; pairs take at most MAX_PAIR_CHUNK a chunk
CHUNK_SORT_SHAPES = ((1, 4), (4, 4), (8, 8), (16, 8), (32, 8), (32, 16),
                     (32, 32))
MAX_PAIR_CHUNK = 32 * 32 * 16


def _lib():
    return _build.load("digit_pass", _SIGNATURES)


def _check_cuda_i32(*ts):
    dev = ts[0].device
    for t in ts:
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != dev:
            raise ValueError("digit-pass kernels take contiguous int32 CUDA "
                             "tensors on one device")


def partition_smem_bytes(tile: int, n_buckets: int, has_vals: bool) -> int:
    """Dynamic shared memory of one partition CTA (mirrors the C side)."""
    return 4 * ((2 if has_vals else 1) * tile + (8 + 2) * n_buckets)


def chunk_sort_bits(key_bits: int, radix_bits: int) -> int:
    """The key bits [0, B) a chunk sort orders by: those that the
    reference's ``ceil(key_bits / radix_bits)`` LSD passes of
    ``radix_bits`` cover, at most 32."""
    return min(32, max(1, -(-key_bits // radix_bits)) * radix_bits)


def chunk_digit_schedule(n_bits: int) -> list[tuple[int, int]]:
    """The chunk-sort kernel's own digit passes over key bits [0, n_bits),
    (shift, width) each: ceil(n_bits / 8) passes whose widths differ by at
    most one bit, the wider first (csrc/digit_pass.cu pass_width)."""
    passes = max(1, -(-n_bits // 8))
    out, shift = [], 0
    for p in range(passes):
        width = n_bits // passes + (p < n_bits % passes)
        out.append((shift, width))
        shift += width
    return out


def chunk_sort_shape(chunk: int, has_vals: bool) -> tuple[int, int] | None:
    """The (warps, items a lane) instantiation that sorts chunks of
    ``chunk``, or None when one CTA cannot hold it."""
    for warps, items in CHUNK_SORT_SHAPES:
        cap = 32 * warps * items
        if chunk <= cap:
            return None if has_vals and cap > MAX_PAIR_CHUNK else (warps,
                                                                   items)
    return None


def chunk_sort_smem_bytes(chunk: int, n_bits: int, has_vals: bool) -> int:
    """Dynamic shared memory of one chunk-sort CTA: each warp's digit
    counters and the scatter buffer of the chunk (mirrors the C side); 0
    when no instantiation holds the chunk."""
    shape = chunk_sort_shape(chunk, has_vals)
    if shape is None:
        return 0
    nb = 1 << chunk_digit_schedule(n_bits)[0][1]
    return 4 * (shape[0] * (nb + 2) + (2 if has_vals else 1) * chunk)


def chunk_sort(keys: torch.Tensor, vals: torch.Tensor | None, chunk: int,
               key_bits: int, radix_bits: int = 4):
    """Stable LSD radix sort of every ``chunk`` block of (keys, vals):
    ``ceil(key_bits / radix_bits)`` digit passes. keys (vals) [N] int32,
    N % chunk == 0; ``vals=None`` sorts keys alone. Returns (keys, vals or
    None). On the card one launch sorts every chunk by the same key bits
    [0, ``chunk_sort_bits``) in the kernel's own digit passes
    (``chunk_digit_schedule``), the chunk in registers throughout."""
    n = keys.shape[0]
    if chunk <= 0 or n % chunk:
        raise ValueError(f"size {n} is not a multiple of chunk {chunk}")
    with kernel_scope("chunk_sort", chunk_sort, n > 0) as scope:
        if not keys.is_cuda:
            return _chunk_sort(keys, vals, chunk, key_bits, radix_bits)
        _check_cuda_i32(keys, *(() if vals is None else (vals,)))
        if radix_bits < 1:
            raise ValueError(f"radix_bits {radix_bits} < 1")
        n_bits = chunk_sort_bits(key_bits, radix_bits)
        smem = chunk_sort_smem_bytes(chunk, n_bits, vals is not None)
        if not smem:
            most = MAX_PAIR_CHUNK if vals is not None else 32 * max(
                w * i for w, i in CHUNK_SORT_SHAPES)
            raise ValueError(f"chunk {chunk} does not fit one CTA's registers "
                             f"and shared memory: it holds at most {most} "
                             f"{'pairs' if vals is not None else 'keys'}")
        out_k = torch.empty_like(keys)
        out_v = None if vals is None else torch.empty_like(vals)
        if scope.launches:
            lib = _lib()
            assert lib.chunk_sort_smem_bytes(chunk, n_bits,
                                             vals is not None) == smem
            scope.launched()
            _build.check(lib.chunk_sort(
                keys.data_ptr(), None if vals is None else vals.data_ptr(),
                out_k.data_ptr(), None if out_v is None else out_v.data_ptr(),
                n // chunk, chunk, n_bits, _build.stream_of(keys)),
                "chunk_sort")
        return out_k, out_v


chunk_sort.launches = 0


def radix_sort_chunks(keys: torch.Tensor, values: torch.Tensor, chunk: int,
                      key_bits: int, radix_bits: int = 4):
    """Sort each ``chunk``-sized block of (keys, values) independently
    (stable LSD radix sort per chunk)."""
    return chunk_sort(keys, values, chunk, key_bits, radix_bits)


def radix_sort_chunks_keys(keys: torch.Tensor, chunk: int, key_bits: int,
                           radix_bits: int = 4) -> torch.Tensor:
    """Keys-only ``radix_sort_chunks``."""
    return chunk_sort(keys, None, chunk, key_bits, radix_bits)[0]


def widest_sub_chunk(chunk: int, has_vals: bool) -> int:
    """The widest divisor of ``chunk`` that one chunk-sort CTA holds:
    ``chunk`` itself when it fits (at most MAX_PAIR_CHUNK pairs, or the
    largest instantiation's keys)."""
    most = MAX_PAIR_CHUNK if has_vals else 32 * max(
        w * i for w, i in CHUNK_SORT_SHAPES)
    return next(d for d in range(min(chunk, most), 0, -1) if chunk % d == 0)


def make_chunk_sort_fn(radix_bits: int = 4):
    """``chunk_sort_fn`` for ``ordering.stable_sort_by_key`` with the digit
    width routed from ``EngineConfig.radix_bits``; ``vals=None`` sorts the
    keys alone and returns ``(keys, None)``. A chunk wider than one CTA
    holds (``EngineConfig.w_upe`` up to 65,536) is sorted as stable
    sub-chunks of the widest shape that fits (``widest_sub_chunk``), then
    merged up to the chunk by one merge rung (``merge.merge_rung``, earlier
    runs winning ties): the same stable order, so the same output as one
    sort of the chunk."""

    def chunk_sort_fn(keys, vals, chunk, key_bits):
        keys = keys.contiguous()
        vals = None if vals is None else vals.contiguous()
        sub = widest_sub_chunk(chunk, vals is not None)
        ks, vs = chunk_sort(keys, vals, sub, key_bits, radix_bits)
        if sub == chunk:
            return ks, vs
        from .merge import merge_rung
        return merge_rung(ks, vs, sub, chunk // sub)

    return chunk_sort_fn


def _partition_hist_plain(keys, vals, shift, tile, radix_bits):
    nb = 1 << radix_bits
    k2 = keys.reshape(-1, tile)
    local_src, lbase = partition_tiles((k2 >> shift) & (nb - 1), nb)
    hist = torch.diff(lbase, dim=1, append=torch.full(
        (lbase.shape[0], 1), tile, dtype=torch.int32, device=keys.device))
    idx = local_src.to(torch.int64)
    pk = k2.gather(1, idx).reshape(-1)
    pv = None if vals is None else vals.reshape(-1, tile).gather(
        1, idx).reshape(-1)
    return pk, pv, lbase, hist


def digit_partition_hist(keys: torch.Tensor, vals: torch.Tensor | None,
                         shift: int, tile: int, radix_bits: int = 4):
    """Stable in-tile partition by digit ``(key >> shift) & (2^rb - 1)``.

    keys (vals) [N] int32, N % tile == 0. Returns (partitioned keys,
    partitioned vals or None, lbase [T, B], hist [T, B]): every tile laid
    out bucket-major, then by in-tile position, with its in-tile bucket
    bases and counts.
    """
    n = keys.shape[0]
    if n % tile:
        raise ValueError(f"size {n} is not a multiple of tile {tile}")
    with kernel_scope("digit_partition_hist", digit_partition_hist,
                      n > 0) as scope:
        if not keys.is_cuda:
            return _partition_hist_plain(keys, vals, shift, tile, radix_bits)
        _check_cuda_i32(keys, *(() if vals is None else (vals,)))
        nb = 1 << radix_bits
        if radix_bits > MAX_RADIX_BITS:
            raise ValueError(f"radix_bits {radix_bits} > {MAX_RADIX_BITS}: "
                             "the kernel takes at most 256 buckets")
        smem = partition_smem_bytes(tile, nb, vals is not None)
        if smem > MAX_SMEM_BYTES:
            raise ValueError(f"tile {tile} needs {smem} bytes of shared "
                             f"memory; one CTA has {MAX_SMEM_BYTES}")
        n_tiles = n // tile
        pk = torch.empty_like(keys)
        pv = None if vals is None else torch.empty_like(vals)
        lbase = torch.empty((n_tiles, nb), dtype=torch.int32,
                            device=keys.device)
        hist = torch.empty_like(lbase)
        if scope.launches:
            lib = _lib()
            assert lib.digit_partition_smem_bytes(
                tile, nb, vals is not None) == smem
            scope.launched()
            _build.check(lib.digit_partition_hist(
                keys.data_ptr(), None if vals is None else vals.data_ptr(),
                pk.data_ptr(), None if pv is None else pv.data_ptr(),
                lbase.data_ptr(), hist.data_ptr(), n_tiles, tile, shift, nb,
                _build.stream_of(keys)), "digit_partition_hist")
        return pk, pv, lbase, hist


digit_partition_hist.launches = 0


def digit_rank_gather(gbase: torch.Tensor, incl_t: torch.Tensor,
                      excl_t: torch.Tensor, lbase: torch.Tensor,
                      tile: int) -> torch.Tensor:
    """Source index, in the tile-partitioned layout, of every output slot
    of the stable pass (``set_partition.rank_gather_sources``)."""
    with kernel_scope("digit_rank_gather", digit_rank_gather,
                      incl_t.shape[0] * tile > 0) as scope:
        if not gbase.is_cuda:
            return rank_gather_sources(gbase, incl_t, excl_t, lbase, tile)
        _check_cuda_i32(gbase, incl_t, excl_t, lbase)
        n_tiles, nb = incl_t.shape
        n = n_tiles * tile
        out = torch.empty(n, dtype=torch.int32, device=gbase.device)
        if scope.launches:
            scope.launched()
            _build.check(_lib().digit_rank_gather(
                gbase.data_ptr(), incl_t.data_ptr(), excl_t.data_ptr(),
                lbase.data_ptr(), out.data_ptr(), n, n_tiles, tile, nb,
                _build.stream_of(gbase)), "digit_rank_gather")
        return out


digit_rank_gather.launches = 0


def reference_digit_pass(keys: torch.Tensor, values: torch.Tensor | None,
                         shift: int, tile: int, radix_bits: int = 4
                         ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The reference's digit pass on its one-to-one kernels: partition +
    histogram, the [T, B] table scan, the rank-gather and the gathers. The
    same permutation as ``global_digit_pass``; no path runs it, it is the
    old design's baseline."""
    pk, pv, lbase, hist = digit_partition_hist(keys, values, shift, tile,
                                               radix_bits)
    # the [T, B] table scan over tiles, as a last-axis scan of the [B, T]
    # transpose (a leading-axis CUDA cumsum walks the T rows in turn)
    incl_t = torch.cumsum(hist.T.contiguous(), dim=1,
                          dtype=torch.int32).T.contiguous()
    excl_t = incl_t - hist
    counts = incl_t[-1]
    gbase = torch.cumsum(counts, dim=0, dtype=torch.int32) - counts
    src = digit_rank_gather(gbase.contiguous(), incl_t, excl_t, lbase, tile)
    return take(pk, src), None if pv is None else take(pv, src)


def _check_digit_args(n: int, tile: int, radix_bits: int):
    if tile < 1:
        raise ValueError(f"tile {tile} < 1")
    if not 1 <= radix_bits <= MAX_RADIX_BITS:
        raise ValueError(f"radix_bits {radix_bits} outside 1..{MAX_RADIX_BITS}"
                         ": the kernels take 2 to 256 buckets")
    if n >= 2 ** 31:
        raise ValueError(f"{n} elements: int32 offsets take fewer than 2^31")


def n_card_tiles(n: int, tile: int) -> int:
    """Tiles of ``tile`` over ``n`` elements, the last one may be shorter."""
    return -(-n // tile)


def digit_pass_shape(tile: int) -> tuple[int, int] | None:
    """The (warps, items a lane) instantiation of the digit-pass kernels
    for ``tile``: the chunk sort's smallest shape from (4, 4) on that holds
    it (csrc/digit_pass.cu digit_shape); None past MAX_DIGIT_TILE."""
    if not 1 <= tile <= MAX_DIGIT_TILE:
        return None
    return max(chunk_sort_shape(tile, False), CHUNK_SORT_SHAPES[1])


def digit_smem_bytes(tile: int, radix_bits: int,
                     vals: bool | None) -> int:
    """Dynamic shared memory of one digit_hist CTA (``vals=None``) or one
    digit_scatter CTA (mirrors the C side): the per-warp counters, and for
    the scatter the scan's scratch, the bucket destinations and the staged
    tile."""
    warps, nb = digit_pass_shape(tile)[0], 1 << radix_bits
    if vals is None:
        return 4 * warps * (nb + 1)
    return 4 * (warps * (nb + 1) + warps + nb + (2 if vals else 1) * tile)


def _check_digit_tile(tile: int):
    if digit_pass_shape(tile) is None:
        raise ValueError(f"tile {tile} does not fit one CTA's registers and "
                         f"shared memory: the digit-pass kernels take at "
                         f"most {MAX_DIGIT_TILE}")


def _digit_hist_plain(keys, shift, tile, radix_bits):
    nb, n = 1 << radix_bits, keys.shape[0]
    n_tiles = n_card_tiles(n, tile)
    d = ((keys >> shift) & (nb - 1)).to(torch.int64)
    t = torch.arange(n, device=keys.device) // tile
    return torch.bincount(d * n_tiles + t, minlength=nb * n_tiles).to(
        torch.int32)


def digit_hist(keys: torch.Tensor, shift: int, tile: int = SCATTER_TILE,
               radix_bits: int = 4) -> torch.Tensor:
    """Digit counts of every tile of ``tile`` keys, bucket-major: [B * T]
    int32, ``counts[b * T + t]`` the keys of tile t whose digit ``(key >>
    shift) & (2^radix_bits - 1)`` is b; the last tile may be shorter."""
    n = keys.shape[0]
    _check_digit_args(n, tile, radix_bits)
    with kernel_scope("digit_hist", digit_hist, n > 0) as scope:
        if not keys.is_cuda:
            return _digit_hist_plain(keys, shift, tile, radix_bits)
        _check_cuda_i32(keys)
        _check_digit_tile(tile)
        nb = 1 << radix_bits
        counts = torch.empty(nb * n_card_tiles(n, tile), dtype=torch.int32,
                             device=keys.device)
        if scope.launches:
            lib = _lib()
            assert lib.digit_hist_smem_bytes(tile, radix_bits) == \
                digit_smem_bytes(tile, radix_bits, None)
            scope.launched()
            _build.check(lib.digit_hist(keys.data_ptr(), counts.data_ptr(), n,
                                        tile, shift, radix_bits,
                                        _build.stream_of(keys)), "digit_hist")
        return counts


digit_hist.launches = 0


def digit_offsets(counts: torch.Tensor) -> torch.Tensor:
    """The table scan between the kernels: the exclusive cumsum of the
    bucket-major counts, every (bucket, tile) run's first output slot."""
    return torch.cumsum(counts, dim=0, dtype=torch.int32) - counts


# one-hot elements a slice of the scatter twin's tiles may take
_TWIN_SLICE = 1 << 24


def _digit_scatter_plain(keys, vals, offsets, shift, tile, radix_bits):
    """Each tile's stable partition (``partition_tiles``, the ragged last
    tile padded with one more bucket that ranks last), its staged slot s of
    bucket b written to ``offsets[b * T + t] + s - lbase[t, b]``. Tiles go
    in slices, so the one-hot table stays small."""
    nb, n = 1 << radix_bits, keys.shape[0]
    n_tiles = n_card_tiles(n, tile)
    pad = n_tiles * tile - n
    kp = torch.cat([keys, keys.new_zeros(pad)]).view(n_tiles, tile)
    digit = (kp >> shift) & (nb - 1)
    if pad:
        digit[-1, tile - pad:] = nb
    out_k = torch.empty_like(keys)
    out_v = None if vals is None else torch.empty_like(vals)
    vp = None if vals is None else torch.cat(
        [vals, vals.new_zeros(pad)]).view(n_tiles, tile)
    off = offsets.view(nb, n_tiles).T
    step = max(1, _TWIN_SLICE // (tile * (nb + 1)))
    slot = torch.arange(tile, device=keys.device)
    for t0 in range(0, n_tiles, step):
        t1 = min(t0 + step, n_tiles)
        local_src, lbase = partition_tiles(digit[t0:t1], nb + 1)
        src = local_src.to(torch.int64)
        b = digit[t0:t1].gather(1, src).to(torch.int64)
        real = b < nb
        bb = torch.where(real, b, 0)
        dst = (off[t0:t1].to(torch.int64).gather(1, bb) + slot
               - lbase.to(torch.int64).gather(1, bb))[real]
        out_k[dst] = kp[t0:t1].gather(1, src)[real]
        if vals is not None:
            out_v[dst] = vp[t0:t1].gather(1, src)[real]
    return out_k, out_v


def digit_scatter(keys: torch.Tensor, vals: torch.Tensor | None,
                  offsets: torch.Tensor, shift: int, tile: int = SCATTER_TILE,
                  radix_bits: int = 4):
    """The stable digit pass's relocation: every tile of ``tile`` keys
    (vals) partitioned stably by digit, its run of bucket b written from
    ``offsets[b * T + t]`` on (``digit_offsets`` of ``digit_hist``'s
    counts). Returns (keys, vals or None)."""
    n = keys.shape[0]
    _check_digit_args(n, tile, radix_bits)
    nb = 1 << radix_bits
    if offsets.shape != (nb * n_card_tiles(n, tile),):
        raise ValueError(f"offsets {tuple(offsets.shape)} are not [B * T] = "
                         f"[{nb * n_card_tiles(n, tile)}]")
    with kernel_scope("digit_scatter", digit_scatter, n > 0) as scope:
        if not keys.is_cuda:
            return _digit_scatter_plain(keys, vals, offsets, shift, tile,
                                        radix_bits)
        _check_cuda_i32(keys, offsets, *(() if vals is None else (vals,)))
        _check_digit_tile(tile)
        out_k = torch.empty_like(keys)
        out_v = None if vals is None else torch.empty_like(vals)
        if scope.launches:
            lib = _lib()
            assert lib.digit_scatter_smem_bytes(tile, radix_bits,
                                                vals is not None) == \
                digit_smem_bytes(tile, radix_bits, vals is not None)
            scope.launched()
            _build.check(lib.digit_scatter(
                keys.data_ptr(), None if vals is None else vals.data_ptr(),
                offsets.data_ptr(), out_k.data_ptr(),
                None if out_v is None else out_v.data_ptr(), n, tile, shift,
                radix_bits, _build.stream_of(keys)), "digit_scatter")
        return out_k, out_v


digit_scatter.launches = 0


def digit_pass(keys: torch.Tensor, vals: torch.Tensor | None, shift: int,
               radix_bits: int, tile: int = SCATTER_TILE):
    """One stable LSD pass by digit ``(key >> shift) & (2^radix_bits - 1)``
    on the card's design: histogram, table scan, scatter."""
    counts = digit_hist(keys, shift, tile, radix_bits)
    return digit_scatter(keys, vals, digit_offsets(counts), shift, tile,
                         radix_bits)


def global_digit_pass(keys: torch.Tensor, values: torch.Tensor | None,
                      shift: int, tile: int, radix_bits: int = 4
                      ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One tiled global LSD digit pass: stable-partition the whole array by
    ``(key >> shift) & (2^radix_bits - 1)``; ``values=None`` relocates the
    keys alone. ``tile`` is the reference's histogram tile (N % tile == 0);
    the pass runs on the card's tiles (``digit_pass``), which give the same
    permutation."""
    n = keys.shape[0]
    if n % tile:
        raise ValueError(f"size {n} is not a multiple of tile {tile}")
    return digit_pass(keys, values, shift, radix_bits)


def global_radix_schedule(key_bits: int, radix_bits: int
                          ) -> list[tuple[int, int]]:
    """The card's digit passes, (shift, width) each, of a global sort whose
    reference runs ``ceil(key_bits / radix_bits)`` passes of ``radix_bits``:
    ``chunk_digit_schedule`` over exactly the bits those passes cover."""
    return chunk_digit_schedule(chunk_sort_bits(key_bits, radix_bits))


def make_radix_sort_fn(radix_bits: int = 4, tile: int | None = None):
    """``radix_sort_fn(keys, vals, key_bits)`` for
    ``ordering.global_radix_sort_by_key``: the whole stable LSD sort. On the
    card it runs ``global_radix_schedule``'s passes (any schedule of stable
    digit passes over the same bits gives the same permutation: 7, 7 and 6
    bits where the reference runs five of 4); on the CPU, the reference's
    own loop of ``radix_bits``-bit ``global_digit_pass``es on histogram
    tile ``tile``."""

    def radix_sort_fn(keys, vals, key_bits):
        if not keys.is_cuda:
            t = min(DEFAULT_CHUNK if tile is None else tile, keys.shape[0])
            for p in range(max(1, -(-key_bits // radix_bits))):
                keys, vals = global_digit_pass(keys, vals, p * radix_bits, t,
                                               radix_bits)
            return keys, vals
        for shift, width in global_radix_schedule(key_bits, radix_bits):
            keys, vals = digit_pass(keys, vals, shift, width)
        return keys, vals

    return radix_sort_fn
