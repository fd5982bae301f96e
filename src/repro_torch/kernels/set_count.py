"""The SCR set-count and filter tree (port of ``set_count_less``,
``filter_tree_lookup`` and ``pallas_count_fn`` in
``repro/kernels/set_count.py``).

``set_count_less`` and ``filter_tree_lookup`` launch the kernels of
``csrc/set_count.cu`` on CUDA tensors and run their plain twins, the
blocked compare-reduces ``core.set_count.count_less_than`` and
``core.set_count.filter_lookup``, on CPU tensors. On the card the count
sorts tiles of ``SORT_TILE`` elements into the scratch of
``set_count_scratch`` and bisects only the tiles that straddle a target,
for any element order; the filter builds a hash table of the keys in the
scratch of ``filter_scratch`` and probes it once a target. ``count_fn``
is the adapter ``build_pointer_array(count_fn=...)`` takes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.set_count import count_less_than, filter_lookup

from . import _build, kernel_scope
from .common import SENTINEL, pad_pow2_1d

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
SORT_TILE = 4096  # csrc/set_count.cu kSortTile; its entries refuse a
# scratch sized for a smaller tile
_SIGNATURES = {
    "set_count_tile_sort": (ctypes.c_int, (_P, _I, _P, _L, _P, _L, _P, _P)),
    "set_count_count": (ctypes.c_int, (_P, _L, _P, _L, _I, _P, _I, _P, _P,
                                       _P)),
    "filter_hash_build": (ctypes.c_int, (_P, _P, _I, _P, _L, _P)),
    "filter_hash_probe": (ctypes.c_int, (_P, _L, _I, _P, _I, _P, _P, _P)),
}
FILTER_HASH_MUL = 0x9E3779B1  # csrc/set_count.cu filter_hash
FILTER_EMPTY = -1  # the key of an empty slot: bytes 0xFF
FILTER_GROUP_LOG2 = 2  # a probe reads 2^2 slots (csrc/set_count.cu kGroup)


def set_count_scratch(n_elems: int, device) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """The scratch of one ``set_count_less`` call on ``n_elems`` elements:
    the sorted tiles [n_tiles * SORT_TILE] and each tile's (min, max)
    [2 * n_tiles], int32."""
    n_tiles = -(-n_elems // SORT_TILE)
    return (torch.empty(n_tiles * SORT_TILE, dtype=torch.int32,
                        device=device),
            torch.empty(2 * n_tiles, dtype=torch.int32, device=device))


def tile_sort_c(lib, elements, tiles, bounds, work=None):
    """``csrc/set_count.cu``'s tile sort entry on these tensors (the
    return code); ``work``, a zeroed int64 [4] tensor or None, gets the
    kernels' work counts."""
    return lib.set_count_tile_sort(
        elements.data_ptr(), elements.shape[0], tiles.data_ptr(),
        tiles.shape[0], bounds.data_ptr(), bounds.shape[0],
        None if work is None else work.data_ptr(), _build.stream_of(tiles))


def count_c(lib, n_elems, targets, out, tiles, bounds, work=None):
    """``csrc/set_count.cu``'s count entry on sorted tiles of ``n_elems``
    elements (the return code)."""
    return lib.set_count_count(
        tiles.data_ptr(), tiles.shape[0], bounds.data_ptr(), bounds.shape[0],
        n_elems, targets.data_ptr(), targets.shape[0], out.data_ptr(),
        None if work is None else work.data_ptr(), _build.stream_of(out))


def set_count_less(elements: torch.Tensor, targets: torch.Tensor
                   ) -> torch.Tensor:
    """counts[t] = |{x in elements : x < targets[t]}| (int32); the
    elements need not be sorted. elements [E] int32 (pad with INT32_MAX,
    which is never below a target), targets [T] int32. On the card two
    kernels, each counted in ``launches``: the first sorts each tile of
    ``SORT_TILE`` elements into the scratch (with each tile's min and
    max), the second counts."""
    launches = (targets.shape[0] > 0) * (1 + (elements.shape[0] > 0))
    with kernel_scope("set_count_less", set_count_less, launches) as scope:
        if not elements.is_cuda:
            return count_less_than(elements, targets)
        for t in (elements, targets):
            if (t.dtype != torch.int32 or t.ndim != 1
                    or not t.is_contiguous() or t.device != elements.device):
                raise ValueError("set_count_less takes contiguous 1-D int32 "
                                 "CUDA tensors on one device")
        out = torch.empty_like(targets)
        if scope.launches:
            lib = _build.load("set_count", _SIGNATURES)
            tiles, bounds = set_count_scratch(elements.shape[0],
                                              elements.device)
            scope.launched()
            if elements.shape[0]:
                _build.check(tile_sort_c(lib, elements, tiles, bounds),
                             "set_count_less (tile sort)")
            _build.check(count_c(lib, elements.shape[0], targets, out, tiles,
                                 bounds), "set_count_less (count)")
        return out


set_count_less.launches = 0


def filter_table_bits(n_keys: int) -> int:
    """log2 of the filter table's slots for ``n_keys`` keys: 2^bits >=
    2 n_keys, at least two groups (csrc/set_count.cu filter_bits)."""
    return max(FILTER_GROUP_LOG2 + 1, (2 * n_keys - 1).bit_length())


def filter_hash(keys: torch.Tensor, bits: int) -> torch.Tensor:
    """The group of each key in a table of 2^bits groups (int64), as
    csrc/set_count.cu filter_hash computes it; its first slot is the group
    times 2^FILTER_GROUP_LOG2."""
    u = keys.to(torch.int64) & 0xFFFFFFFF
    return ((u * FILTER_HASH_MUL) & 0xFFFFFFFF) >> (32 - bits)


def filter_scratch(n_keys: int, device) -> torch.Tensor:
    """The scratch of one ``filter_tree_lookup`` call on ``n_keys`` keys:
    2^bits (key, enc) slots and the empty key's slot after them, int32
    [2 * (2^bits + 1)]."""
    return torch.empty(2 * ((1 << filter_table_bits(n_keys)) + 1),
                       dtype=torch.int32, device=device)


def build_c(lib, keys, payloads, table):
    """``csrc/set_count.cu``'s build entry (fill, then insert every key)
    on these tensors (the return code)."""
    return lib.filter_hash_build(
        keys.data_ptr(), payloads.data_ptr(), keys.shape[0],
        table.data_ptr(), table.shape[0] // 2, _build.stream_of(table))


def probe_c(lib, n_keys, table, targets, out, hit):
    """``csrc/set_count.cu``'s probe entry on a table built from
    ``n_keys`` keys (the return code)."""
    return lib.filter_hash_probe(
        table.data_ptr(), table.shape[0] // 2, n_keys, targets.data_ptr(),
        targets.shape[0], out.data_ptr(), hit.data_ptr(),
        _build.stream_of(out))


def filter_tree_lookup(keys: torch.Tensor, payloads: torch.Tensor,
                       targets: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """SCR Reindexer mode: (payload of the key equal to each target, or -1;
    hit flag). keys and payloads [E] int32 with unique keys, targets [T]
    int32; any E and T. Duplicate keys give their largest payload + 1,
    minus 1, as the twin's max does; a ragged key count (E % 2048 != 0)
    counts as padded with INT32_MIN keys of payload 0, as the twin and the
    reference pad to their blocks. On the card two kernels, each counted
    in ``launches``: the first builds a hash table of the keys in the
    scratch, the second probes it once a target."""
    if keys.shape != payloads.shape:
        raise ValueError("filter_tree_lookup takes keys and payloads of one "
                         "shape")
    launches = (targets.shape[0] > 0) * (1 + (keys.shape[0] > 0))
    with kernel_scope("filter_tree_lookup", filter_tree_lookup,
                      launches) as scope:
        if not keys.is_cuda:
            return filter_lookup(keys, payloads, targets)
        for t in (keys, payloads, targets):
            if (t.dtype != torch.int32 or t.ndim != 1
                    or not t.is_contiguous() or t.device != keys.device):
                raise ValueError("filter_tree_lookup takes contiguous 1-D "
                                 "int32 CUDA tensors on one device")
        out = torch.empty_like(targets)
        hit = torch.empty(targets.shape, dtype=torch.bool,
                          device=targets.device)
        if scope.launches:
            lib = _build.load("set_count", _SIGNATURES)
            table = filter_scratch(keys.shape[0], keys.device)
            scope.launched()
            _build.check(build_c(lib, keys, payloads, table),
                         "filter_tree_lookup (build)")
            _build.check(probe_c(lib, keys.shape[0], table, targets, out, hit),
                         "filter_tree_lookup (probe)")
        return out, hit


filter_tree_lookup.launches = 0


def count_fn(sorted_dst: torch.Tensor, targets: torch.Tensor,
             e_block: int = 2048, t_block: int = 256) -> torch.Tensor:
    """Adapter for ``build_pointer_array(count_fn=...)``: the reference's
    block padding (elements with INT32_MAX, targets with 0), then the
    count, sliced back to the targets."""
    elems = pad_pow2_1d(sorted_dst.contiguous(),
                        min(e_block, sorted_dst.shape[0]), SENTINEL)
    tgts = pad_pow2_1d(targets.contiguous(), min(t_block, targets.shape[0]),
                       0)
    return set_count_less(elems, tgts)[:targets.shape[0]]
