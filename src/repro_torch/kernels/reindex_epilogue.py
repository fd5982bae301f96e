"""The SCR rank epilogue: pointer build / first-occurrence rank and the
reindex rename (port of ``repro/kernels/reindex_epilogue.py``).

``rank_search`` and ``rename`` launch the kernels of
``csrc/reindex_epilogue.cu`` on CUDA tensors and run their plain-torch
twins — the reference's bisection rounds with the converged-lane freeze —
on CPU tensors. ``rank_fn`` / ``rename_fn`` are the adapters
``build_pointer_array`` and ``ReindexMap.lookup`` take.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.graph import take

from . import _build, kernel_scope
from .common import SENTINEL

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "rank_search": (ctypes.c_int, (_P, _I, _P, _P, _I, _I, _P)),
    "rename_lookup": (ctypes.c_int, (_P, _P, _I, _P, _P, _I, _P)),
}


def _lib():
    return _build.load("reindex_epilogue", _SIGNATURES)


def _check_cuda_i32(*ts):
    dev = ts[0].device
    for t in ts:
        if (t.dtype != torch.int32 or t.ndim != 1 or not t.is_contiguous()
                or t.device != dev):
            raise ValueError("rank-epilogue kernels take contiguous 1-D int32 "
                             "CUDA tensors on one device")


def _unrolled_rank(arr: torch.Tensor, q: torch.Tensor, side: str
                   ) -> torch.Tensor:
    """The reference's statically unrolled bisection (lo, hi, mid) with the
    converged-lane freeze: the kernels' plain twin."""
    n = arr.shape[0]
    lo = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    hi = torch.full(q.shape, n, dtype=torch.int32, device=q.device)
    for _ in range(max(1, int(n).bit_length())):
        active = lo < hi
        mid = (lo + hi) >> 1
        pivot = take(arr, mid)
        go_right = (pivot < q) if side == "left" else (pivot <= q)
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def rank_search(sorted_arr: torch.Tensor, queries: torch.Tensor,
                side: str = "left") -> torch.Tensor:
    """rank[t] = searchsorted(sorted_arr, queries[t], side) (int32).

    sorted_arr [N] ascending int32 (a SENTINEL tail is fine), queries [Q].
    """
    if side not in ("left", "right"):
        raise ValueError(side)
    with kernel_scope("rank_search", rank_search,
                      queries.shape[0] > 0) as scope:
        if not sorted_arr.is_cuda:
            return _unrolled_rank(sorted_arr, queries, side)
        _check_cuda_i32(sorted_arr, queries)
        out = torch.empty_like(queries)
        if scope.launches:
            scope.launched()
            _build.check(_lib().rank_search(
                sorted_arr.data_ptr(), sorted_arr.shape[0], queries.data_ptr(),
                out.data_ptr(), queries.shape[0], int(side == "right"),
                _build.stream_of(queries)), "rank_search")
        return out


rank_search.launches = 0


def _rename_plain(sorted_vids, slot_to_new, queries):
    n = sorted_vids.shape[0]
    rank_c = torch.clamp(_unrolled_rank(sorted_vids, queries, "left"),
                         0, n - 1)
    hit = take(sorted_vids, rank_c) == queries
    new = take(slot_to_new, rank_c)
    return torch.where(hit & (queries != SENTINEL), new,
                       torch.full_like(new, SENTINEL))


def rename(sorted_vids: torch.Tensor, slot_to_new: torch.Tensor,
           queries: torch.Tensor) -> torch.Tensor:
    """The whole ``ReindexMap.lookup``: rank, run-head hit test and
    slot-table gather. Misses and SENTINEL queries give SENTINEL."""
    if sorted_vids.shape != slot_to_new.shape:
        raise ValueError("sorted_vids and slot_to_new differ in shape")
    with kernel_scope("rename", rename, queries.shape[0] > 0) as scope:
        if not sorted_vids.is_cuda:
            return _rename_plain(sorted_vids, slot_to_new, queries)
        _check_cuda_i32(sorted_vids, slot_to_new, queries)
        if sorted_vids.shape[0] == 0:
            raise ValueError("rename needs a non-empty sorted stream")
        out = torch.empty_like(queries)
        if scope.launches:
            scope.launched()
            _build.check(_lib().rename_lookup(
                sorted_vids.data_ptr(), slot_to_new.data_ptr(),
                sorted_vids.shape[0], queries.data_ptr(), out.data_ptr(),
                queries.shape[0], _build.stream_of(queries)), "rename")
        return out


rename.launches = 0


def rank_fn(sorted_arr, queries, side="left"):
    """Adapter for ``build_pointer_array(rank_fn=...)`` /
    ``build_reindex_map(rank_fn=...)``."""
    return rank_search(sorted_arr.contiguous(), queries.contiguous(), side)


def rename_fn(sorted_vids, slot_to_new, queries):
    """Adapter for ``ReindexMap.lookup`` (``rename_fn=...``)."""
    return rename(sorted_vids.contiguous(), slot_to_new.contiguous(),
                  queries.contiguous())
