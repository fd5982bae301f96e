"""COO -> CSC by one library sort: edges ordered by (dst, src), SENTINEL
slots last; ``ptr[v]`` the number of edges with dst < v; ``idx`` the sorted
src column. ``dst_only_csc`` is the convert's control: it orders by dst
alone (a stable sort that keeps each dst's edges in COO order), which
breaks the (dst, src) ordering the CSC guarantees."""
from __future__ import annotations

import torch

SENTINEL = 0x7FFFFFFF


def _pointers(sorted_dst: torch.Tensor, n_nodes: int) -> torch.Tensor:
    targets = torch.arange(n_nodes + 1, dtype=sorted_dst.dtype,
                           device=sorted_dst.device)
    return torch.searchsorted(sorted_dst, targets).to(torch.int32)


def csc(dst: torch.Tensor, src: torch.Tensor, n_nodes: int
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(ptr int32 [n_nodes + 1], idx int32 [capacity])."""
    key = (dst.to(torch.int64) << 31) | src.to(torch.int64)
    key = torch.sort(key).values
    idx = (key & SENTINEL).to(torch.int32)
    ptr = _pointers(key >> 31, n_nodes)
    return ptr, idx


def dst_only_csc(dst: torch.Tensor, src: torch.Tensor, n_nodes: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    order = torch.sort(dst, stable=True).indices
    return _pointers(dst[order], n_nodes), src[order]
