"""Data Reshaping: sorted COO → CSC pointer array (port of
``repro/core/reshaping.py``).

ptr[v] = |{edges : dst < v}| for v in 0..n_nodes — an independent
set-count per target, built as one batched rank search over the sorted dst
stream.
"""
from __future__ import annotations

import torch

from .graph import COO, CSC, pad_to
from .set_count import rank_in_sorted


def build_pointer_array(sorted_dst: torch.Tensor, n_nodes: int,
                        ptr_capacity: int | None = None, count_fn=None,
                        unroll: bool = False, rank_fn=None) -> torch.Tensor:
    """Pointer array via set-counting over the sorted dst stream.

    ``rank_fn(sorted, targets, side)`` (the rank-search kernel) outranks
    ``count_fn(sorted, targets)`` (the count kernel); without either the
    plain ``rank_in_sorted`` runs, unrolled when ``unroll``.
    """
    targets = torch.arange(n_nodes + 1, dtype=torch.int32,
                           device=sorted_dst.device)
    if rank_fn is not None:
        ptr = rank_fn(sorted_dst, targets, "left")
    elif count_fn is not None:
        ptr = count_fn(sorted_dst, targets)
    else:
        ptr = rank_in_sorted(sorted_dst, targets, side="left", unroll=unroll)
    if ptr_capacity is not None:
        ptr = pad_to(ptr, ptr_capacity, int(ptr[-1]))
    return ptr


def data_reshaping(sorted_coo: COO, ptr_capacity: int | None = None,
                   count_fn=None, unroll: bool = False,
                   rank_fn=None) -> CSC:
    """Sorted COO → CSC (pointer array + the sorted src column)."""
    ptr = build_pointer_array(sorted_coo.dst, sorted_coo.n_nodes,
                              ptr_capacity=ptr_capacity, count_fn=count_fn,
                              unroll=unroll, rank_fn=rank_fn)
    return CSC(ptr=ptr, idx=sorted_coo.src, n_edges=sorted_coo.n_edges,
               n_nodes=sorted_coo.n_nodes)
