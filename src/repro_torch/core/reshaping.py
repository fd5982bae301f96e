"""Data Reshaping: sorted COO → CSC pointer array (port of
``repro/core/reshaping.py``).

ptr[v] = |{edges : dst < v}| for v in 0..n_nodes — an independent
set-count per target, built as one batched rank search over the sorted dst
stream. ``build_pointer_array_serial`` keeps the conventional serial scan
the paper measures against; ``graph_convert`` is Ordering + Reshaping.
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


def build_pointer_array_serial(sorted_dst: torch.Tensor,
                               n_nodes: int) -> torch.Tensor:
    """The conventional serial scan (the baseline): one cursor bumped per
    edge, each step after the previous edge's, on the host; dst entries at
    or past ``n_nodes`` are skipped. Returns the same int32 pointer array
    as ``build_pointer_array``, on ``sorted_dst``'s device."""
    hist = [0] * n_nodes
    # repro: allow-traced-if — the serial baseline scans on the host by
    # design
    for d in sorted_dst.tolist():
        if d < n_nodes:
            # repro: allow-scatter-write — a host list (the baseline)
            hist[d] += 1
    ptr = [0]
    for h in hist:
        ptr.append(ptr[-1] + h)
    return torch.tensor(ptr, dtype=torch.int32, device=sorted_dst.device)


def data_reshaping(sorted_coo: COO, ptr_capacity: int | None = None,
                   count_fn=None, unroll: bool = False,
                   rank_fn=None) -> CSC:
    """Sorted COO → CSC (pointer array + the sorted src column)."""
    ptr = build_pointer_array(sorted_coo.dst, sorted_coo.n_nodes,
                              ptr_capacity=ptr_capacity, count_fn=count_fn,
                              unroll=unroll, rank_fn=rank_fn)
    return CSC(ptr=ptr, idx=sorted_coo.src, n_edges=sorted_coo.n_edges,
               n_nodes=sorted_coo.n_nodes)


def graph_convert(coo: COO, chunk: int | None = None, count_fn=None,
                  chunk_sort_fn=None, ptr_capacity: int | None = None) -> CSC:
    """Full graph conversion = Ordering + Reshaping, on the COO's device:
    the reference's chunked_merge ``edge_ordering`` (``chunk`` None is
    ``ordering.DEFAULT_CHUNK``; ``chunk_sort_fn`` the chunk-sort kernel),
    then ``data_reshaping``."""
    from .ordering import edge_ordering
    sorted_coo = edge_ordering(coo, chunk=chunk, strategy="chunked_merge",
                               chunk_sort_fn=chunk_sort_fn)
    return data_reshaping(sorted_coo, ptr_capacity=ptr_capacity,
                          count_fn=count_fn)
