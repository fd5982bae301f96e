"""The GNN aggregation over dst-sorted edges (port of
``segment_sum_sorted`` in ``repro/kernels/segment_agg.py`` and
``segment_sum_padded`` in ``repro/kernels/ops.py``).

``segment_sum_sorted`` launches the kernel of ``csrc/segment_agg.cu`` on
CUDA tensors and runs its plain twin on CPU tensors. Both are
deterministic. The kernel sums each node's span of edges with the
pointer segment sum's body (``csrc/span_sum.cuh``), so on the same spans
its bits are ``ptr_seg_sum``'s; it can read the rows through a gather
index and divide by the edge count (GraphSAGE's mean, with no [E, D]
message stream and no stream of ones). The twin keeps the unfused
composition's bits: the gather, the float64 ``index_add_`` rounded once
to float32, the degrees summed the same way, the division.
``span_bounds`` is the plain version of the kernel's bounds pass.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, kernel_scope, refuse_detached

# the reference's Pallas segment sum has no reverse-mode rule (jax.grad
# through it raises), and the kernel's wrapper has none either
_NO_GRAD = ("models.gnn with use_pallas_agg False: the Pallas segment sum "
            "has no reverse-mode rule in the reference either")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "segment_sum_sorted": (ctypes.c_int, (_P, _I, _P, _I, _I, _P, _I, _P, _I,
                                          _P, _P)),
}


def _segment_sum_plain(dst, msgs, n_nodes):
    # one spare row collects every dst >= n_nodes and is dropped
    out = torch.zeros((n_nodes + 1, msgs.shape[1]), dtype=torch.float64,
                      device=msgs.device)
    out.index_add_(0, torch.clamp(dst, max=n_nodes).to(torch.int64),
                   msgs.to(torch.float64))
    return out[:n_nodes].to(torch.float32)


def _segment_twin(dst, x, n_nodes, rows=None, mean=False):
    msgs = x if rows is None else x.index_select(
        0, rows.clamp(0, x.shape[0] - 1))
    out = _segment_sum_plain(dst, msgs, n_nodes)
    if mean:
        ones = torch.ones((dst.shape[0], 1), dtype=torch.float32,
                          device=dst.device)
        out = out / torch.clamp(_segment_sum_plain(dst, ones, n_nodes),
                                min=1.0)
    return out


def twin_tolerance(dst: torch.Tensor, x: torch.Tensor, n_nodes: int,
                   rows: torch.Tensor | None = None,
                   mean: bool = False) -> torch.Tensor:
    """[n_nodes, D] float64 bound on |kernel − twin| for
    ``segment_sum_sorted(dst, x, n_nodes, rows, mean)``, derived from
    float32 rounding, not measured.

    For node v with count_v edges and A_v = Σ |message| over them (x read
    through ``rows`` when given): the kernel adds count_v terms from 0 in
    some tree, count_v − 1 roundings, each at most u = 2^-24 of a partial
    whose magnitude is at most A_v; the twin rounds its float64 sum once,
    at most u A_v. So |kernel − twin| ≤ count_v u A_v; the bound allows
    (count_v + 1) u A_v. With ``mean`` both divide by max(count_v, 1): the
    difference divides with them, and each quotient rounds once, at most
    u A_v / max(count_v, 1): (count_v + 4) u A_v / max(count_v, 1)."""
    msgs = x if rows is None else x.index_select(
        0, rows.clamp(0, x.shape[0] - 1))
    live = dst < n_nodes
    cnt = torch.bincount(dst[live].to(torch.int64),
                         minlength=n_nodes).to(torch.float64)[:n_nodes, None]
    abs_sum = _segment_sum_plain(dst, msgs.abs(), n_nodes).to(torch.float64)
    u = 2.0 ** -24
    if mean:
        return (cnt + 4.0) * u * abs_sum / torch.clamp(cnt, min=1.0)
    return (cnt + 1.0) * u * abs_sum


def span_bounds(dst: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """ptr [n_nodes + 1] int32, ptr[v] = the first edge whose dst is v or
    more (``torch.searchsorted(dst, arange(n_nodes + 1))`` on a sorted
    dst), found as the kernel's bounds pass finds them: with d(e) =
    min(dst[e], n) (d(-1) = -1, d(E) = n), edge e owns the nodes in
    (d(e - 1), d(e)]; the owner of the gap that reaches n gives the tail's
    first node T and every node from T on gets that owner."""
    n = n_nodes
    d = torch.clamp(dst.to(torch.int64), max=n)
    prev = torch.cat([d.new_full((1,), -1), d])
    cur = torch.cat([d, d.new_full((1,), n)])
    owner = torch.arange(d.shape[0] + 1, device=dst.device)
    tail = int(torch.nonzero((prev < cur) & (cur == n))[0, 0])
    gap = torch.where((prev < cur) & (cur < n), cur - prev,
                      torch.zeros_like(cur))
    start = torch.cumsum(gap, 0) - gap
    slot = torch.arange(int(gap.sum()), device=dst.device)
    pos = (torch.repeat_interleave(prev + 1, gap) + slot
           - torch.repeat_interleave(start, gap))
    ptr = torch.empty(n + 1, dtype=torch.int64, device=dst.device)
    ptr[pos] = torch.repeat_interleave(owner, gap)
    ptr[int(prev[tail]) + 1:] = tail
    return ptr.to(torch.int32)


def segment_sum_sorted(dst: torch.Tensor, x: torch.Tensor, n_nodes: int,
                       rows: torch.Tensor | None = None,
                       mean: bool = False) -> torch.Tensor:
    """out[v, :] = Σ x[row(e), :] over the edges with dst[e] == v, row(e)
    = e or, given ``rows``, rows[e] clamped into [0, x.shape[0] − 1];
    with ``mean``, divided by max(count, 1), the node's edge count.

    dst [E] int32, sorted ascending; entries ≥ ``n_nodes`` (the SENTINEL
    tail) contribute nothing. x [E, D] float32 (the messages), or [M, D]
    with rows [E] int32; any D ≥ 1. Returns [n_nodes, D] float32.
    """
    refuse_detached("segment_sum_sorted", x, _NO_GRAD)
    if x.ndim != 2 or dst.ndim != 1:
        raise ValueError("segment_sum_sorted takes dst [E] and x [rows, D]")
    if not isinstance(mean, bool):
        raise ValueError("segment_sum_sorted's mean is a bool")
    if rows is None:
        if dst.shape[0] != x.shape[0]:
            raise ValueError("segment_sum_sorted takes dst [E] and messages "
                             "[E, D]")
    elif (rows.ndim != 1 or rows.dtype != torch.int32
          or rows.shape[0] != dst.shape[0] or rows.device != x.device
          or (x.shape[0] == 0 and rows.shape[0] > 0)):
        raise ValueError("segment_sum_sorted's rows are int32 [E] on x's "
                         "device, into a non-empty x")
    with kernel_scope("segment_sum_sorted", segment_sum_sorted,
                      n_nodes * x.shape[1] > 0) as scope:
        if not dst.is_cuda:
            return _segment_twin(dst, x, n_nodes, rows, mean)
        if (dst.dtype != torch.int32 or x.dtype != torch.float32
                or not dst.is_contiguous() or not x.is_contiguous()
                or (rows is not None and not rows.is_contiguous())
                or x.device != dst.device):
            raise ValueError("segment_sum_sorted takes contiguous int32 dst "
                             "and float32 x on one CUDA device")
        n_x, d = x.shape
        out = torch.empty((n_nodes, d), dtype=torch.float32, device=dst.device)
        if scope.launches:
            scratch = torch.empty((n_nodes + 3,), dtype=torch.int32,
                                  device=dst.device)
            scope.launched()
            _build.check(_build.load(
                "segment_agg", _SIGNATURES).segment_sum_sorted(
                dst.data_ptr(), dst.shape[0], x.data_ptr(), n_x, d,
                None if rows is None else rows.data_ptr(), int(mean),
                out.data_ptr(), n_nodes, scratch.data_ptr(),
                _build.stream_of(dst)), "segment_sum_sorted")
        return out


segment_sum_sorted.launches = 0


def segment_sum_padded(dst: torch.Tensor, x: torch.Tensor, n_nodes: int,
                       rows: torch.Tensor | None = None,
                       mean: bool = False) -> torch.Tensor:
    """``segment_sum_sorted`` on any shapes (the reference pads every axis
    to its block sizes; the kernel masks its ragged edges itself):
    contiguous float32 x and int32 rows in, [n_nodes, D] float32 out."""
    refuse_detached("segment_sum_padded", x, _NO_GRAD)
    if rows is not None:
        rows = rows.to(torch.int32).contiguous()
    return segment_sum_sorted(dst.contiguous(),
                              x.to(torch.float32).contiguous(), n_nodes,
                              rows, mean)
