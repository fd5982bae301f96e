"""The GNN forward's pointer segment sum as direct span sums (no Pallas
counterpart: the reference computes ``_ptr_seg_sum`` in jnp,
``repro/models/gnn.py``).

``ptr_seg_sum`` launches the kernel of ``csrc/ptr_scan.cu`` on CUDA tensors
and runs its plain twin on CPU tensors. The kernel sums each node's span of
rows directly, in one launch, optionally reading the rows through a gather
index (GraphSAGE's neighbour features, so the [E, D] message stream is never
written) and dividing by the span's length (the mean). The twin keeps the
reference's arithmetic, ``cs[ptr[1:]] - cs[ptr[:-1]]`` over the prefix sum
``cs`` of the rows with a zero row in front, so the two agree within float32
rounding (``twin_tolerance``), not bit for bit. The kernel's summation order
depends on each span's length alone, so a lane gives the same bits batched
and alone.

``ptr_seg_sum`` is called through ``ctypes`` and leaves no autograd
history, so under grad mode it refuses an input that requires grad.
``SpanSum`` and ``GatherRows`` are the autograd forms: each backward is
one more span sum (or a row gather), over the transposed layout of the
edges (their positions stably sorted by source, ``rev_perm``, and its
pointers, ``rev_ptr``), so no gradient is summed with float atomics.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build, kernel_scope, refuse_detached

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ptr_seg_sum": (ctypes.c_int, (_P, _I, _I, _P, _P, _I, _I, _P, _P)),
}


def _rows_of(x: torch.Tensor, rows: torch.Tensor | None) -> torch.Tensor:
    """x's rows at ``rows`` clamped into range (the forward's
    ``gather_src``), or x itself."""
    if rows is None:
        return x
    return x.index_select(0, rows.clamp(0, x.shape[0] - 1))


def _ptr_seg_sum_plain(ptr, x, rows=None, mean=False):
    cs = F.pad(torch.cumsum(_rows_of(x, rows), dim=0), (0, 0, 1, 0))
    p = ptr.to(torch.int64)
    out = cs.index_select(0, p[1:]) - cs.index_select(0, p[:-1])
    if mean:
        deg = (p[1:] - p[:-1]).to(out.dtype)[:, None]
        out = out / torch.clamp(deg, min=1.0)
    return out


def ptr_seg_sum(ptr: torch.Tensor, x: torch.Tensor,
                rows: torch.Tensor | None = None,
                mean: bool = False) -> torch.Tensor:
    """out[i, :] = Σ x[row(e), :] over e in [ptr[i], ptr[i + 1]), row(e) = e
    or, given ``rows``, rows[e] clamped into [0, x.shape[0] − 1]; with
    ``mean``, divided by max(ptr[i + 1] − ptr[i], 1).

    ptr [N + 1] int32, sorted, every entry in [0, E]; x [E, D] float32, or
    [M, D] with rows [E] int32. Returns [N, D] float32.
    """
    refuse_detached("ptr_seg_sum", x, "kernels.ptr_scan.SpanSum (models.gnn"
                    " uses it when the batch carries its transposed layout)")
    if x.ndim != 2 or ptr.ndim != 1 or ptr.shape[0] < 1:
        raise ValueError("ptr_seg_sum takes ptr [N + 1] and x [rows, D]")
    if not isinstance(mean, bool):
        raise ValueError("ptr_seg_sum's mean is a bool")
    if rows is not None and (rows.ndim != 1 or rows.dtype != torch.int32
                             or rows.device != x.device
                             or (x.shape[0] == 0 and rows.shape[0] > 0)):
        raise ValueError("ptr_seg_sum's rows are int32 [E] on x's device, "
                         "into a non-empty x")
    with kernel_scope("ptr_seg_sum", ptr_seg_sum,
                      (ptr.shape[0] - 1) * x.shape[1] > 0) as scope:
        if not x.is_cuda:
            return _ptr_seg_sum_plain(ptr, x, rows, mean)
        if (ptr.dtype != torch.int32 or x.dtype != torch.float32
                or not ptr.is_contiguous() or not x.is_contiguous()
                or (rows is not None and not rows.is_contiguous())
                or ptr.device != x.device):
            raise ValueError("ptr_seg_sum takes contiguous int32 ptr and "
                             "float32 x on one CUDA device")
        n_x, d = x.shape
        n = ptr.shape[0]
        out = torch.empty((n - 1, d), dtype=torch.float32, device=x.device)
        if scope.launches:
            scope.launched()
            _build.check(_build.load("ptr_scan", _SIGNATURES).ptr_seg_sum(
                x.data_ptr(), n_x, d,
                None if rows is None else rows.data_ptr(),
                ptr.data_ptr(), n, int(mean), out.data_ptr(),
                _build.stream_of(x)), "ptr_seg_sum")
        return out


ptr_seg_sum.launches = 0


def _mean_scaled(g: torch.Tensor, ptr: torch.Tensor) -> torch.Tensor:
    """g's row i divided by max(ptr[i + 1] − ptr[i], 1): the mean's
    gradient, one elementwise pass before the backward's launch."""
    deg = (ptr[1:] - ptr[:-1]).to(g.dtype)[:, None]
    return g / torch.clamp(deg, min=1.0)


class SpanSum(torch.autograd.Function):
    """``ptr_seg_sum(ptr, x, rows, mean)`` with a gradient for x.

    ``dst`` [E] int32 is each edge's node (the span that holds it, clamped
    into range); ``rev_perm`` [E] int32 the edge positions stably sorted
    by ``rows`` and ``rev_ptr`` [M + 1] int32 its pointers (edges with
    rows[e] = u at rev_ptr[u] .. rev_ptr[u + 1]), over the edges below
    ptr[N] only. With g' = g (÷ max(len, 1) under ``mean``):

    * no ``rows``: gx[e] = g'[dst[e]] for e < ptr[N], 0 past it (a row
      gather, no kernel);
    * ``rows``: gx[u] = Σ g'[dst[e]] over the edges with rows[e] = u, one
      span sum over the transposed layout (``rev_ptr``, read through
      dst[rev_perm]).

    Nothing is computed for an x that needs no gradient (a feature batch).
    """

    @staticmethod
    def forward(ctx, x, ptr, rows, mean, dst, rev_perm, rev_ptr):
        ctx.save_for_backward(ptr, dst, rev_perm, rev_ptr)
        ctx.mean, ctx.fused = mean, rows is not None
        return ptr_seg_sum(ptr, x, rows, mean)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return (None,) * 7
        ptr, dst, rev_perm, rev_ptr = ctx.saved_tensors
        g = g.contiguous()
        if ctx.mean:
            g = _mean_scaled(g, ptr)
        if ctx.fused:
            rows = dst.index_select(0, rev_perm.to(torch.int64))
            gx = ptr_seg_sum(rev_ptr, g, rows)
        else:
            live = (torch.arange(dst.shape[0], device=dst.device)
                    < ptr[-1])[:, None]
            gx = torch.where(live, g.index_select(0, dst.to(torch.int64)),
                             torch.zeros((), dtype=g.dtype, device=g.device))
        return gx, None, None, None, None, None, None


class GatherRows(torch.autograd.Function):
    """``h[idx]`` (idx [E] int64, in range) with a gradient for h:
    gh[u] = Σ g[e] over the edges with idx[e] = u, one span sum of g's
    rows over ``ptr`` [N + 1] (the edges of node u at ptr[u] ..
    ptr[u + 1]), read through ``rows`` when the edges are not in idx's
    order (the transposed layout's ``rev_perm``); edges past ptr[N] give
    nothing. h [N, D] float32."""

    @staticmethod
    def forward(ctx, h, idx, ptr, rows):
        ctx.save_for_backward(ptr, rows)
        return h.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        ptr, rows = ctx.saved_tensors
        return ptr_seg_sum(ptr, g.contiguous(), rows), None, None, None


def twin_tolerance(ptr: torch.Tensor, x: torch.Tensor,
                   rows: torch.Tensor | None = None,
                   mean: bool = False) -> torch.Tensor:
    """[N, D] float64 bound on |kernel − twin| for ``ptr_seg_sum(ptr, x,
    rows, mean)``, derived from float32 rounding, not measured.

    Over the rows the sum reads, in stream order (x through ``rows`` when
    given), let M_c be the largest exact |prefix sum| of column c over the
    rows below ptr[N] (no output depends on a row at or past it), U_c the
    float32 ulp at 2 M_c, and len_i = ptr[i + 1] − ptr[i]. Every partial
    either version forms lies within 2 M_c: the twin's are prefixes up to
    ptr[N] and their differences, the kernel's are sums of contiguous
    sub-ranges of a span (a piece summed in row order, or adjacent pieces
    combined pairwise), so each rounding errs by at most U_c / 2. The twin's
    cs[b] − cs[a] carries the len roundings between a and b plus the
    subtraction's: (len + 1) U / 2. The kernel adds len rows from 0 in
    some tree: len − 1 roundings (the first addition, to 0, is exact):
    (len − 1) U / 2. So |kernel − twin| ≤ len U; the bound allows
    (2 len + 4) U, which also covers a partial rounded just past 2 M_c
    into the next binade (an ulp twice U). With ``mean`` both divide by
    max(len, 1): the difference divides with them, and each quotient
    rounds once, by at most U (its magnitude is at most 2 M_c, just past
    it after a rounding): (2 len + 4) U / max(len, 1) + 2 U.
    """
    p = ptr.to(torch.int64)
    lim = int(p[-1])
    msgs = _rows_of(x, rows)[:lim].to(torch.float64)
    m = torch.cumsum(msgs, dim=0).abs().amax(dim=0) if lim else \
        torch.zeros(x.shape[1], dtype=torch.float64, device=x.device)
    _, exp = torch.frexp(2 * m)
    ulp = torch.where(m > 0, torch.ldexp(torch.ones_like(m), exp - 24),
                      torch.zeros_like(m))
    seg = (p[1:] - p[:-1]).to(torch.float64)
    tol = (2 * seg + 4)[:, None] * ulp[None, :]
    if mean:
        tol = tol / torch.clamp(seg, min=1.0)[:, None] + 2 * ulp[None, :]
    return tol
