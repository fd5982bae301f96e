"""The GNN forward's pointer segment sum as a column scan (no Pallas
counterpart: the reference computes ``_ptr_seg_sum`` in jnp,
``repro/models/gnn.py``).

``ptr_seg_sum`` launches the kernel of ``csrc/ptr_scan.cu`` on CUDA tensors
and runs its plain twin on CPU tensors. Both compute the reference's
prefix-difference arithmetic, ``cs[ptr[1:]] - cs[ptr[:-1]]`` over the
prefix sum ``cs`` of the message rows with a zero row in front; they add in
other orders (the kernel in fixed row chunks plus a carry, the twin in
``torch.cumsum``'s order), so they agree within float32 rounding of the
prefix, not bit for bit. The kernel's chunking depends on the shape alone,
so a lane gives the same bits batched and alone.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build, count_launch

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ptr_seg_sum": (ctypes.c_int, (_P, _I, _I, _P, _I, _I, _P, _P, _P, _P,
                                   _P)),
}


def scan_chunk(n_rows: int) -> int:
    """Rows of one chunk of the kernel's scan: 512, or more so that no
    column carries over more than 1024 chunks (its carry scan is
    sequential)."""
    need = -(-n_rows // 1024)
    return max(512, 1 << max(0, need - 1).bit_length())


def _ptr_seg_sum_plain(ptr, msgs):
    cs = F.pad(torch.cumsum(msgs, dim=0), (0, 0, 1, 0))
    p = ptr.to(torch.int64)
    return cs.index_select(0, p[1:]) - cs.index_select(0, p[:-1])


def ptr_seg_sum(ptr: torch.Tensor, msgs: torch.Tensor) -> torch.Tensor:
    """out[i, :] = cs[ptr[i + 1], :] - cs[ptr[i], :], cs the float32 prefix
    sum of ``msgs`` along its rows with a zero row in front.

    ptr [N + 1] int32, sorted, every entry in [0, E]; msgs [E, D] float32.
    Returns [N, D] float32.
    """
    if msgs.ndim != 2 or ptr.ndim != 1 or ptr.shape[0] < 1:
        raise ValueError("ptr_seg_sum takes ptr [N + 1] and msgs [E, D]")
    if not msgs.is_cuda:
        return _ptr_seg_sum_plain(ptr, msgs)
    if (ptr.dtype != torch.int32 or msgs.dtype != torch.float32
            or not ptr.is_contiguous() or not msgs.is_contiguous()
            or ptr.device != msgs.device):
        raise ValueError("ptr_seg_sum takes contiguous int32 ptr and float32 "
                         "msgs on one CUDA device")
    e, d = msgs.shape
    n = ptr.shape[0]
    dev = msgs.device
    out = torch.empty((n - 1, d), dtype=torch.float32, device=dev)
    if out.numel():
        chunk = scan_chunk(e)
        first = torch.empty(e, dtype=torch.int32, device=dev)
        totals = torch.empty((-(-e // chunk), d), dtype=torch.float32,
                             device=dev)
        table = torch.empty((n, d), dtype=torch.float32, device=dev)
        count_launch(ptr_seg_sum)
        _build.check(_build.load("ptr_scan", _SIGNATURES).ptr_seg_sum(
            msgs.data_ptr(), e, d, ptr.data_ptr(), n, chunk, out.data_ptr(),
            first.data_ptr(), totals.data_ptr(), table.data_ptr(),
            _build.stream_of(msgs)), "ptr_seg_sum")
    return out


ptr_seg_sum.launches = 0


def twin_tolerance(ptr: torch.Tensor, msgs: torch.Tensor) -> torch.Tensor:
    """[N, D] float64 bound on |kernel − twin| for ``ptr_seg_sum(ptr,
    msgs)``, derived from float32 rounding, not measured.

    Let U_c be the float32 ulp at twice the column's largest exact |prefix|
    M_c (every partial either version forms, prefix or chunk-local, lies
    within 2 M_c, so each of its roundings errs by at most U_c / 2), and
    len_i = ptr[i + 1] − ptr[i]. The twin's cs[b] − cs[a] carries its len
    roundings between a and b plus the subtraction's: (len + 1) U / 2. The
    kernel's carries the same len local roundings, at most len carry
    additions between the two chunks (each crossed chunk holds a row of
    the segment), its two carry + local roundings and the subtraction's:
    (2 len + 3) U / 2. So |kernel − twin| ≤ (1.5 len + 2) U; the bound
    allows (2 len + 4) U.
    """
    p = ptr.to(torch.int64)
    m = torch.cumsum(msgs.to(torch.float64), dim=0).abs().amax(dim=0)
    _, exp = torch.frexp(2 * m)
    ulp = torch.where(m > 0, torch.ldexp(torch.ones_like(m), exp - 24),
                      torch.zeros_like(m))
    seg = (p[1:] - p[:-1]).to(torch.float64)
    return (2 * seg + 4)[:, None] * ulp[None, :]
