"""The GNN aggregation over dst-sorted edges (port of
``segment_sum_sorted`` in ``repro/kernels/segment_agg.py`` and
``segment_sum_padded`` in ``repro/kernels/ops.py``).

``segment_sum_sorted`` launches the kernel of ``csrc/segment_agg.cu`` on
CUDA tensors and runs its plain twin on CPU tensors. Both are
deterministic: the kernel sums each output in edge order with no atomics;
the twin sums in float64 with ``index_add_`` and rounds once to float32.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, count_launch

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "segment_sum_sorted": (ctypes.c_int, (_P, _I, _P, _I, _P, _I, _P)),
}


def _segment_sum_plain(dst, msgs, n_nodes):
    # one spare row collects every dst >= n_nodes and is dropped
    out = torch.zeros((n_nodes + 1, msgs.shape[1]), dtype=torch.float64,
                      device=msgs.device)
    out.index_add_(0, torch.clamp(dst, max=n_nodes).to(torch.int64),
                   msgs.to(torch.float64))
    return out[:n_nodes].to(torch.float32)


def segment_sum_sorted(dst: torch.Tensor, messages: torch.Tensor,
                       n_nodes: int) -> torch.Tensor:
    """out[v, :] = Σ messages[e, :] over the edges with dst[e] == v.

    dst [E] int32, sorted ascending; entries ≥ ``n_nodes`` (the SENTINEL
    tail) contribute nothing. messages [E, D] float32, any D ≥ 1. Returns
    [n_nodes, D] float32.
    """
    if messages.ndim != 2 or dst.shape[0] != messages.shape[0]:
        raise ValueError("segment_sum_sorted takes dst [E] and messages "
                         "[E, D]")
    if not dst.is_cuda:
        return _segment_sum_plain(dst, messages, n_nodes)
    if (dst.dtype != torch.int32 or messages.dtype != torch.float32
            or not dst.is_contiguous() or not messages.is_contiguous()
            or messages.device != dst.device):
        raise ValueError("segment_sum_sorted takes contiguous int32 dst and "
                         "float32 messages on one CUDA device")
    e, d = messages.shape
    out = torch.empty((n_nodes, d), dtype=torch.float32, device=dst.device)
    if out.numel():
        count_launch(segment_sum_sorted)
        _build.check(_build.load("segment_agg", _SIGNATURES).segment_sum_sorted(
            dst.data_ptr(), e, messages.data_ptr(), d, out.data_ptr(), n_nodes,
            _build.stream_of(dst)), "segment_sum_sorted")
    return out


segment_sum_sorted.launches = 0


def segment_sum_padded(dst: torch.Tensor, messages: torch.Tensor,
                       n_nodes: int) -> torch.Tensor:
    """``segment_sum_sorted`` on any shapes (the reference pads every axis
    to its block sizes; the kernel masks its ragged edges itself):
    contiguous float32 messages in, [n_nodes, D] float32 out."""
    return segment_sum_sorted(dst.contiguous(),
                              messages.to(torch.float32).contiguous(),
                              n_nodes)
