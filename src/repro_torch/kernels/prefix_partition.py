"""The UPE set-partition (port of ``prefix_partition`` in
``repro/kernels/prefix_partition.py``): a stable partition of each block
by a bool condition, selected elements first, plus the selected count per
block.

``prefix_partition`` launches the kernel of ``csrc/prefix_partition.cu``
on CUDA tensors and runs its plain twin on CPU tensors. The twin is the
reference kernel's body over every block at once: inclusive prefix sums of
the condition and of its complement (the adder network), then the
inverse-permutation router ``gather_sources_from_counts`` and one gather.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.set_partition import (gather_sources_from_counts,
                                            prefix_sum)

from . import _build, kernel_scope

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "prefix_partition": (ctypes.c_int, (_P, _P, _I, _I, _P, _P, _P)),
}


def _partition_plain(values, cond, block):
    v = values.reshape(-1, block)
    c = cond.reshape(-1, block).to(torch.int32)
    incl_sel = prefix_sum(c, axis=1)
    n_sel = incl_sel[:, -1]
    incl = torch.stack([incl_sel, prefix_sum(1 - c, axis=1)], dim=2)
    base = torch.stack([torch.zeros_like(n_sel), n_sel], dim=1)
    src = gather_sources_from_counts(incl, base)  # [blocks, block]
    out = v.gather(1, torch.clamp(src, 0, block - 1).to(torch.int64))
    return out.reshape(-1), n_sel


def prefix_partition(values: torch.Tensor, cond: torch.Tensor,
                     block: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise stable partition. values [N] int32, cond [N] bool, N a
    multiple of ``block``. Returns (out [N] int32: each block's selected
    values in order, then the rest in order; n_sel [N / block] int32)."""
    if (values.ndim != 1 or cond.shape != values.shape or block < 1
            or values.shape[0] % block):
        raise ValueError("prefix_partition takes values [N] and cond [N] "
                         f"with N a multiple of block ({block})")
    with kernel_scope("prefix_partition", prefix_partition,
                      values.shape[0] > 0) as scope:
        if not values.is_cuda:
            return _partition_plain(values, cond, block)
        if (values.dtype != torch.int32 or cond.dtype != torch.bool
                or not values.is_contiguous() or not cond.is_contiguous()
                or cond.device != values.device):
            raise ValueError("prefix_partition takes contiguous int32 values "
                             "and bool cond on one CUDA device")
        n = values.shape[0]
        out = torch.empty_like(values)
        n_sel = torch.empty((n // block,), dtype=torch.int32,
                            device=values.device)
        if scope.launches:
            scope.launched()
            _build.check(_build.load("prefix_partition", _SIGNATURES)
                         .prefix_partition(
                values.data_ptr(), cond.data_ptr(), n, block, out.data_ptr(),
                n_sel.data_ptr(), _build.stream_of(values)),
                "prefix_partition")
        return out, n_sel


prefix_partition.launches = 0
