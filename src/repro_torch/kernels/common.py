"""Shared plain-torch helpers of the kernels (port of
``repro/kernels/common.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.graph import SENTINEL  # noqa: F401  (re-exported)


def prefix_sum_tree(x: torch.Tensor, axis: int = 0,
                    exclusive: bool = False) -> torch.Tensor:
    """Hillis–Steele inclusive scan as ceil(log₂ n) shift+add layers — the
    UPE adder hierarchy; equal to ``torch.cumsum`` on integers."""
    n = x.shape[axis]
    y = x
    d = 1
    while d < n:
        shifted = torch.narrow(y, axis, 0, n - d)
        pad = [0, 0] * (y.ndim - 1 - (axis % y.ndim)) + [d, 0]
        y = y + F.pad(shifted, pad)
        d *= 2
    return y - x if exclusive else y


def pad_pow2_1d(x: torch.Tensor, multiple: int, fill) -> torch.Tensor:
    """Pad a 1-D tensor up to a multiple of ``multiple`` with ``fill``."""
    pad = (-x.shape[0]) % multiple
    if pad == 0:
        return x
    return torch.cat([x, torch.full((pad,), fill, dtype=x.dtype,
                                    device=x.device)])
