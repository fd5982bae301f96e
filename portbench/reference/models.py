"""The GNN forwards over one request's live subgraph, plainly: one module
a model kind, ``model_<kind>.py``, found by the configuration's ``kind``,
each with ``param_specs(model, d_in, n_classes)`` and ``forward(model, w,
x, dst, src, tf32)``. The shared pieces live here.

Weights are a dict by the names ``param_specs`` gives, in the [d_in, d_out]
layout (``h @ W``). Rows are the live new ids 0 .. n_unique - 1; edges the
live (dst, src) pairs. Neighbour sums accumulate in float64 and are cast
back; matmuls run in float32 (the precision the configurations state,
TF32 off). With ``tf32`` every matmul operand is first rounded to TF32's
10-bit mantissa, round to nearest even, with the products summed in
float32: the control, one precision below the stated one.
"""
from __future__ import annotations

import importlib

import torch


def for_kind(kind: str):
    """The reference module of a ``kind`` model."""
    try:
        return importlib.import_module(f"{__package__}.model_{kind}")
    except ModuleNotFoundError as exc:
        raise ValueError(f"no reference forward for model kind {kind!r}"
                         ) from exc


def param_specs(model: dict, d_in: int, n_classes: int
                ) -> list[tuple[str, tuple[int, ...], str]]:
    """(name, shape, init) of every parameter of the configured model."""
    return for_kind(model["kind"]).param_specs(model, d_in, n_classes)


def forward(model: dict, w, x, dst, src, tf32: bool = False):
    return for_kind(model["kind"]).forward(model, w, x, dst, src, tf32)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    if tf32:
        a, b = round_tf32(a), round_tf32(b)
    return a @ b


def seg_sum(x: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n,) + x.shape[1:], dtype=torch.float64,
                      device=x.device)
    return out.index_add_(0, dst, x.to(torch.float64))


def layer_norm(x, scale, bias, eps=1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias
