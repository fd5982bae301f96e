"""Gradient compression for a cross-node all-reduce: int8 with error
feedback (port of ``repro/train/compress.py``).

Each tensor is quantized with its own scale after the residual of the
previous step is added back (error feedback), so the int8 traffic (a
quarter of float32's) leaves convergence unchanged. The quantizer and its
inverse are ported bit for bit: ``torch.round`` rounds half to even like
``jnp.round``, and the division is float32. The all-reduce itself (a
scale max and an int32 sum over a process group) waits for the
multi-device engine, ROADMAP.md A.9.
"""
from __future__ import annotations

import torch

_A9 = ("the compressed all-reduce needs collectives: the multi-device "
       "engine is ROADMAP.md A.9")


def quantize_ef(g: torch.Tensor, err: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(int8 values, the float32 0-d scale, the new float32 error) of g
    plus the carried error ``err``: scale = max(max |g + err|, 1e-12) /
    127, values round((g + err) / scale) clipped to ±127."""
    gf = g.to(torch.float32) + err
    scale = torch.clamp(torch.amax(torch.abs(gf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale, gf - q.to(torch.float32) * scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def zeros_like_error(grads: dict[str, torch.Tensor]
                     ) -> dict[str, torch.Tensor]:
    """Zero float32 error buffers, one per gradient, on its device."""
    return {n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for n, g in grads.items()}


def compressed_psum_tree(grads, errs, axis_name: str):
    raise NotImplementedError(_A9)


def make_compressed_allreduce(mesh, grads_spec, axis: str = "pod"):
    raise NotImplementedError(_A9)
