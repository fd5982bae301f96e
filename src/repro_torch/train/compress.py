"""Gradient compression for a cross-node all-reduce: int8 with error
feedback (port of ``repro/train/compress.py``).

Each tensor is quantized with its own scale after the residual of the
previous step is added back (error feedback), so the int8 traffic (a
quarter of float32's) leaves convergence unchanged. The quantizer and its
inverse are ported bit for bit: ``torch.round`` rounds half to even like
``jnp.round``, and the division is float32. The all-reduce is two
collectives a tensor over a process group, in the reference's order: an
all-reduce MAX of the clamped ``max |g + err|`` (so every rank
dequantizes with one scale), then an all-reduce SUM of the int32 values,
divided by the group's size.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


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


def _tree_map2(fn, a, b):
    """(fn over paired leaves of two trees of one structure): two trees."""
    if isinstance(a, dict):
        pairs = {k: _tree_map2(fn, a[k], b[k]) for k in a}
        return ({k: v[0] for k, v in pairs.items()},
                {k: v[1] for k, v in pairs.items()})
    if isinstance(a, (list, tuple)):
        pairs = [_tree_map2(fn, x, y) for x, y in zip(a, b)]
        return (type(a)(p[0] for p in pairs), type(a)(p[1] for p in pairs))
    return fn(a, b)


def compressed_psum_tree(grads, errs, group):
    """The int8 all-reduce with error feedback of every leaf of ``grads``
    (a tree of dicts, lists and tensors) over the process ``group``: each
    rank quantizes g + err with the group's largest scale, the int32
    values are summed, and the sum is dequantized and divided by the
    group's size. Returns (the mean-reduced gradients in each leaf's
    dtype, the new float32 error tree), the reference's bits."""
    n = dist.get_world_size(group)

    def one(g, e):
        gf = g.to(torch.float32) + e
        s = torch.clamp(torch.amax(torch.abs(gf)), min=1e-12)
        dist.all_reduce(s, op=dist.ReduceOp.MAX, group=group)
        scale = s / 127.0
        q = torch.clamp(torch.round(gf / scale), -127, 127)
        new_err = gf - q * scale
        summed = q.to(torch.int32)
        dist.all_reduce(summed, group=group)
        return (summed.to(torch.float32) * scale / n).to(g.dtype), new_err

    return _tree_map2(one, grads, errs)


def make_compressed_allreduce(mesh, grads_spec, axis: str = "pod"):
    """``fn(grads, errs)``: ``compressed_psum_tree`` over the mesh axis
    ``axis``'s group. Each rank passes its shards (placed as
    ``grads_spec`` says, which the element-wise reduction leaves as they
    are)."""
    from repro_torch.dist.groups import check_mesh
    check_mesh(mesh)
    group = mesh.get_group(axis)

    def fn(grads, errs):
        return compressed_psum_tree(grads, errs, group)

    return fn
