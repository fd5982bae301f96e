"""The process groups of a mesh's axes (explicit SPMD's collectives).

A mesh here is a ``torch.distributed`` ``DeviceMesh`` whose
``mesh_dim_names`` are the reference's axis names (``data``, ``model``,
``pod``). A collective over the data-parallel axes goes to the group of
their product: one mesh dim's own group, or, where the dp axes are
several, the flattened group of their product (made once a mesh, by
every rank together). Something that is not a ``DeviceMesh``, or a
mesh whose default process group is not initialized, raises.

``Reduce`` is the one seam of a stage's all-reduces: on a group it
all-reduces this rank's value; with no group one process holds every
rank's value and folds them in rank order (how one card runs the ranks
in turn). A sharded body is written once over it.

Every collective here (and the rank-by-rank gather of ``engine/shard.py``,
which stands in for one) tells ``note_collective`` its kind and operand
bytes, which a census (``analysis/census.py``) on this thread records.
"""
from __future__ import annotations

import threading

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn

from .sharding import _axes_size, axis_names, dp_axes

_DP_GROUPS: dict = {}
_RECORDER = threading.local()


def set_collective_recorder(recorder) -> object:
    """Make ``recorder(kind, nbytes)`` hear every collective this thread
    issues (None: none); returns the one it replaces."""
    old = getattr(_RECORDER, "fn", None)
    _RECORDER.fn = recorder
    return old


def note_collective(kind: str, t: torch.Tensor) -> None:
    """One collective of ``kind`` ("all-gather", "all-reduce") on this
    rank's operand ``t``: its bytes go to the thread's recorder, if any."""
    fn = getattr(_RECORDER, "fn", None)
    if fn is not None:
        fn(kind, t.numel() * t.element_size())


def check_mesh(mesh) -> None:
    """Raise unless ``mesh`` is a ``DeviceMesh`` over an initialized
    default process group."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"a mesh is a torch.distributed DeviceMesh, not "
                        f"{type(mesh).__name__}")
    if not dist.is_initialized():
        raise RuntimeError("the mesh's process group is not initialized "
                           "(torch.distributed.init_process_group)")


def check_device(mesh, t: torch.Tensor) -> None:
    """Raise unless ``t`` lies on the mesh's device type: nothing carries
    on on the CPU when a mesh names CUDA."""
    if t.device.type != mesh.device_type:
        raise ValueError(f"a tensor on {t.device} under a "
                         f"{mesh.device_type} mesh")


def dp_size(mesh) -> int:
    return _axes_size(mesh, dp_axes(mesh))


def dp_rank(mesh) -> int:
    """This rank's row-major index over the dp axes."""
    coord = mesh.get_coordinate()
    names = axis_names(mesh)
    r = 0
    for i, a in enumerate(names):
        if a != "model":
            r = r * mesh.size(i) + coord[i]
    return r


def model_rank(mesh) -> int:
    names = axis_names(mesh)
    return mesh.get_coordinate()[names.index("model")] \
        if "model" in names else 0


def dp_group(mesh, axes: tuple[str, ...] | None = None):
    """The process group over the dp axes (or over ``axes``: the group of
    their product)."""
    check_mesh(mesh)
    dp = dp_axes(mesh) if axes is None else tuple(axes)
    if len(dp) == 1:
        return mesh.get_group(dp[0])
    key = (id(mesh), dp)
    if key not in _DP_GROUPS:
        _DP_GROUPS[key] = (mesh, mesh[dp]._flatten().get_group())
    return _DP_GROUPS[key][1]


def model_group(mesh):
    check_mesh(mesh)
    return mesh.get_group("model")


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors ``t`` (one shape) concatenated along ``dim`` in
    group-rank order."""
    note_collective("all-gather", t)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class Reduce:
    """The all-reduces of a sharded stage over the values this process
    holds (a list): on a process group, the one value of this rank,
    all-reduced over it; with no group, every rank's value, folded in rank
    order. ``sum(..., grad=True)`` is differentiable (``torch.distributed
    .nn``'s all-reduce on a group)."""

    def __init__(self, group=None):
        self.group = group

    def _fold(self, ts, op):
        note_collective("all-reduce", ts[0])
        out = ts[0]
        for t in ts[1:]:
            out = op(out, t)
        return out

    def max(self, ts: list) -> torch.Tensor:
        if self.group is None:
            return self._fold(ts, torch.maximum)
        (t,) = ts
        note_collective("all-reduce", t)
        t = t.detach().clone()
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def sum(self, ts: list, grad: bool = False) -> torch.Tensor:
        if self.group is None:
            return self._fold(ts, torch.add)
        (t,) = ts
        note_collective("all-reduce", t)
        if grad:
            return dist_fn.all_reduce(t, group=self.group)
        t = t.detach().clone()
        dist.all_reduce(t, group=self.group)
        return t
