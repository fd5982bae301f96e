"""Mesh construction (port of ``repro/launch/mesh.py``).

Functions, not module-level meshes: importing this module touches no
process group. ``make_production_mesh`` needs a world of its size (one
process a card, ``torch.distributed`` already initialized by the
launcher); ``make_local_mesh`` makes the one-rank mesh with the
production axis names, initializing a world-1 group through an
in-process ``HashStore`` when none exists (NCCL for ``"cuda"``, gloo for
``"cpu"``): no TCP port is opened.

The roofline constants are an H100 SXM's (its data sheet), the figures
the port's bounds use (``chip_smoke.py``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def production_mesh_shape(multi_pod: bool = False):
    """(shape, axis names) of the production mesh: (16, 16) ``data`` ×
    ``model``, or (2, 16, 16) ``pod`` × ``data`` × ``model``."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh of cards; the world must be its size."""
    shape, axes = production_mesh_shape(multi_pod)
    return init_device_mesh("cuda", shape, mesh_dim_names=axes)


class DescribedMesh:
    """A mesh's axis names and sizes alone (``mesh_dim_names``, ``ndim``,
    ``size(i)``): what the placement rules read, with no process group
    and no card (the dry run's meshes)."""

    def __init__(self, shape, names):
        if len(shape) != len(names):
            raise ValueError("one axis name a mesh dim")
        self.shape, self.mesh_dim_names = tuple(shape), tuple(names)
        self.ndim = len(self.shape)

    def size(self, i: int) -> int:
        return self.shape[i]

    def __repr__(self) -> str:
        return f"DescribedMesh({self.shape}, {self.mesh_dim_names})"


def make_local_mesh(device: str = "cuda"):
    """A (1, 1) ``data`` × ``model`` mesh on one rank."""
    if not dist.is_initialized():
        if device == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("make_local_mesh('cuda') needs a card")
            torch.cuda.set_device(0)
        dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    return init_device_mesh(device, (1, 1), mesh_dim_names=("data", "model"))


# H100 SXM per card (data sheet)
PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense bf16 tensor cores
PEAK_FLOPS_F32 = 67e12  # FLOP/s, float32 without tensor cores
HBM_BW = 3.35e12  # B/s
