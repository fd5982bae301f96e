"""Distribution layer on ``torch.distributed`` (port of ``repro/dist``).

Every rank runs the same program and holds its own shard of each tensor
as a plain tensor; collectives are explicit calls on a mesh's process
groups (explicit SPMD, not the reference's GSPMD).

* ``hints``       — thread-local layout state and ``shard_hint``: an
  identity on plain tensors, so the model files run unchanged on one
  device.
* ``sharding``    — placement builders for the LM, cache, DLRM and GNN
  trees, read back as the reference's ``PartitionSpec``, and the cut of
  a whole tensor to a rank's shard.
* ``groups``      — a mesh's process groups (the dp axes' product).
* ``collectives`` — head- and sequence-sharded decode attention.

``collectives`` is imported by its callers (it pulls in the kernels).
``repro/dist/compat.py`` is a ``shard_map`` shim with no counterpart.
"""
from . import hints, sharding  # noqa: F401
from .hints import (current_layout, layout, mesh_info, shard_hint,  # noqa: F401
                    suspend_hints)
from .sharding import (batch_sharding, dlrm_param_shardings,  # noqa: F401
                       dp_axes, gnn_batch_shardings, lm_cache_shardings,
                       lm_param_shardings, local_shard, model_axis_size,
                       placement_spec, replicated)

__all__ = [
    "batch_sharding", "current_layout", "dlrm_param_shardings", "dp_axes",
    "gnn_batch_shardings", "hints", "layout", "lm_cache_shardings",
    "lm_param_shardings", "local_shard", "mesh_info", "model_axis_size",
    "placement_spec", "replicated", "shard_hint", "sharding",
    "suspend_hints",
]
