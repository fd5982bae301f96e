"""repro_torch.engine — the preprocessing engine as a service (port of
``repro/engine``).

* ``service``  — ``PreprocService``: workload profiling, Table-I
  cost-model scoring of the configuration library, pow2 buckets, and
  dispatch through one module-level table keyed by (entry point,
  ``EngineConfig.key``, input shapes).
* ``shard``    — the sharded engine: conversion cut over a mesh's
  data-parallel ranks, bit-identical to the single-device pipeline.
* ``prefetch`` — double buffering: batch ``i + 1`` is made while the
  consumer works on batch ``i``, on a side CUDA stream on the card.

``core/reconfig.py`` (AutoPre / StatPre / DynPre) dispatches through the
same table.
"""
from .prefetch import Prefetcher, SyncBatches, prefetch_batches
from .service import (PreprocService, ServiceStats, convert_jit,
                      preprocess_cache_size, preprocess_jit, sample_jit)

__all__ = [k for k in dir() if not k.startswith("_")]
