"""GNN minibatch sampler on the preprocessing engine (port of
``repro/data/sampler.py``).

The training loop's batch function converts the graph once (Ordering +
Reshaping, the configuration chosen by the service's cost model) and
makes one sampled, reindexed subgraph a step (Selecting + Reindexing), on
the device that holds the graph, through ``engine.service``'s
module-level entry points. Each batch also carries the transposed layout
of its edges (``pipeline.transpose_layout``: one more sort and pointer
build on the same kernels), which the model's backward sums over
(``models/gnn.py``); ``iter_batches(prefetch=True)`` makes batch i + 1
while the consumer trains on batch i, on a side CUDA stream on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import torch

from repro_torch.core import prng
from repro_torch.core.costmodel import EngineConfig, bitstream_library
from repro_torch.core.graph import COO, SENTINEL, take
from repro_torch.core.pipeline import gather_features, transpose_layout
from repro_torch.core.set_count import rank_in_sorted
from repro_torch.data.synthetic import batch_nodes
from repro_torch.engine.prefetch import Prefetcher, SyncBatches
from repro_torch.engine.service import PreprocService, convert_jit, sample_jit
from repro_torch.models.gnn import GraphBatch


def kernel_library() -> list[EngineConfig]:
    """The configuration library with the kernels routed: every entry of
    ``bitstream_library()`` with ``use_pallas`` (the card's sort, merge,
    rank and count kernels; their twins on the CPU, whose results are the
    same bits)."""
    return [dataclasses.replace(c, use_pallas=True)
            for c in bitstream_library()]


@dataclasses.dataclass
class SampledDataset:
    """Graph + features + labels bound to the engine service. The COO,
    ``features`` [N, Df] and ``labels`` [N] lie on one device, where every
    batch is made. ``engine_cfg`` is what the service selects from
    ``kernel_library()``."""

    coo: COO
    features: torch.Tensor  # [N, Df]
    labels: torch.Tensor  # [N]
    fanouts: tuple[int, ...]
    batch_size: int
    engine_cfg: EngineConfig = EngineConfig()
    seed: int = 0

    def __post_init__(self):
        self.service = PreprocService(self.fanouts, library=kernel_library())
        self.engine_cfg = self.service.select(self.coo, self.batch_size)
        self.csc = convert_jit(self.coo, cfg=self.engine_cfg)

    def batch(self, step: int) -> GraphBatch:
        """Deterministic f(seed, step) → sampled GraphBatch: the reference's
        fields (the batch nodes are the first ``batch_size`` new VIDs and
        the only ones with a label), ``ptr``, and the transposed layout."""
        dev = self.coo.device
        seeds = torch.from_numpy(batch_nodes(self.seed, step, self.batch_size,
                                             self.coo.n_nodes)).to(dev)
        key = prng.PRNGKey(hash((self.seed, step)) & 0x7FFFFFFF)
        sub = sample_jit(self.csc, seeds, fanouts=self.fanouts, key=key,
                         cfg=self.engine_cfg)
        feats = gather_features(sub, self.features)
        n_cap = sub.order.shape[0]
        labels = torch.where(sub.order != SENTINEL,
                             take(self.labels, sub.order),
                             torch.zeros((), dtype=self.labels.dtype,
                                         device=dev))
        mask = torch.arange(n_cap, device=dev) < self.batch_size
        # dst rebuilt from the pointers: the right rank of each position
        ptr = sub.csc.ptr[:n_cap + 1]
        pos = torch.arange(sub.csc.idx.shape[0], dtype=torch.int32,
                           device=dev)
        dst = rank_in_sorted(ptr, pos, side="right", unroll=True) - 1
        dst = torch.where(pos < sub.csc.n_edges, dst,
                          torch.full_like(dst, SENTINEL))
        rev_perm, rev_ptr = transpose_layout(sub.csc.idx, n_cap,
                                             self.engine_cfg)
        return GraphBatch(edge_dst=dst, edge_src=sub.csc.idx,
                          node_feat=feats, labels=labels, label_mask=mask,
                          ptr=ptr, rev_perm=rev_perm, rev_ptr=rev_ptr)

    def iter_batches(self, start: int = 0, stop: int | None = None,
                     prefetch: bool = True
                     ) -> Iterator[tuple[int, GraphBatch]]:
        """``(step, batch)`` pairs from ``start``; with ``prefetch`` the
        next batch is made while the consumer holds the current one. Both
        iterators close (and the producer stops) on ``close()``, on
        exhaustion, or as a context manager."""
        if prefetch:
            return Prefetcher(self.batch, start=start, stop=stop)
        return SyncBatches(self.batch, start=start, stop=stop)
