"""Synthetic data generators (port of ``repro/data/synthetic.py``):
deterministic functions of (seed, step), in numpy, bit-identical to the
reference's.

Determinism is the fault-tolerance contract: ``batch_fn(step)`` returns
the same batch after a restart, so nothing about data order lives in
process state.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import random_coo


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def lm_batch(seed: int, step: int, batch: int, seq: int,
             vocab: int) -> np.ndarray:
    """Uniform token ids [batch, seq] int32."""
    rng = _rng(seed, step)
    return rng.integers(0, vocab, size=(batch, seq)).astype(np.int32)


def graph_dataset(seed: int, n_nodes: int, n_edges: int, d_feat: int,
                  n_classes: int, power_law: float | None = 1.5):
    """A fixed synthetic graph for GNN training: (dst [E] int32, src [E]
    int32, features [N, d_feat] float32, labels [N] int32), all from
    step 0's generator of ``seed``."""
    rng = _rng(seed, 0)
    dst, src = random_coo(rng, n_nodes, n_edges, power_law=power_law)
    feats = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, size=(n_nodes,)).astype(np.int32)
    return dst, src, feats, labels


def batch_nodes(seed: int, step: int, batch: int,
                n_nodes: int) -> np.ndarray:
    """``batch`` distinct seed nodes [batch] int32 for ``step``."""
    rng = _rng(seed, step)
    return rng.choice(n_nodes, size=batch, replace=False).astype(np.int32)


def dlrm_batch(seed: int, step: int, batch: int, n_dense: int,
               n_sparse: int, hot: int, vocab: int):
    """A recommender batch: (dense [batch, n_dense] float32 normal,
    indices [batch, n_sparse, hot] int32 from a Zipf(1.5) law clipped into
    [0, vocab) (a power law's duplication), labels [batch] float32 0 / 1)."""
    rng = _rng(seed, step)
    dense = rng.normal(size=(batch, n_dense)).astype(np.float32)
    raw = rng.zipf(1.5, size=(batch, n_sparse, hot))
    idx = np.minimum(raw - 1, vocab - 1).astype(np.int32)
    labels = rng.integers(0, 2, size=(batch,)).astype(np.float32)
    return dense, idx, labels
