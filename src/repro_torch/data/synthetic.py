"""Synthetic data generators (port of the LM part of
``repro/data/synthetic.py``): deterministic functions of (seed, step), in
numpy, bit-identical to the reference's.

Determinism is the fault-tolerance contract: ``batch_fn(step)`` returns
the same batch after a restart, so nothing about data order lives in
process state. The DLRM and graph generators wait for their slices.
"""
from __future__ import annotations

import numpy as np


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def lm_batch(seed: int, step: int, batch: int, seq: int,
             vocab: int) -> np.ndarray:
    """Uniform token ids [batch, seq] int32."""
    rng = _rng(seed, step)
    return rng.integers(0, vocab, size=(batch, seq)).astype(np.int32)
