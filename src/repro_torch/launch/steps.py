"""Step cells of the port (the prefill cell of ``repro/launch/steps.py``).

A cell is a built model plus an input batch made from a seed; calling its
``step`` runs one step. Meshes, shardings and compiled programs of the
reference's cells have no counterpart here: the port runs on one card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs import LM_SHAPES, get_config
from repro_torch.core.graph import resolve_device
from repro_torch.models.transformer import LM, lm_prefill


@dataclasses.dataclass
class PrefillCell:
    arch_id: str
    model: LM
    tokens: torch.Tensor  # [batch, seq_len] int32 on the model's device

    def step(self) -> torch.Tensor:
        """One prefill (``serve_step (prefill)``): last-position logits
        [batch, vocab]."""
        return lm_prefill(self.model, self.tokens)


def lm_prefill_cell(arch_id: str, seq_len: int | None = None,
                    batch: int | None = None, device="cuda", seed: int = 0,
                    smoke: bool = False) -> PrefillCell:
    """The ``prefill_32k`` cell of ``arch_id`` (32,768 tokens, batch 32
    unless ``seq_len`` / ``batch`` cut it): the model with random weights
    from ``seed`` on ``device`` and uniform random tokens from ``seed``."""
    shape = LM_SHAPES["prefill_32k"]
    seq_len = shape["seq_len"] if seq_len is None else seq_len
    batch = shape["global_batch"] if batch is None else batch
    cfg = get_config(arch_id, smoke=smoke)
    dev = resolve_device(device)
    model = LM(cfg, seed=seed, device=dev)
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab,
                                                  (batch, seq_len))
    return PrefillCell(arch_id, model,
                       torch.from_numpy(tokens.astype(np.int32)).to(dev))
