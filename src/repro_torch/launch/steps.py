"""Step cells of the port (the LM prefill and train cells of
``repro/launch/steps.py``).

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
from repro_torch.data.synthetic import lm_batch
from repro_torch.models.transformer import LM, lm_loss, lm_prefill
from repro_torch.train.optim import AdamWConfig, adamw_init, adamw_update


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


def lm_train_step(model: LM, opt_cfg: AdamWConfig, opt_state: dict,
                  tokens: torch.Tensor) -> dict:
    """One training step (the reference cell's ``train_step``): the
    gradient of ``lm_loss`` by autograd, then ``adamw_update`` in place.
    Returns ``{"loss", "grad_norm"}`` as 0-d tensors on the model's device
    and ``"lr"`` as a float; the gradients are freed."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    loss = lm_loss(model, tokens)
    loss.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in params.items()}
    metrics = adamw_update(opt_cfg, grads, opt_state, params)
    del grads
    for p in params.values():
        p.grad = None
    return {"loss": loss.detach(), **metrics}


@dataclasses.dataclass
class TrainCell:
    arch_id: str
    model: LM
    opt_cfg: AdamWConfig
    opt_state: dict  # train.optim.adamw_init's
    tokens: torch.Tensor  # [batch, seq_len] int32 on the model's device

    def step(self) -> dict:
        """One AdamW step on the cell's tokens (``train_step``):
        ``{"loss", "grad_norm", "lr"}``."""
        return lm_train_step(self.model, self.opt_cfg, self.opt_state,
                             self.tokens)


def lm_train_cell(arch_id: str, n_layers: int | None = None,
                  seq_len: int | None = None, batch: int | None = None,
                  device="cuda", seed: int = 0,
                  smoke: bool = False) -> TrainCell:
    """The ``train_4k`` cell of ``arch_id`` (4,096 tokens, batch 256,
    every layer, unless ``seq_len`` / ``batch`` / ``n_layers`` cut it):
    the model with random weights from ``seed`` on ``device``, AdamW with
    the reference cell's moments (bfloat16 when n_layers · d_model >
    200,000 or the layout is ``dp_only``, reckoned on the published
    configuration; float32 for gemma2-9b), zero state, and the tokens of
    ``lm_batch(seed, 0, ...)``."""
    shape = LM_SHAPES["train_4k"]
    seq_len = shape["seq_len"] if seq_len is None else seq_len
    batch = shape["global_batch"] if batch is None else batch
    base = get_config(arch_id, smoke=smoke)
    big = base.n_layers * base.d_model > 200_000
    opt_cfg = AdamWConfig(mom_dtype=torch.bfloat16
                          if big or base.train_layout == "dp_only"
                          else torch.float32)
    cfg = base if n_layers is None else dataclasses.replace(
        base, n_layers=n_layers)
    dev = resolve_device(device)
    model = LM(cfg, seed=seed, device=dev)
    opt_state = adamw_init(dict(model.named_parameters()), opt_cfg.mom_dtype)
    tokens = torch.from_numpy(lm_batch(seed, 0, batch, seq_len, cfg.vocab))
    return TrainCell(arch_id, model, opt_cfg, opt_state, tokens.to(dev))
