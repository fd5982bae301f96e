"""AdamW and SGD with momentum (port of ``repro/train/optim.py``).

The reference rebuilds its parameter and moment trees each step; here
``adamw_update`` writes the parameters and the moments in place under
``torch.no_grad()``, one leaf at a time, and a leaf of more than
``SLICE_ELEMS`` elements in slices of its first axis, so a full-width
model holds at most one slice's float32 temporaries at once (grok-1's
[8, 6144, 32768] expert leaf: one expert). Every operation but the
global norm, taken once over whole leaves, is element-wise, so a slice's
elements go through the same float32 operations in the same order: the
bits are the whole leaf's. The global norm reads each leaf where it lies
(``torch.linalg.vector_norm`` accumulating in float32: on the card a
bf16 leaf is read as it is, with no float32 copy of it). The arithmetic
is the
reference's: the global-norm clip, the linear warmup, the bias
corrections, the update ``u + weight_decay · p`` in float32, parameters
cast back to their dtype, moments stored in ``mom_dtype``. Parameters and
gradients are dictionaries name → tensor (``dict(model
.named_parameters())``); the state is ``{"m": {name: t}, "v": {name: t},
"step": int32 scalar tensor on the CPU}``; SGD's ``{"mom": {name: t},
"step": ...}``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


# elements of a leaf's slice in adamw_update (2^28: 1 GiB of float32 a
# temporary), read at each call
SLICE_ELEMS = 1 << 28


def leaf_slices(shape, slice_elems: int) -> list:
    """The slices of the first axis a leaf of ``shape`` is updated in:
    ``[None]`` (whole) up to ``slice_elems`` elements, else as many rows a
    slice as fit (at least one)."""
    numel = int(np.prod(shape)) if shape else 1
    if numel <= slice_elems:
        return [None]
    rows = max(1, slice_elems // max(1, numel // shape[0]))
    return [slice(i, min(i + rows, shape[0]))
            for i in range(0, shape[0], rows)]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    # bf16 moments halve the optimizer's memory for 100B+ models
    mom_dtype: torch.dtype = torch.float32


def _schedule(cfg: AdamWConfig, step: int) -> np.float32:
    """The learning rate at ``step`` (linear warmup), in float32 as the
    reference computes it."""
    warm = np.minimum(np.float32(1.0),
                      np.float32(step + 1) / np.float32(max(cfg.warmup_steps,
                                                            1)))
    return np.float32(cfg.lr) * warm


def adamw_init(params: dict[str, torch.Tensor],
               mom_dtype=torch.float32) -> dict:
    """Zero moments in ``mom_dtype`` on each parameter's device, step 0."""
    return {"m": {n: torch.zeros(p.shape, dtype=mom_dtype, device=p.device)
                  for n, p in params.items()},
            "v": {n: torch.zeros(p.shape, dtype=mom_dtype, device=p.device)
                  for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32)}


def global_norm(tensors: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ ‖g‖²), each leaf's norm accumulated in float32 (no float32
    copy of a bf16 leaf on the card); a 0-d float32 tensor on the
    tensors' device."""
    sq = [torch.linalg.vector_norm(g, dtype=torch.float32).square()
          for g in tensors.values()]
    return torch.sqrt(torch.stack(sq).sum())


def _adamw_leaf(cfg: AdamWConfig, p, g, m, v, scale, lr: float, bc1: float,
                bc2: float) -> None:
    """The update of one leaf (or slice of one) in place."""
    g = g.to(torch.float32) * scale
    m32 = m.to(torch.float32)  # m itself when the moments are float32
    v32 = v.to(torch.float32)
    m32.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
    v32.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
    del g
    denom = (v32 / bc2).sqrt_().add_(cfg.eps)
    u = (m32 / bc1).div_(denom)
    del denom
    p32 = p.to(torch.float32)  # p itself when p is float32
    u.add_(p32, alpha=cfg.weight_decay)
    p32.sub_(u, alpha=lr)
    del u
    for dst, src in ((p, p32), (m, m32), (v, v32)):
        if dst is not src:
            dst.copy_(src)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: dict[str, torch.Tensor],
                 state: dict, params: dict[str, torch.Tensor]) -> dict:
    """One AdamW step: writes ``params`` and ``state`` in place, a leaf in
    the slices of ``leaf_slices(shape, SLICE_ELEMS)``, and returns the
    metrics ``{"grad_norm": 0-d tensor, "lr": float}``."""
    step = int(state["step"])
    gn = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-12),
                         max=1.0) if cfg.grad_clip else 1.0)
    lr = float(_schedule(cfg, step))
    t = np.float32(step + 1)
    bc1 = float(np.float32(1.0) - np.float32(cfg.b1) ** t)
    bc2 = float(np.float32(1.0) - np.float32(cfg.b2) ** t)
    for name, p in params.items():
        for sl in leaf_slices(tuple(p.shape), SLICE_ELEMS):
            _adamw_leaf(cfg, *(x if sl is None else x[sl] for x in (
                p, grads[name], state["m"][name], state["v"][name])),
                scale, lr, bc1, bc2)
    state["step"].add_(1)
    return {"grad_norm": gn, "lr": lr}


@dataclasses.dataclass(frozen=True)
class SGDConfig:
    lr: float = 1e-2
    momentum: float = 0.9


def sgd_init(params: dict[str, torch.Tensor]) -> dict:
    """Zero float32 momenta on each parameter's device, step 0."""
    return {"mom": {n: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32)}


@torch.no_grad()
def sgd_update(cfg: SGDConfig, grads: dict[str, torch.Tensor], state: dict,
               params: dict[str, torch.Tensor]) -> dict:
    """One momentum-SGD step, in place: m = momentum · m + g, then p −= lr ·
    m in float32 (the product rounded before the subtraction, as the
    reference computes it), cast back to p's dtype. Returns no metrics."""
    for name, p in params.items():
        m = state["mom"][name]
        m.mul_(cfg.momentum).add_(grads[name].to(torch.float32))
        p32 = p.to(torch.float32)
        p32.sub_(m * cfg.lr)
        if p32 is not p:
            p.copy_(p32)
    state["step"].add_(1)
    return {}
