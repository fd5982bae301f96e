"""Shared model components (port of the parts of ``repro/models/common.py``
the LM and GNN paths run): seeded initialisers, RMSNorm, LayerNorm, the
plain and the gated MLP, the logit softcap and the cross entropy.

Weights keep the reference's layout, ``x @ W`` with ``W`` shaped
[d_in, d_out], so a parameter tree from the reference loads without
transposes.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def seeded_generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``; on ``meta`` (shapes
    alone: nothing is drawn or allocated) the CPU's."""
    device = torch.device(device)
    return torch.Generator(
        device="cpu" if device.type == "meta" else device).manual_seed(seed)


def normal_init(generator: torch.Generator, shape, scale: float,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """N(0, 1) × ``scale`` of ``shape``, drawn in float32 by ``generator``
    on ``device`` (the generator's device), then cast; on ``meta`` an
    empty tensor (nothing drawn)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, device=None,
               scale: float | None = None) -> torch.Tensor:
    """N(0, 1) × ``scale`` (default 1/√d_in) [d_in, d_out]
    (``normal_init``)."""
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return normal_init(generator, (d_in, d_out), s, dtype, device)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype=torch.float32, device=None) -> torch.Tensor:
    return normal_init(generator, (vocab, d), 0.02, dtype, device)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             zero_centered: bool = False) -> torch.Tensor:
    """RMSNorm in float32; with ``zero_centered`` the weight is
    ``1 + scale``, rounded in the parameter's dtype before the product."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    w = (1.0 + scale) if zero_centered else scale
    return (x * w).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32 (biased variance), cast back to ``x``'s
    dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(dt)


def mlp_init(generator: torch.Generator, dims: tuple[int, ...],
             dtype=torch.float32, device=None,
             bias: bool = True) -> dict[str, torch.Tensor]:
    """Plain MLP, dims = (in, h1, ..., out): ``w{i}`` [dims[i],
    dims[i+1]] from ``dense_init``, ``b{i}`` zeros (the reference's
    keys)."""
    p = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        p[f"w{i}"] = dense_init(generator, a, b, dtype, device)
        if bias:
            p[f"b{i}"] = torch.zeros((b,), dtype=dtype, device=device)
    return p


def mlp_apply(p, x: torch.Tensor, act=torch.relu,
              final_act: bool = False) -> torch.Tensor:
    """``x @ w0 + b0``, ``act``, ... through every ``w{i}`` of ``p``;
    ``act`` after the last layer only with ``final_act``."""
    n = sum(1 for k in p.keys() if k.startswith("w"))
    for i in range(n):
        x = x @ p[f"w{i}"]
        if f"b{i}" in p:
            x = x + p[f"b{i}"]
        if i < n - 1 or final_act:
            x = act(x)
    return x


def glu_init(generator: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.float32, device=None) -> dict[str, torch.Tensor]:
    return {
        "w_gate": dense_init(generator, d_model, d_ff, dtype, device),
        "w_in": dense_init(generator, d_model, d_ff, dtype, device),
        "w_out": dense_init(generator, d_ff, d_model, dtype, device),
    }


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def glu_apply(w_gate: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
              x: torch.Tensor, act=F.silu) -> torch.Tensor:
    return (act(x @ w_gate) * (x @ w_in)) @ w_out


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# up to this many classes the label's logit is picked by a comparison
PICK_BY_COMPARE = 1024


def _label_logit(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits[..., labels]: for a few classes (a GNN head) by comparing the
    class ids with the label, so the backward is elementwise (a gather's
    is a scatter); for a vocabulary by ``torch.gather``. The same bits
    either way: the row sum adds exact zeros to the one picked logit."""
    labels = labels.to(torch.int64)
    if logits.shape[-1] > PICK_BY_COMPARE:
        return torch.gather(logits, -1, labels[..., None])[..., 0]
    hit = labels[..., None] == torch.arange(logits.shape[-1],
                                            device=logits.device)
    return torch.where(hit, logits, torch.zeros_like(logits)).sum(-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross entropy; logits [..., V] upcast to float32, labels
    integer [...]; with ``mask``, the mean over the masked-in tokens."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    nll = lse - _label_logit(logits, labels)
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
