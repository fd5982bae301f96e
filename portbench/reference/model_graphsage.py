"""GraphSAGE (arXiv:1706.02216), mean aggregator: per layer
``h = h W_self + mean_{u in N(v)} h_u W_nb + b``; ReLU and L2 row
normalisation between layers; logits ``h W_head``."""
from __future__ import annotations

import torch

from .models import mm, seg_sum


def param_specs(model: dict, d_in: int, n_classes: int) -> list:
    d, width, specs = model["d_hidden"], d_in, []
    for i in range(model["n_layers"]):
        specs += [(f"layers.{i}.w_self", (width, d), "dense"),
                  (f"layers.{i}.w_nb", (width, d), "dense"),
                  (f"layers.{i}.b", (d,), "bias")]
        width = d
    return specs + [("head", (d, n_classes), "dense")]


def forward(model: dict, w, x, dst, src, tf32: bool = False):
    n, n_layers = x.shape[0], model["n_layers"]
    deg = seg_sum(torch.ones((dst.shape[0], 1), device=x.device), dst, n)
    h = x
    for i in range(n_layers):
        agg = (seg_sum(h[src], dst, n) / deg.clamp(min=1.0)).to(torch.float32)
        h = (mm(h, w[f"layers.{i}.w_self"], tf32)
             + mm(agg, w[f"layers.{i}.w_nb"], tf32) + w[f"layers.{i}.b"])
        if i < n_layers - 1:
            h = torch.relu(h)
            h = h / torch.linalg.norm(h, dim=-1, keepdim=True).clamp(min=1e-6)
    return mm(h, w["head"], tf32)
