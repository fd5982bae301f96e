"""GatedGCN (arXiv:2003.00982) with zero initial edge states: per layer
``e' = (h W_A)_dst + (h W_B)_src + e W_C``, ``g = sigmoid(e')``,
``h' = h W_U + sum g (h W_V)_src / (sum g + 1e-6)``, then
``h += relu(LN(h'))``, ``e += relu(LN(e'))`` (LayerNorm eps 1e-5, biased
variance); node embedding ``x W_embed``, logits ``h W_head``."""
from __future__ import annotations

import torch

from .models import layer_norm, mm, seg_sum


def param_specs(model: dict, d_in: int, n_classes: int) -> list:
    d = model["d_hidden"]
    specs = [("embed_n", (d_in, d), "dense"), ("embed_e", (1, d), "dense")]
    for i in range(model["n_layers"]):
        specs += [(f"layers.{i}.{m}", (d, d), "dense") for m in "ABCUV"]
        for s in ("h", "e"):
            specs += [(f"layers.{i}.ln_{s}_scale", (d,), "scale"),
                      (f"layers.{i}.ln_{s}_bias", (d,), "bias")]
    return specs + [("head", (d, n_classes), "dense")]


def forward(model: dict, w, x, dst, src, tf32: bool = False):
    n = x.shape[0]
    h = mm(x, w["embed_n"], tf32)
    e = torch.zeros((dst.shape[0], h.shape[1]), device=x.device)
    for i in range(model["n_layers"]):
        p = f"layers.{i}."
        e_new = (mm(h, w[p + "A"], tf32)[dst] + mm(h, w[p + "B"], tf32)[src]
                 + mm(e, w[p + "C"], tf32))
        gate = torch.sigmoid(e_new)
        num = seg_sum(gate * mm(h, w[p + "V"], tf32)[src], dst, n)
        den = seg_sum(gate, dst, n)
        h_new = mm(h, w[p + "U"], tf32) + (num / (den + 1e-6)).to(
            torch.float32)
        h = h + torch.relu(layer_norm(h_new, w[p + "ln_h_scale"],
                                      w[p + "ln_h_bias"]))
        e = e + torch.relu(layer_norm(e_new, w[p + "ln_e_scale"],
                                      w[p + "ln_e_bias"]))
    return mm(h, w["head"], tf32)
