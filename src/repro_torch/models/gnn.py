"""GraphSAGE over sampled subgraphs (port of the GraphSAGE path of
``repro/models/gnn.py``).

Message passing is edge gather → segment reduce. The serve path attaches
the subgraph's CSC pointers to the batch, so every reduction is the
scatter-free pointer form: one cumulative sum of the masked message stream
and a difference of prefix sums at each node's pointer span, on the
column-scan kernel (``kernels/ptr_scan.py``); under
``GNNConfig.use_pallas_agg`` it is the segment-sum kernel over the
dst-sorted edges instead (``kernels/segment_agg.py``).
``gnn_apply_batched`` stacks one forward per slot. Weights keep
the reference's layout, ``h @ W`` with ``W`` shaped [d_in, d_out], so a
parameter tree from the reference's ``gnn_init`` loads without transposes
(``load_reference_params``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from repro_torch.core.graph import SENTINEL, resolve_device, take
from repro_torch.core.pipeline import gather_features
from repro_torch.core.set_count import rank_in_sorted
from repro_torch.kernels.ptr_scan import ptr_seg_sum


@dataclasses.dataclass
class GraphBatch:
    """Static-shape graph minibatch. With ``ptr`` set (the serve path),
    ``edge_dst`` is sorted ascending and ``ptr[d] .. ptr[d+1]`` spans node
    d's incoming edges."""

    edge_dst: torch.Tensor  # [E] int32, sorted ascending, SENTINEL pad
    edge_src: torch.Tensor  # [E] int32
    node_feat: torch.Tensor  # [N, Df] float
    ptr: torch.Tensor | None = None  # [N+1] int32 CSC pointers

    @property
    def n_nodes(self) -> int:
        return self.node_feat.shape[0]


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str  # only "graphsage" is ported
    n_layers: int
    d_hidden: int
    aggregator: str = "mean"
    sample_sizes: tuple[int, ...] = ()
    dtype: torch.dtype = torch.float32
    use_pallas_agg: bool = False


def _valid(batch: GraphBatch) -> torch.Tensor:
    return batch.edge_dst < batch.n_nodes


def _ptr_seg_sum(ptr: torch.Tensor, msgs: torch.Tensor) -> torch.Tensor:
    """Scatter-free segment sum over CSC pointers: prefix-sum the masked
    message stream once, then difference it at each node's span — the
    column-scan kernel on the card, its twin (``torch.cumsum`` and two
    ``index_select``) on the CPU."""
    flat = msgs.to(torch.float32).reshape(msgs.shape[0], -1).contiguous()
    p = torch.clamp(ptr, 0, msgs.shape[0]).to(torch.int32)
    seg = ptr_seg_sum(p, flat)
    return seg.reshape((p.shape[0] - 1,) + msgs.shape[1:]).to(msgs.dtype)


def seg_sum(batch: GraphBatch, msgs: torch.Tensor,
            use_pallas: bool = False) -> torch.Tensor:
    """Σ over incoming edges per dst node; SENTINEL edges contribute 0.
    ``use_pallas`` runs the segment-sum kernel over ``edge_dst`` (which
    must then be sorted) and ignores ``ptr``."""
    msgs = torch.where(_valid(batch)[:, None], msgs,
                       torch.zeros((), dtype=msgs.dtype, device=msgs.device))
    if use_pallas:
        from repro_torch.kernels.segment_agg import segment_sum_padded
        return segment_sum_padded(batch.edge_dst, msgs,
                                  batch.n_nodes).to(msgs.dtype)
    if batch.ptr is not None:
        return _ptr_seg_sum(batch.ptr, msgs)
    dst = torch.clamp(batch.edge_dst, max=batch.n_nodes - 1).to(torch.int64)
    out = torch.zeros((batch.n_nodes,) + msgs.shape[1:], dtype=msgs.dtype,
                      device=msgs.device)
    return out.index_add_(0, dst, msgs)


def seg_mean(batch: GraphBatch, msgs: torch.Tensor,
             use_pallas: bool = False) -> torch.Tensor:
    s = seg_sum(batch, msgs, use_pallas)
    ones = torch.ones((batch.edge_dst.shape[0], 1), dtype=msgs.dtype,
                      device=msgs.device)
    deg = seg_sum(batch, ones, use_pallas)
    return s / torch.clamp(deg, min=1.0)


def gather_src(batch: GraphBatch, h: torch.Tensor) -> torch.Tensor:
    return take(h, torch.clamp(batch.edge_src, max=batch.n_nodes - 1))


class GraphSAGE(nn.Module):
    """GraphSAGE with a linear classification head.

    Per layer: ``h = h @ w_self + mean_nb(h) @ w_nb + b``, then ReLU and L2
    row normalisation on every layer but the last; ``head`` maps the last
    layer to ``n_classes`` logits. Random init draws N(0, 1/d_in) weights
    from the CPU ``generator`` (the reference's ``dense_init`` scale), so
    the values do not depend on ``device``, where they are then placed (a
    missing card raises).
    """

    def __init__(self, cfg: GNNConfig, d_in: int, n_classes: int = 0,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        if cfg.kind != "graphsage":
            raise NotImplementedError(f"GNN kind {cfg.kind!r} is not ported")
        self.cfg = cfg
        device = resolve_device(device)

        def dense(a, b):
            w = torch.randn((a, b), generator=generator, dtype=torch.float32)
            return nn.Parameter((w / math.sqrt(a)).to(device=device,
                                                      dtype=cfg.dtype))

        self.layers = nn.ModuleList()
        d = d_in
        for _ in range(cfg.n_layers):
            layer = nn.ParameterDict({
                "w_self": dense(d, cfg.d_hidden),
                "w_nb": dense(d, cfg.d_hidden),
                "b": nn.Parameter(torch.zeros(cfg.d_hidden, dtype=cfg.dtype,
                                              device=device))})
            self.layers.append(layer)
            d = cfg.d_hidden
        self.head = dense(cfg.d_hidden, n_classes) if n_classes else None

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        cfg = self.cfg
        h = batch.node_feat.to(cfg.dtype)
        for i, lp in enumerate(self.layers):
            msgs = gather_src(batch, h)
            agg = (seg_mean(batch, msgs, cfg.use_pallas_agg)
                   if cfg.aggregator == "mean"
                   else seg_sum(batch, msgs, cfg.use_pallas_agg))
            h = h @ lp["w_self"] + agg @ lp["w_nb"] + lp["b"]
            if i < cfg.n_layers - 1:
                h = torch.relu(h)
                h = h / torch.clamp(torch.linalg.norm(h, dim=-1, keepdim=True),
                                    min=1e-6)
        if self.head is not None:
            h = h @ self.head
        return h


def load_reference_params(model: GraphSAGE, params) -> GraphSAGE:
    """Carry the reference's ``gnn_init`` tree (``{"layers": [{"w_self",
    "w_nb", "b"}], "head"}``, arrays convertible by ``np.asarray``) into
    ``model``, in place; shapes must match exactly (same [d_in, d_out]
    layout, no transposes)."""
    if len(params["layers"]) != len(model.layers):
        raise ValueError("layer count differs")

    def put(dst: nn.Parameter, src):
        arr = torch.from_numpy(np.array(src, dtype=np.float32))
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"shape {tuple(arr.shape)} != {tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(arr.to(device=dst.device, dtype=dst.dtype))

    for lp, src in zip(model.layers, params["layers"]):
        for name in ("w_self", "w_nb", "b"):
            put(lp[name], src[name])
    if ("head" in params) != (model.head is not None):
        raise ValueError("head presence differs")
    if model.head is not None:
        put(model.head, params["head"])
    return model


def subgraph_batch(sub, features: torch.Tensor) -> GraphBatch:
    """Forward-ready batch from a sampled ``Subgraph``: features gathered
    through the subgraph's order, ``edge_dst`` rebuilt from the CSC
    pointers (right rank of each edge position), ``ptr`` attached."""
    feats = gather_features(sub, features)
    n_cap = sub.order.shape[0]
    e_cap = sub.csc.idx.shape[0]
    ptr = sub.csc.ptr[:n_cap + 1]
    pos = torch.arange(e_cap, dtype=torch.int32, device=ptr.device)
    dst = rank_in_sorted(ptr, pos, side="right", unroll=True) - 1
    dst = torch.where(pos < sub.csc.n_edges, dst,
                      torch.full_like(dst, SENTINEL))
    return GraphBatch(edge_dst=dst, edge_src=sub.csc.idx, node_feat=feats,
                      ptr=ptr)


def gnn_apply_batched(model: GraphSAGE, batches: list[GraphBatch]
                      ) -> torch.Tensor:
    """The forward over one batch per slot → [S, N, out]: lane i computes
    exactly what ``model(batches[i])`` computes on its own batch."""
    return torch.stack([model(b) for b in batches])
