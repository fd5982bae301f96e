"""The GNN model zoo over sampled subgraphs: GraphSAGE, GAT, GatedGCN and
MeshGraphNet (port of ``repro/models/gnn.py``).

Message passing is edge gather → segment reduce. The serve path attaches
the subgraph's CSC pointers to the batch, so every sum is the scatter-free
pointer form: each node's sum read straight from its own span of the
message stream, in one launch of the span-sum kernel
(``kernels/ptr_scan.py``); GraphSAGE's mean reads the node states through
``edge_src`` in that same launch, so its [E, D] messages are never
written. Under ``GNNConfig.use_pallas_agg`` the model's aggregations are
the segment-sum kernel over the dst-sorted edges instead
(``kernels/segment_agg.py``, the same span-sum body); GraphSAGE's mean
reads the node states through ``edge_src`` there too, one call a layer.
No reduction on the serve path uses float
atomics, so a lane's logits are the same bits batched and alone: GAT's
edge softmax takes its maximum with ``scatter_reduce("amax")`` (exact in
any order) and its denominator from the pointer sum.
``index_add_`` remains only for a batch without ``ptr``.
``gnn_apply_batched`` stacks one forward per slot. Weights keep the
reference's layout, ``h @ W`` with ``W`` shaped [d_in, d_out], so a
parameter tree from the reference's ``gnn_init`` loads without transposes
(``load_reference_params``).

Training (``gnn_loss``) backpropagates through the same kernel. The
kernels leave no autograd history, so a training batch carries the
transposed layout of its edges as well (``rev_perm``, ``rev_ptr``: the
edge positions stably sorted by source and their pointers, which the
sampler builds once a batch, ``data/sampler.py``); with it every pointer
sum is ``kernels.ptr_scan.SpanSum`` and every row gather
``GatherRows``, and each backward is one more span sum or a row gather:
no float atomics forward or backward, so a training step gives the same
bits every run. A batch without ``ptr`` (``launch/steps.py``'s cells)
keeps ``index_add_``, whose float atomics on the card are not
deterministic. Under ``use_pallas_agg`` nothing trains: the reference's
Pallas segment sum has no reverse-mode rule either.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.graph import SENTINEL, resolve_device, take
from repro_torch.core.pipeline import gather_features
from repro_torch.core.set_count import rank_in_sorted
from repro_torch.kernels.ptr_scan import GatherRows, SpanSum, ptr_seg_sum
from repro_torch.models.common import (cross_entropy, layer_norm, mlp_apply,
                                       mlp_init)


@dataclasses.dataclass
class GraphBatch:
    """Static-shape graph minibatch (block-diagonal for batched graphs).
    With ``ptr`` set (the serve and sampler paths), ``edge_dst`` is sorted
    ascending and ``ptr[d] .. ptr[d+1]`` spans node d's incoming edges,
    every edge below ptr[N] valid. ``edge_feat`` [E, De] feeds GatedGCN's
    and MeshGraphNet's edge encoders; without it (the serve path) their
    edge states start at zero. ``labels`` / ``label_mask`` are per node,
    or per graph with ``graph_ids``. The port's own fields ``rev_perm``
    [E] int32 (the edge positions stably sorted by ``edge_src``, SENTINEL
    sources last) and ``rev_ptr`` [N + 1] int32 (its pointers) make the
    pointer path differentiable (the module's docstring)."""

    edge_dst: torch.Tensor  # [E] int32, sorted ascending, SENTINEL pad
    edge_src: torch.Tensor  # [E] int32
    node_feat: torch.Tensor  # [N, Df] float
    ptr: torch.Tensor | None = None  # [N+1] int32 CSC pointers
    edge_feat: torch.Tensor | None = None  # [E, De] float
    labels: torch.Tensor | None = None  # [N] int32 or [N, Do] / [G, Do] float
    label_mask: torch.Tensor | None = None  # [N] or [G] bool
    graph_ids: torch.Tensor | None = None  # [N] int32 (batched graphs)
    n_graphs: int = 1
    rev_perm: torch.Tensor | None = None  # [E] int32
    rev_ptr: torch.Tensor | None = None  # [N + 1] int32

    @property
    def n_nodes(self) -> int:
        return self.node_feat.shape[0]


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str  # graphsage | gat | gatedgcn | meshgraphnet
    n_layers: int
    d_hidden: int
    n_heads: int = 1
    aggregator: str = "mean"
    mlp_layers: int = 2
    sample_sizes: tuple[int, ...] = ()
    d_out: int = 0  # regression output dim (0 → classification)
    dtype: torch.dtype = torch.float32
    use_pallas_agg: bool = False


# ------------------------------------------------------ segment reductions
def _valid(batch: GraphBatch) -> torch.Tensor:
    return batch.edge_dst < batch.n_nodes


def _transposed(batch: GraphBatch | None) -> bool:
    return batch is not None and batch.rev_ptr is not None


def _ptr_seg_sum(ptr: torch.Tensor, x: torch.Tensor,
                 rows: torch.Tensor | None = None,
                 mean: bool = False,
                 batch: GraphBatch | None = None) -> torch.Tensor:
    """Scatter-free segment sum over CSC pointers: each node's span of the
    message stream ``x`` summed, or, given ``rows`` (the edges' source
    nodes), of ``x`` read through them inside the sum, so no [E, D] stream
    is written; with ``mean`` divided by the span's length (at least 1).
    The span-sum kernel on the card, one launch; its twin on the CPU
    (``torch.cumsum`` and two ``index_select``, after the gather), whose
    bits are those of ``seg_mean(batch, gather_src(batch, x))``
    (``seg_sum`` without ``mean``). A ``batch`` with the transposed layout
    makes it ``SpanSum``: the same forward, and a gradient for x."""
    flat = x.to(torch.float32).reshape(x.shape[0], -1).contiguous()
    if rows is not None:
        rows = rows.to(torch.int32).contiguous()
    p = torch.clamp(ptr, 0, x.shape[0] if rows is None else rows.shape[0])
    p = p.to(torch.int32)
    if _transposed(batch):
        seg = SpanSum.apply(flat, p, rows, mean, _dst(batch).to(torch.int32),
                            batch.rev_perm, batch.rev_ptr)
    else:
        seg = ptr_seg_sum(p, flat, rows, mean)
    return seg.reshape((p.shape[0] - 1,) + x.shape[1:]).to(x.dtype)


def _refuse_grad(x: torch.Tensor) -> None:
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            "use_pallas_agg has no gradient: the segment-sum kernel leaves no "
            "autograd history, and the reference's Pallas segment sum "
            "(repro.kernels.ops.segment_sum_padded) has no reverse-mode rule "
            "either; train with use_pallas_agg False")


def _dst_seg_sum(batch: GraphBatch, x: torch.Tensor, rows: torch.Tensor,
                 mean: bool) -> torch.Tensor:
    """The segment-sum kernel over ``edge_dst`` (which must be sorted;
    ``ptr`` is ignored): each node's sum of ``x`` read through ``rows``
    (the edges' source nodes, clamped into range) inside the sum, so no
    [E, D] stream is written; with ``mean`` divided by the node's edge
    count (at least 1), so no degree stream is summed. One call on the
    card (the bounds pass and the sum); on the CPU its twin, whose bits are those of ``seg_mean(batch,
    gather_src(batch, x), True)`` (``seg_sum`` without ``mean``)."""
    from repro_torch.kernels.segment_agg import segment_sum_padded
    _refuse_grad(x)
    return segment_sum_padded(batch.edge_dst, x, batch.n_nodes, rows,
                              mean).to(x.dtype)


def _dst(batch: GraphBatch) -> torch.Tensor:
    return torch.clamp(batch.edge_dst, max=batch.n_nodes - 1)


def seg_sum(batch: GraphBatch, msgs: torch.Tensor,
            use_pallas: bool = False) -> torch.Tensor:
    """Σ over incoming edges per dst node; SENTINEL edges contribute 0.
    ``use_pallas`` runs the segment-sum kernel over ``edge_dst`` (which
    must then be sorted) and ignores ``ptr``.

    The pointer path reads no mask: every row inside a span ptr[d] ..
    ptr[d + 1] is a valid edge of node d, and every SENTINEL row lies at or
    past ptr[N], which no span reaches (``subgraph_batch``, the builder of
    every pointer batch, sets SENTINEL exactly at the positions from the
    subgraph's edge count on, and ptr[N] is that count). The pointer sum
    never reads those rows, so the mask would change no output bit."""
    if batch.ptr is not None and not use_pallas:
        return _ptr_seg_sum(batch.ptr, msgs, batch=batch)
    msgs = torch.where(_valid(batch)[:, None], msgs,
                       torch.zeros((), dtype=msgs.dtype, device=msgs.device))
    if use_pallas:
        _refuse_grad(msgs)
        from repro_torch.kernels.segment_agg import segment_sum_padded
        return segment_sum_padded(batch.edge_dst, msgs,
                                  batch.n_nodes).to(msgs.dtype)
    out = torch.zeros((batch.n_nodes,) + msgs.shape[1:], dtype=msgs.dtype,
                      device=msgs.device)
    return out.index_add_(0, _dst(batch).to(torch.int64), msgs)


def seg_mean(batch: GraphBatch, msgs: torch.Tensor,
             use_pallas: bool = False) -> torch.Tensor:
    s = seg_sum(batch, msgs, use_pallas)
    ones = torch.ones((batch.edge_dst.shape[0], 1), dtype=msgs.dtype,
                      device=msgs.device)
    deg = seg_sum(batch, ones, use_pallas)
    return s / torch.clamp(deg, min=1.0)


def seg_softmax(batch: GraphBatch, scores: torch.Tensor) -> torch.Tensor:
    """Edge softmax per destination (ragged softmax), scores [E, H]: the
    maximum over each node's edges (masked edges at -1e30, on the last
    node as the reference clamps them; an empty node's maximum is -inf),
    the exponentials, their sum through ``seg_sum`` (the pointer sum when
    the batch has ``ptr``). The maximum's ``scatter_reduce("amax")`` is
    exact in any order, and so is its backward (it splits a gradient over
    ties by a sum of 0/1 counts); its rows and the sums' are read back
    through ``gather_dst``."""
    dst = _dst(batch).to(torch.int64)[:, None].expand_as(scores)
    valid = _valid(batch)[:, None]
    scores = torch.where(valid, scores, torch.full_like(scores, -1e30))
    mx = torch.full((batch.n_nodes,) + scores.shape[1:], -math.inf,
                    dtype=scores.dtype, device=scores.device)
    mx = mx.scatter_reduce(0, dst, scores, "amax")
    ex = torch.exp(scores - gather_dst(batch, mx))
    ex = torch.where(valid, ex, torch.zeros_like(ex))
    den = seg_sum(batch, ex)
    return ex / torch.clamp(gather_dst(batch, den), min=1e-20)


def _gather(h: torch.Tensor, idx: torch.Tensor, ptr, rows) -> torch.Tensor:
    """h's rows at ``idx`` (in range) through ``GatherRows``: its backward
    is a span sum over the edges' pointers ``ptr``."""
    flat = h.reshape(h.shape[0], -1)
    out = GatherRows.apply(flat, idx.to(torch.int64), ptr, rows)
    return out.reshape(idx.shape + h.shape[1:])


def gather_src(batch: GraphBatch, h: torch.Tensor) -> torch.Tensor:
    """h at each edge's source (clamped into range); with the transposed
    layout its gradient is a span sum over ``rev_ptr`` through
    ``rev_perm``."""
    idx = torch.clamp(batch.edge_src, max=batch.n_nodes - 1)
    if not _transposed(batch):
        return take(h, idx)
    return _gather(h, idx, batch.rev_ptr, batch.rev_perm)


def gather_dst(batch: GraphBatch, h: torch.Tensor) -> torch.Tensor:
    """h at each edge's destination (clamped into range); with the
    transposed layout its gradient is a span sum over ``ptr``."""
    if not _transposed(batch):
        return take(h, _dst(batch))
    ptr = torch.clamp(batch.ptr, 0, batch.edge_dst.shape[0])
    return _gather(h, _dst(batch), ptr.to(torch.int32), None)


# ------------------------------------------------------------------ models
class _Init:
    """Seeded parameters for a model: N(0, 1/d_in) weights drawn from the
    CPU ``generator`` (the reference's ``dense_init`` scale), so the
    values do not depend on ``device``, where they are then placed (a
    missing card raises) in ``cfg.dtype``."""

    def __init__(self, cfg: GNNConfig, generator, device):
        self.gen, self.dtype = generator, cfg.dtype
        self.device = resolve_device(device)

    def put(self, t: torch.Tensor) -> nn.Parameter:
        return nn.Parameter(t.to(device=self.device, dtype=self.dtype))

    def dense(self, a: int, b: int) -> nn.Parameter:
        w = torch.randn((a, b), generator=self.gen, dtype=torch.float32)
        return self.put(w / math.sqrt(a))

    def normal(self, shape, scale: float) -> nn.Parameter:
        return self.put(scale * torch.randn(shape, generator=self.gen))

    def mlp(self, dims: tuple[int, ...]) -> nn.ParameterDict:
        return nn.ParameterDict({k: self.put(v) for k, v in
                                 mlp_init(self.gen, dims).items()})


class _GNN(nn.Module):
    """What the four models share: the config and the linear
    classification ``head`` (``n_classes`` > 0) after the model's own
    output."""

    kind = ""

    def __init__(self, cfg: GNNConfig):
        super().__init__()
        if cfg.kind != self.kind:
            raise ValueError(f"{type(self).__name__} builds kind "
                             f"{self.kind!r}, not {cfg.kind!r}")
        self.cfg = cfg

    def body(self, batch: GraphBatch) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        h = self.body(batch)
        return h @ self.head if self.head is not None else h


class GraphSAGE(_GNN):
    """Per layer: ``h = h @ w_self + mean_nb(h) @ w_nb + b``, then ReLU and
    L2 row normalisation on every layer but the last; ``head`` maps the
    last layer to ``n_classes`` logits."""

    kind = "graphsage"

    def __init__(self, cfg: GNNConfig, d_in: int, n_classes: int = 0,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__(cfg)
        init = _Init(cfg, generator, device)
        self.layers = nn.ModuleList()
        d = d_in
        for _ in range(cfg.n_layers):
            self.layers.append(nn.ParameterDict({
                "w_self": init.dense(d, cfg.d_hidden),
                "w_nb": init.dense(d, cfg.d_hidden),
                "b": init.put(torch.zeros(cfg.d_hidden))}))
            d = cfg.d_hidden
        self.head = init.dense(cfg.d_hidden, n_classes) if n_classes else None

    def body(self, batch: GraphBatch) -> torch.Tensor:
        cfg = self.cfg
        h = batch.node_feat.to(cfg.dtype)
        fused = batch.ptr is not None and not cfg.use_pallas_agg
        mean = cfg.aggregator == "mean"
        for i, lp in enumerate(self.layers):
            if fused:
                agg = _ptr_seg_sum(batch.ptr, h, batch.edge_src, mean, batch)
            elif cfg.use_pallas_agg:
                agg = _dst_seg_sum(batch, h, batch.edge_src, mean)
            else:
                msgs = gather_src(batch, h)
                agg = seg_mean(batch, msgs) if mean else seg_sum(batch, msgs)
            h = h @ lp["w_self"] + agg @ lp["w_nb"] + lp["b"]
            if i < cfg.n_layers - 1:
                h = torch.relu(h)
                h = h / torch.clamp(torch.linalg.norm(h, dim=-1, keepdim=True),
                                    min=1e-6)
        return h


class GAT(_GNN):
    """Multi-head graph attention: per layer ``z = h @ w`` split into heads,
    scores ``leaky_relu(a_src·z_src + a_dst·z_dst, 0.2)``, the edge softmax
    per destination, the weighted sum of ``z_src``; ELU between layers.
    Every layer but the last has ``n_heads`` heads, the last one."""

    kind = "gat"

    def __init__(self, cfg: GNNConfig, d_in: int, n_classes: int = 0,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__(cfg)
        init = _Init(cfg, generator, device)
        self.layers = nn.ModuleList()
        d = d_in
        for i in range(cfg.n_layers):
            heads = cfg.n_heads if i < cfg.n_layers - 1 else 1
            self.layers.append(nn.ParameterDict({
                "w": init.dense(d, heads * cfg.d_hidden),
                "a_src": init.normal((heads, cfg.d_hidden), 0.1),
                "a_dst": init.normal((heads, cfg.d_hidden), 0.1)}))
            d = heads * cfg.d_hidden
        # the last layer has one head: d_hidden wide
        self.head = init.dense(cfg.d_hidden, n_classes) if n_classes else None

    def body(self, batch: GraphBatch) -> torch.Tensor:
        cfg = self.cfg
        n = batch.n_nodes
        h = batch.node_feat.to(cfg.dtype)
        for i, lp in enumerate(self.layers):
            heads = lp["a_src"].shape[0]
            z = (h @ lp["w"]).reshape(n, heads, cfg.d_hidden)
            s_src = torch.einsum("nhd,hd->nh", z, lp["a_src"])
            s_dst = torch.einsum("nhd,hd->nh", z, lp["a_dst"])
            e = F.leaky_relu(gather_src(batch, s_src)
                             + gather_dst(batch, s_dst), 0.2)
            alpha = seg_softmax(batch, e)  # [E, H]
            msgs = gather_src(batch, z) * alpha[..., None]  # [E, H, D]
            agg = seg_sum(batch, msgs.reshape(msgs.shape[0], -1),
                          cfg.use_pallas_agg)
            h = agg.reshape(n, heads * cfg.d_hidden)
            if i < cfg.n_layers - 1:
                h = F.elu(h)
        return h


class GatedGCN(_GNN):
    """Residual gated graph convnet with edge states: per layer
    ``e' = A h_dst + B h_src + C e``, gate ``σ(e')``, ``h' = U h +
    Σ gate·V h_src / (Σ gate + 1e-6)``, each state updated residually
    through its LayerNorm and ReLU. Node features are embedded by
    ``embed_n``, edge features by ``embed_e`` (zero edge states without
    them)."""

    kind = "gatedgcn"

    def __init__(self, cfg: GNNConfig, d_in: int, d_edge: int = 0,
                 n_classes: int = 0, generator: torch.Generator | None = None,
                 device="cuda"):
        super().__init__(cfg)
        init = _Init(cfg, generator, device)
        d = cfg.d_hidden
        self.embed_n = init.dense(d_in, d)
        self.embed_e = init.dense(max(d_edge, 1), d)
        self.layers = nn.ModuleList()
        for _ in range(cfg.n_layers):
            lp = {k: init.dense(d, d) for k in "ABCUV"}
            for s in ("h", "e"):
                lp[f"ln_{s}_scale"] = init.put(torch.ones(d))
                lp[f"ln_{s}_bias"] = init.put(torch.zeros(d))
            self.layers.append(nn.ParameterDict(lp))
        self.head = init.dense(d, n_classes) if n_classes else None

    def body(self, batch: GraphBatch) -> torch.Tensor:
        cfg = self.cfg
        h = batch.node_feat.to(cfg.dtype) @ self.embed_n
        if batch.edge_feat is not None:
            e = batch.edge_feat.to(cfg.dtype) @ self.embed_e
        else:
            e = torch.zeros((batch.edge_dst.shape[0], cfg.d_hidden),
                            dtype=cfg.dtype, device=h.device)
        for lp in self.layers:
            e_new = (gather_dst(batch, h @ lp["A"])
                     + gather_src(batch, h @ lp["B"]) + e @ lp["C"])
            gate = torch.sigmoid(e_new)
            msg = gate * gather_src(batch, h @ lp["V"])
            num = seg_sum(batch, msg, cfg.use_pallas_agg)
            den = seg_sum(batch, gate, cfg.use_pallas_agg)
            h_new = h @ lp["U"] + num / (den + 1e-6)
            h = h + torch.relu(layer_norm(h_new, lp["ln_h_scale"],
                                          lp["ln_h_bias"]))
            e = e + torch.relu(layer_norm(e_new, lp["ln_e_scale"],
                                          lp["ln_e_bias"]))
        return h


class MeshGraphNet(_GNN):
    """Encode-process-decode: MLP encoders of nodes (``enc_n``) and edges
    (``enc_e``; zero edge states without edge features), per layer an
    edge MLP over [e, h_src, h_dst] and a node MLP over [h, Σ e], both
    residual, then the ``dec`` MLP to ``max(d_out, 1)`` outputs. Every
    MLP has ``mlp_layers`` hidden layers of ``d_hidden``."""

    kind = "meshgraphnet"

    def __init__(self, cfg: GNNConfig, d_in: int, d_edge: int = 0,
                 n_classes: int = 0, generator: torch.Generator | None = None,
                 device="cuda"):
        super().__init__(cfg)
        init = _Init(cfg, generator, device)
        d = cfg.d_hidden
        hidden = (d,) * cfg.mlp_layers
        d_out = max(cfg.d_out, 1)
        self.enc_n = init.mlp((d_in,) + hidden + (d,))
        self.enc_e = init.mlp((max(d_edge, 1),) + hidden + (d,))
        self.dec = init.mlp((d,) + hidden + (d_out,))
        self.layers = nn.ModuleList()
        for _ in range(cfg.n_layers):
            self.layers.append(nn.ModuleDict({
                "edge_mlp": init.mlp((3 * d,) + hidden + (d,)),
                "node_mlp": init.mlp((2 * d,) + hidden + (d,))}))
        self.head = init.dense(d_out, n_classes) if n_classes else None

    def body(self, batch: GraphBatch) -> torch.Tensor:
        cfg = self.cfg
        h = mlp_apply(self.enc_n, batch.node_feat.to(cfg.dtype))
        if batch.edge_feat is not None:
            e = mlp_apply(self.enc_e, batch.edge_feat.to(cfg.dtype))
        else:
            e = torch.zeros((batch.edge_dst.shape[0], cfg.d_hidden),
                            dtype=cfg.dtype, device=h.device)
        for lp in self.layers:
            e = e + mlp_apply(lp["edge_mlp"], torch.cat(
                [e, gather_src(batch, h), gather_dst(batch, h)], dim=-1))
            agg = seg_sum(batch, e, cfg.use_pallas_agg)
            h = h + mlp_apply(lp["node_mlp"], torch.cat([h, agg], dim=-1))
        return mlp_apply(self.dec, h)


_MODELS = {m.kind: m for m in (GraphSAGE, GAT, GatedGCN, MeshGraphNet)}


def gnn_model(cfg: GNNConfig, d_in: int, d_edge: int = 0, n_classes: int = 0,
              generator: torch.Generator | None = None,
              device="cuda") -> _GNN:
    """The model of ``cfg.kind`` (the counterpart of the reference's
    ``gnn_init``): with ``n_classes``, a head from the model's output width
    (GraphSAGE, GAT and GatedGCN: ``d_hidden``; MeshGraphNet:
    ``max(d_out, 1)``) to the classes. ``d_edge`` sizes the edge encoders
    of GatedGCN and MeshGraphNet."""
    if cfg.kind not in _MODELS:
        raise ValueError(f"unknown GNN kind {cfg.kind!r}; kinds: "
                         f"{sorted(_MODELS)}")
    kw = dict(n_classes=n_classes, generator=generator, device=device)
    if cfg.kind in ("gatedgcn", "meshgraphnet"):
        kw["d_edge"] = d_edge
    return _MODELS[cfg.kind](cfg, d_in, **kw)


def load_reference_params(model: _GNN, params) -> _GNN:
    """Carry a reference ``gnn_init`` tree into ``model``, in place: the
    tree's nesting (dicts by key, lists by position; arrays convertible by
    ``np.asarray``) must name exactly the model's parameters, with the
    same shapes (the [d_in, d_out] layout, no transposes)."""

    def put(dst: nn.Parameter, src, path):
        arr = torch.from_numpy(np.array(src, dtype=np.float32))
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"{path}: shape {tuple(arr.shape)} != "
                             f"{tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(arr.to(device=dst.device, dtype=dst.dtype))

    def walk(node, src, path):
        if isinstance(src, dict):
            if isinstance(node, (nn.ParameterDict, nn.ModuleDict)):
                names = set(node.keys())
            else:
                names = ({k for k, _ in node.named_parameters(recurse=False)}
                         | {k for k, _ in node.named_children()})
            if names != set(src):
                raise ValueError(f"{path or 'params'}: the tree names "
                                 f"{sorted(src)}, the model {sorted(names)}")
            for k, v in src.items():
                child = (node[k] if isinstance(
                    node, (nn.ParameterDict, nn.ModuleDict))
                    else getattr(node, k))
                walk(child, v, f"{path}.{k}" if path else k)
        elif isinstance(src, (list, tuple)):
            if len(src) != len(node):
                raise ValueError(f"{path}: {len(src)} entries in the tree, "
                                 f"{len(node)} in the model")
            for i, (child, v) in enumerate(zip(node, src)):
                walk(child, v, f"{path}[{i}]")
        else:
            put(node, src, path)

    walk(model, params, "")
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


def gnn_apply_batched(model: _GNN, batches: list[GraphBatch]
                      ) -> torch.Tensor:
    """The forward over one batch per slot → [S, N, out]: lane i computes
    exactly what ``model(batches[i])`` computes on its own batch."""
    return torch.stack([model(b) for b in batches])


def pool_graphs(batch: GraphBatch, h: torch.Tensor) -> torch.Tensor:
    """Mean-pool node outputs per graph (batched small graphs): the sums
    and the node counts by ``index_add_`` over ``graph_ids``, ids outside
    [0, n_graphs) dropped as the reference's ``segment_sum`` drops them."""
    g = batch.n_graphs
    gid = batch.graph_ids.to(torch.int64)
    gid = torch.where((gid >= 0) & (gid < g), gid, torch.full_like(gid, g))
    s = torch.zeros((g + 1,) + h.shape[1:], dtype=h.dtype, device=h.device)
    s = s.index_add(0, gid, h)[:g]
    c = torch.zeros((g + 1, 1), dtype=h.dtype, device=h.device)
    c = c.index_add(0, gid, torch.ones((h.shape[0], 1), dtype=h.dtype,
                                       device=h.device))[:g]
    return s / torch.clamp(c, min=1.0)


def gnn_loss(model: _GNN, batch: GraphBatch) -> torch.Tensor:
    """The training loss (0-d float32): the model's outputs, mean-pooled
    per graph with ``graph_ids``; MeshGraphNet with ``d_out`` regresses
    (the squared error summed over the output columns, averaged over the
    masked-in rows), every other model classifies (``cross_entropy`` over
    the masked-in rows)."""
    cfg = model.cfg
    out = model(batch)
    if batch.graph_ids is not None:
        out = pool_graphs(batch, out)
    if cfg.d_out and cfg.kind == "meshgraphnet":
        err = out.to(torch.float32) - batch.labels.to(torch.float32)
        m = batch.label_mask[:, None].to(torch.float32)
        return torch.sum(err * err * m) / torch.clamp(torch.sum(m), min=1.0)
    return cross_entropy(out, batch.labels, batch.label_mask)
