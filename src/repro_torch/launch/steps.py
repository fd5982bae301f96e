"""Step cells of the port (the LM prefill and train cells, the GNN train
cells, the recommender cells and the preprocessing engine's steps of
``repro/launch/steps.py``).

The prefill and train cells build any of the five LM configurations
(gemma2-9b, granite-moe-1b-a400m, codeqwen1.5-7b, qwen1.5-32b,
grok-1-314b); the recommender cells build dlrm-rm2 at each of the four
``RECSYS_SHAPES``.

A cell is a built model plus an input batch made from a seed; calling its
``step`` runs one step. ``preprocess_cells(mesh)`` gives the engine's
three steps over a ``torch.distributed`` mesh (``engine.shard``).

``build_cell(arch_id, shape_name, mesh, device)`` is the reference's
entry: any of the 40 (arch, shape) cells as a ``Cell`` — its step
function, its arguments (with ``device="meta"`` every parameter, state
and input is a meta tensor, the stand-in for ``ShapeDtypeStruct``:
shapes and dtypes, nothing allocated), the reference's skips, and with a
mesh each argument's placements (``dist/sharding.py``) by the
reference's rules. A described mesh (``mesh_dim_names``, ``ndim``,
``size(i)``) is enough; it needs no process group. The placements
describe the layout; the step function runs on the whole arguments (the
sharded paths are ``engine.shard``, ``ServeEngine(mesh=)`` and
``moe_apply_local``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.configs import (GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES,
                                 get_arch, get_config)
from repro_torch.core.graph import resolve_device
from repro_torch.data.synthetic import dlrm_batch, lm_batch
from repro_torch.models.dlrm import (DLRM, dlrm_forward, dlrm_loss,
                                     dlrm_retrieval)
from repro_torch.models.gnn import (GNNConfig, GraphBatch, _GNN, gnn_loss,
                                    gnn_model)
from repro_torch.models.transformer import (LM, lm_decode_step, lm_loss,
                                            lm_prefill, make_cache)
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


def _drawn(dev: torch.device, shape, dtype, draw) -> torch.Tensor:
    """``draw()`` (a numpy array) as a tensor on ``dev``; on ``meta`` an
    empty tensor of ``shape`` and ``dtype`` (nothing drawn)."""
    if dev.type == "meta":
        return torch.empty(shape, dtype=dtype, device=dev)
    return torch.from_numpy(np.asarray(draw())).to(dtype=dtype, device=dev)


def _lm_config(arch_id: str, smoke: bool, model_axis: int):
    """The LM config, padded for a model axis above 1 (the reference's
    ``cfg.padded``)."""
    cfg = get_config(arch_id, smoke=smoke)
    return cfg.padded(model_axis) if model_axis > 1 else cfg


def lm_prefill_cell(arch_id: str, seq_len: int | None = None,
                    batch: int | None = None, device="cuda", seed: int = 0,
                    smoke: bool = False, model_axis: int = 1) -> PrefillCell:
    """The ``prefill_32k`` cell of LM ``arch_id`` (32,768 tokens, batch 32
    unless ``seq_len`` / ``batch`` cut it): the model with random weights
    from ``seed`` on ``device`` and uniform random tokens from ``seed``;
    the config padded for ``model_axis``."""
    shape = LM_SHAPES["prefill_32k"]
    seq_len = shape["seq_len"] if seq_len is None else seq_len
    batch = shape["global_batch"] if batch is None else batch
    cfg = _lm_config(arch_id, smoke, model_axis)
    dev = resolve_device(device)
    model = LM(cfg, seed=seed, device=dev)
    tokens = _drawn(dev, (batch, seq_len), torch.int32,
                    lambda: np.random.default_rng(seed).integers(
                        0, cfg.vocab, (batch, seq_len)))
    return PrefillCell(arch_id, model, tokens)


def _train_step(model, loss_fn, opt_cfg: AdamWConfig,
                opt_state: dict) -> dict:
    """The gradient of ``loss_fn()`` by autograd, then ``adamw_update`` in
    place; a parameter the loss does not reach gets a zero gradient (as
    ``jax.grad`` gives it). Returns ``{"loss", "grad_norm"}`` as 0-d
    tensors on the model's device and ``"lr"`` as a float; the gradients
    are freed."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    loss = loss_fn()
    loss.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in params.items()}
    metrics = adamw_update(opt_cfg, grads, opt_state, params)
    del grads
    for p in params.values():
        p.grad = None
    return {"loss": loss.detach(), **metrics}


def lm_train_step(model: LM, opt_cfg: AdamWConfig, opt_state: dict,
                  tokens: torch.Tensor) -> dict:
    """One training step (the reference cell's ``train_step``) of
    ``lm_loss``: ``{"loss", "grad_norm", "lr"}``."""
    return _train_step(model, lambda: lm_loss(model, tokens), opt_cfg,
                       opt_state)


def gnn_train_step(model: _GNN, opt_cfg: AdamWConfig, opt_state: dict,
                   batch: GraphBatch) -> dict:
    """One training step of ``gnn_loss`` on ``batch`` (the reference's GNN
    ``train_step``): ``{"loss", "grad_norm", "lr"}``."""
    return _train_step(model, lambda: gnn_loss(model, batch), opt_cfg,
                       opt_state)


def train_moments_dtype(cfg) -> torch.dtype:
    """The AdamW moments' dtype of an LM train cell (the reference's
    rule): bfloat16 when n_layers · d_model > 200,000 or the train layout
    is ``dp_only``, else float32."""
    big = cfg.n_layers * cfg.d_model > 200_000
    return (torch.bfloat16 if big or cfg.train_layout == "dp_only"
            else torch.float32)


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
                  smoke: bool = False, model_axis: int = 1) -> TrainCell:
    """The ``train_4k`` cell of ``arch_id`` (4,096 tokens, batch 256,
    every layer, unless ``seq_len`` / ``batch`` / ``n_layers`` cut it):
    the model with random weights from ``seed`` on ``device``, AdamW with
    the reference cell's moments (bfloat16 when n_layers · d_model >
    200,000 or the layout is ``dp_only``, reckoned on the published
    configuration: granite-moe-1b-a400m, qwen1.5-32b and grok-1-314b;
    float32 for gemma2-9b and codeqwen1.5-7b), zero state, and the tokens
    of ``lm_batch(seed, 0, ...)``; the config padded for ``model_axis``."""
    shape = LM_SHAPES["train_4k"]
    seq_len = shape["seq_len"] if seq_len is None else seq_len
    batch = shape["global_batch"] if batch is None else batch
    base = _lm_config(arch_id, smoke, model_axis)
    opt_cfg = AdamWConfig(mom_dtype=train_moments_dtype(base))
    cfg = base if n_layers is None else dataclasses.replace(
        base, n_layers=n_layers)
    dev = resolve_device(device)
    model = LM(cfg, seed=seed, device=dev)
    opt_state = adamw_init(dict(model.named_parameters()), opt_cfg.mom_dtype)
    tokens = _drawn(dev, (batch, seq_len), torch.int32,
                    lambda: lm_batch(seed, 0, batch, seq_len, cfg.vocab))
    return TrainCell(arch_id, model, opt_cfg, opt_state, tokens)


# ================================================================= GNN cells
def _pad32(x: int) -> int:
    """Node and edge counts padded to a multiple of 32, as the reference
    pads them (SENTINEL edges and masked-out nodes make the pad free)."""
    return -(-x // 32) * 32


def _gnn_batch_specs(cfg: GNNConfig, shape: dict) -> dict:
    """The batch's shapes for a ``GNN_SHAPES`` entry ``shape`` (the
    reference's ``_gnn_batch_specs``): name -> (shape, dtype), plus
    ``n_graphs``. Minibatch cells hold every node and edge a sample of
    ``batch_nodes`` seeds with ``fanout`` can reach."""
    has_edge_feat = cfg.kind in ("gatedgcn", "meshgraphnet")
    node_reg = cfg.kind == "meshgraphnet" and cfg.d_out > 0
    if shape["kind"] == "full_graph":
        n, e, g = _pad32(shape["n_nodes"]), _pad32(shape["n_edges"]), None
    elif shape["kind"] == "minibatch":
        b, (f1, f2) = shape["batch_nodes"], shape["fanout"]
        n = _pad32(b + b * f1 + b * f1 * f2)
        e, g = _pad32(b * f1 + b * f1 * f2), None
    else:  # batched_graphs
        g = shape["batch"]
        n, e = _pad32(shape["n_nodes"] * g), _pad32(shape["n_edges"] * g)
    rows = n if g is None else g
    specs = {
        "edge_dst": ((e,), torch.int32), "edge_src": ((e,), torch.int32),
        "node_feat": ((n, shape["d_feat"]), torch.float32),
        "labels": (((rows, cfg.d_out), torch.float32) if node_reg
                   else ((rows,), torch.int32)),
        "label_mask": ((rows,), torch.bool),
        "n_graphs": 1 if g is None else g}
    if has_edge_feat:
        specs["edge_feat"] = ((e, 4), torch.float32)
    if g is not None:
        specs["graph_ids"] = ((n,), torch.int32)
    return specs


def _gnn_batch(specs: dict, shape: dict, seed: int, device) -> GraphBatch:
    """A batch of ``specs`` drawn with numpy from ``seed``: dst-sorted
    edges (within each graph for batched graphs), normal features, labels
    of ``n_classes`` (or normal regression targets), every row masked in.
    On ``meta``, empty tensors of the specs (nothing drawn)."""
    if torch.device(device).type == "meta":
        return GraphBatch(n_graphs=specs["n_graphs"], **{
            k: torch.empty(v[0], dtype=v[1], device=device)
            for k, v in specs.items() if k != "n_graphs"})
    rng = np.random.default_rng(seed)
    e = specs["edge_dst"][0][0]
    n, d_feat = specs["node_feat"][0]
    g = specs["n_graphs"] if "graph_ids" in specs else None
    if g is None:
        dst = rng.integers(0, n, e)
        src = rng.integers(0, n, e)
    else:  # each edge inside one graph of n // g nodes
        per = n // g
        graph = np.sort(rng.integers(0, g, e))
        dst = graph * per + rng.integers(0, per, e)
        src = graph * per + rng.integers(0, per, e)
    order = np.argsort(dst, kind="stable")
    t = {"edge_dst": dst[order], "edge_src": src[order],
         "node_feat": rng.normal(size=(n, d_feat))}
    shape_l, dtype_l = specs["labels"]
    t["labels"] = (rng.normal(size=shape_l) if dtype_l == torch.float32
                   else rng.integers(0, shape["n_classes"], shape_l))
    t["label_mask"] = np.ones(specs["label_mask"][0], bool)
    if "edge_feat" in specs:
        t["edge_feat"] = rng.normal(size=specs["edge_feat"][0])
    if g is not None:
        t["graph_ids"] = np.minimum(np.arange(n) // (n // g), g - 1)
    fields = {k: torch.from_numpy(np.asarray(v)).to(
        dtype=specs[k][1], device=device) for k, v in t.items()}
    return GraphBatch(n_graphs=specs["n_graphs"], **fields)


@dataclasses.dataclass
class GnnTrainCell:
    arch_id: str
    shape_name: str
    model: _GNN
    opt_cfg: AdamWConfig
    opt_state: dict  # train.optim.adamw_init's
    batch: GraphBatch  # on the model's device

    def step(self) -> dict:
        """One AdamW step on the cell's batch (``train_step``):
        ``{"loss", "grad_norm", "lr"}``."""
        return gnn_train_step(self.model, self.opt_cfg, self.opt_state,
                              self.batch)


def _gnn_cell(arch_id: str, shape_name: str, device="cuda", seed: int = 0,
              smoke: bool = False, **shape) -> GnnTrainCell:
    """The ``GNN_SHAPES[shape_name]`` train cell of ``arch_id``, its entries
    overridden by ``shape`` (a cut to size): the model with random weights
    from ``seed`` (edge encoders 4 wide, a head to ``n_classes`` unless
    MeshGraphNet regresses), AdamW at the reference cell's defaults, and a
    batch from ``seed`` (``_gnn_batch``). The batch has no ``ptr``, so its
    sums are ``index_add_``: not deterministic on the card."""
    cfg = get_config(arch_id, smoke=smoke)
    dims = {**GNN_SHAPES[shape_name], **shape}
    node_reg = cfg.kind == "meshgraphnet" and cfg.d_out > 0
    dev = resolve_device(device)
    model = gnn_model(cfg, dims["d_feat"], d_edge=4,
                      n_classes=0 if node_reg else dims["n_classes"],
                      generator=torch.Generator().manual_seed(seed),
                      device=dev)
    opt_cfg = AdamWConfig()
    opt_state = adamw_init(dict(model.named_parameters()))
    batch = _gnn_batch(_gnn_batch_specs(cfg, dims), dims, seed, dev)
    return GnnTrainCell(arch_id, shape_name, model, opt_cfg, opt_state, batch)


# ============================================================== recsys cells
def recsys_train_step(model: DLRM, opt_cfg: AdamWConfig, opt_state: dict,
                      batch: tuple) -> dict:
    """One training step of ``dlrm_loss`` on ``batch`` = (dense, idx,
    labels) (the reference cell's ``train_step``): ``{"loss",
    "grad_norm", "lr"}``. The table's gradient is the span sum over the
    batch's lookup layout, built inside the loss."""
    return _train_step(model, lambda: dlrm_loss(model, *batch), opt_cfg,
                       opt_state)


@dataclasses.dataclass
class RecsysCell:
    arch_id: str
    shape_name: str
    model: DLRM
    # train: (dense, idx, labels); serve: (dense, idx); retrieval: (dense,
    # user idx, candidate idx); on the model's device
    inputs: tuple
    opt_cfg: AdamWConfig | None = None
    opt_state: dict | None = None  # train.optim.adamw_init's (train only)

    def step(self):
        """One step of the cell's kind: a train step's ``{"loss",
        "grad_norm", "lr"}``, a serve step's logits [B], or retrieval's
        (top scores, candidate indices)."""
        kind = RECSYS_SHAPES[self.shape_name]["kind"]
        if kind == "train":
            return recsys_train_step(self.model, self.opt_cfg,
                                     self.opt_state, self.inputs)
        if kind == "serve":
            with torch.no_grad():
                return dlrm_forward(self.model, *self.inputs)
        return dlrm_retrieval(self.model, *self.inputs)


# the candidates' own sparse fields in a retrieval cell (the last ones)
RETRIEVAL_CAND_FIELDS = 2


def _recsys_cell(arch_id: str, shape_name: str, device="cuda", seed: int = 0,
                 smoke: bool = False, batch: int | None = None,
                 model: DLRM | None = None) -> RecsysCell:
    """The ``RECSYS_SHAPES[shape_name]`` cell of ``arch_id``: ``model`` (or
    a new one with random weights from ``seed`` on ``device``) and inputs
    from ``dlrm_batch(seed, 0, ...)`` of the shape's batch (``batch`` cuts
    it; for retrieval, the candidate count). Train cells hold AdamW at the
    reference cell's defaults with zero state. A retrieval cell scores the
    first row's dense features and first F − 2 fields against every row's
    last 2 fields."""
    cfg = get_config(arch_id, smoke=smoke)
    d = RECSYS_SHAPES[shape_name]
    dev = resolve_device(device)
    model = DLRM(cfg, seed=seed, device=dev) if model is None else model
    n = batch if batch is not None else (
        d["n_candidates"] if d["kind"] == "retrieval" else d["batch"])
    drawn = []

    def draw(i):
        if not drawn:
            drawn.extend(dlrm_batch(seed, 0, n, cfg.n_dense, cfg.n_sparse,
                                    cfg.hot, cfg.vocab_size))
        return drawn[i]

    dense = _drawn(dev, (n, cfg.n_dense), torch.float32, lambda: draw(0))
    idx = _drawn(dev, (n, cfg.n_sparse, cfg.hot), torch.int32,
                 lambda: draw(1))
    labels = _drawn(dev, (n,), torch.float32, lambda: draw(2))
    if d["kind"] == "train":
        opt_cfg = AdamWConfig()
        return RecsysCell(arch_id, shape_name, model, (dense, idx, labels),
                          opt_cfg, adamw_init(dict(model.named_parameters())))
    if d["kind"] == "serve":
        return RecsysCell(arch_id, shape_name, model, (dense, idx))
    f_user = cfg.n_sparse - RETRIEVAL_CAND_FIELDS
    return RecsysCell(arch_id, shape_name, model,
                      (dense[:1], idx[:1, :f_user], idx[:, f_user:]))


# ===================================================== paper-technique cells
# Reddit in a pow2 COO, a 1,024-seed minibatch, two hops of 15 and 10
PREPROCESS_NODES = 232_965
PREPROCESS_EDGES = 114_615_892
PREPROCESS_CAPACITY = 1 << 27
PREPROCESS_SEEDS = 1024
PREPROCESS_FANOUTS = (15, 10)


class PreprocStep(NamedTuple):
    arch_id: str
    shape_name: str
    step: object
    note: str
    # the step's arguments as meta stand-ins (shapes and dtypes alone)
    args: tuple = ()


def preprocess_cells(mesh) -> list[PreprocStep]:
    """The AutoGNN engine itself as three steps over ``mesh``, at the
    ``PREPROCESS_*`` sizes under ``EngineConfig(w_upe=8192, n_upe=0)``:

    * autognn-convert / reddit: ``step(coo)``, the conversion cut over
      the dp ranks (``engine.shard.shard_convert``);
    * autognn-sample / reddit-minibatch: ``step(csc, batch_nodes, key)``,
      Selecting and Reindexing of the 1,024 seeds with the graph whole on
      every rank (the reference places the batch over dp; here every
      rank computes the whole subgraph, the result the placement leaves
      unchanged);
    * autognn-preprocess / reddit-e2e: ``step(coo, batch_nodes, key)``,
      the whole sharded workflow (``engine.shard.shard_preprocess``).
    """
    from repro_torch.core.costmodel import EngineConfig
    from repro_torch.core.graph import COO, CSC
    from repro_torch.core.pipeline import sample_subgraph
    from repro_torch.core.prng import PRNGKey
    from repro_torch.engine.shard import shard_convert, shard_preprocess
    ecfg = EngineConfig(w_upe=8192, n_upe=0)
    fan = PREPROCESS_FANOUTS
    n, cap = PREPROCESS_NODES, PREPROCESS_CAPACITY

    def meta(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    coo = COO(dst=meta(cap), src=meta(cap), n_edges=meta(), n_nodes=n)
    csc = CSC(ptr=meta(n + 1), idx=meta(cap), n_edges=meta(), n_nodes=n)
    seeds, key = meta(PREPROCESS_SEEDS), PRNGKey(0)

    def convert_step(coo):
        return shard_convert(mesh, coo, ecfg)

    def sample_step(csc, batch_nodes, key):
        return sample_subgraph(csc, batch_nodes, fan, key, ecfg)

    def e2e_step(coo, batch_nodes, key):
        return shard_preprocess(mesh, coo, batch_nodes, fan, key, ecfg)

    return [PreprocStep("autognn-convert", "reddit", convert_step,
                        "COO→CSC conversion, edges cut over dp "
                        "(engine.shard)", (coo,)),
            PreprocStep("autognn-sample", "reddit-minibatch", sample_step,
                        "Selecting+Reindexing of the minibatch",
                        (csc, seeds, key)),
            PreprocStep("autognn-preprocess", "reddit-e2e", e2e_step,
                        "the whole sharded workflow (engine.shard)",
                        (coo, seeds, key))]


# ============================================================ build_cell
@dataclasses.dataclass
class Cell:
    """One (arch, shape) cell: ``fn(*args)`` runs one step on the whole
    arguments. ``args[0]`` is a parameter dict named as the model's; the
    cell's own is the model's parameters themselves, and a tensor that is
    not the model's own is copied into it first (``_bound``), so ``fn``
    steps the model in place. ``roles`` names each argument (``params``,
    ``optimizer``, ``cache`` or ``input``); ``placements`` is None without
    a mesh, else a tree of placement tuples shaped like ``args`` (a graph
    batch as ``batch_fields``), the layout the reference gives them;
    ``skipped`` names the reference's reason when the cell is skipped."""

    arch_id: str
    shape_name: str
    fn: Callable
    args: tuple
    roles: tuple = ()
    placements: tuple | None = None
    note: str = ""
    skipped: str = ""

    @property
    def key(self) -> str:
        return f"{self.arch_id}__{self.shape_name}"


def _bound(model: torch.nn.Module, params: dict) -> torch.nn.Module:
    """``model`` with ``params`` as its parameters: each tensor that is
    not the model's own parameter is copied into it (the cell's own
    ``args[0]`` copies nothing)."""
    own = dict(model.named_parameters())
    if params.keys() != own.keys():
        raise ValueError("a cell's params are named as its model's "
                         "parameters")
    with torch.no_grad():
        for name, p in own.items():
            if params[name] is not p:
                p.copy_(params[name])
    return model


def _opt_placements(mesh, p_pl) -> dict:
    from repro_torch.dist.sharding import replicated
    return {"m": p_pl, "v": p_pl, "step": replicated(mesh, ())}


def _meta_step(opt_state: dict) -> dict:
    """AdamW's state with its step counter on the moments' device (a meta
    cell holds no tensor off meta)."""
    dev = next(iter(opt_state["m"].values())).device
    if dev.type == "meta":
        opt_state = {**opt_state, "step": torch.empty(
            (), dtype=torch.int32, device=dev)}
    return opt_state


def batch_fields(batch) -> dict[str, torch.Tensor]:
    """A graph batch's (or any dataclass's) tensor fields by name (the
    placements' tree)."""
    return {f.name: getattr(batch, f.name)
            for f in dataclasses.fields(batch)
            if isinstance(getattr(batch, f.name), torch.Tensor)}


def _lm_cell(arch_id: str, shape_name: str, mesh, device, seed) -> Cell:
    """The reference's ``_lm_cell`` rules: the config padded for the
    model axis; parameters FSDP + tensor parallel (replicated under the
    ``dp_only`` train layout); AdamW moments in bf16 when n_layers ·
    d_model > 200,000 or ``dp_only``; decode at batch 1 places the cache's
    sequence over dp (the reference attends through the sequence-sharded
    combine there; ``fn`` runs the whole-cache step)."""
    from repro_torch.dist import sharding as sh
    spec = get_arch(arch_id)
    if shape_name in spec.skips:
        return Cell(arch_id, shape_name, lambda: None, (),
                    skipped=spec.skips[shape_name])
    ma = sh.model_axis_size(mesh) if mesh is not None else 1
    dims = LM_SHAPES[shape_name]
    b, s, kind = dims["global_batch"], dims["seq_len"], dims["kind"]
    if kind == "train":
        cell = lm_train_cell(arch_id, device=device, seed=seed,
                             model_axis=ma)
        model = cell.model
        opt_state = _meta_step(cell.opt_state)
        args = (dict(model.named_parameters()), opt_state, cell.tokens)

        def fn(params, opt, tokens):
            return lm_train_step(_bound(model, params), cell.opt_cfg, opt,
                                 tokens)
        note = "train_step"
        roles = ("params", "optimizer", "input")
    elif kind == "prefill":
        cell = lm_prefill_cell(arch_id, device=device, seed=seed,
                               model_axis=ma)
        model = cell.model
        args = (dict(model.named_parameters()), cell.tokens)

        def fn(params, tokens):
            return lm_prefill(_bound(model, params), tokens)
        note = "serve_step (prefill)"
        roles = ("params", "input")
    else:  # decode: one new token against a seq_len KV cache
        cfg = _lm_config(arch_id, False, ma)
        dev = resolve_device(device)
        model = LM(cfg, seed=seed, device=dev)
        cache = make_cache(cfg, b, s, device=dev)
        tokens = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        pos = torch.zeros((), dtype=torch.int32, device=dev)
        args = (dict(model.named_parameters()), cache, tokens, pos)
        seq_sharded = b == 1  # long context: cut the sequence, not batch

        def fn(params, cache, tokens, pos):
            return lm_decode_step(_bound(model, params), cache, tokens, pos)
        note = "serve_step (decode)" + (
            ", sequence-sharded KV placements" if seq_sharded else "")
        roles = ("params", "cache", "input", "input")
    pls = None
    if mesh is not None:
        cfg = model.cfg
        params = args[0]
        layout = cfg.train_layout if kind == "train" else "tp"
        p_pl = (sh.replicated(mesh, params) if layout == "dp_only" else
                sh.lm_param_shardings(mesh, params, fsdp=True,
                                      n_experts=cfg.moe_experts))
        dp = sh.dp_axes(mesh)
        names = sh.axis_names(mesh)
        if kind == "train":
            if layout == "dp_only":
                bdp = tuple(a for a in ("data", "model") if a in names)
                t_pl = sh.placements(mesh, (bdp, "pod" if "pod" in names
                                            else None))
            else:
                t_pl = sh.placements(mesh, (dp, None))
            pls = (p_pl, _opt_placements(mesh, p_pl), t_pl)
        elif kind == "prefill":
            pls = (p_pl, sh.placements(mesh, (dp, None)))
        else:
            pls = (p_pl, sh.lm_cache_shardings(mesh, args[1],
                                               seq_sharded=seq_sharded),
                   sh.placements(mesh, (None if seq_sharded else dp,
                                        None)),
                   sh.replicated(mesh, ()))
    return Cell(arch_id, shape_name, fn, args, roles, pls, note)


def _gnn_build(arch_id: str, shape_name: str, mesh, device, seed) -> Cell:
    from repro_torch.dist import sharding as sh
    cell = _gnn_cell(arch_id, shape_name, device=device, seed=seed)
    opt_state = _meta_step(cell.opt_state)
    params = dict(cell.model.named_parameters())
    args = (params, opt_state, cell.batch)

    def fn(params, opt, batch):
        return gnn_train_step(_bound(cell.model, params), cell.opt_cfg, opt,
                              batch)
    pls = None
    if mesh is not None:
        p_pl = sh.replicated(mesh, params)
        pls = (p_pl, _opt_placements(mesh, p_pl),
               sh.gnn_batch_shardings(mesh, batch_fields(cell.batch)))
    return Cell(arch_id, shape_name, fn, args,
                ("params", "optimizer", "input"), pls,
                f"train_step ({GNN_SHAPES[shape_name]['kind']})")


def _recsys_build(arch_id: str, shape_name: str, mesh, device,
                  seed) -> Cell:
    from repro_torch.dist import sharding as sh
    cell = _recsys_cell(arch_id, shape_name, device=device, seed=seed)
    kind = RECSYS_SHAPES[shape_name]["kind"]
    params = dict(cell.model.named_parameters())
    if kind == "train":
        opt_state = _meta_step(cell.opt_state)
        args = (params, opt_state) + cell.inputs

        def fn(params, opt, *inputs):
            return recsys_train_step(_bound(cell.model, params), cell.opt_cfg,
                                     opt, inputs)
        note = "train_step"
    else:
        args = (params,) + cell.inputs

        def fn(params, *inputs):
            return RecsysCell(arch_id, shape_name,
                              _bound(cell.model, params), inputs).step()
        note = ("serve_step" if kind == "serve"
                else "serve_step (retrieval, batched-dot)")
    pls = None
    if mesh is not None:
        dp = sh.dp_axes(mesh)
        p_pl = sh.dlrm_param_shardings(mesh, params)
        if kind == "retrieval":
            ins = (sh.placements(mesh, (None, None)),
                   sh.placements(mesh, (None, None, None)),
                   sh.placements(mesh, (dp, None, None)))
        else:
            ins = (sh.placements(mesh, (dp, None)),
                   sh.placements(mesh, (dp, None, None)),
                   sh.placements(mesh, (dp,)))[:len(cell.inputs)]
        pls = ((p_pl, _opt_placements(mesh, p_pl)) + ins
               if kind == "train" else (p_pl,) + ins)
    roles = ("params",) + ("optimizer",) * (kind == "train") + (
        "input",) * len(cell.inputs)
    return Cell(arch_id, shape_name, fn, args, roles, pls, note)


def build_cell(arch_id: str, shape_name: str, mesh=None, device="cuda",
               seed: int = 0) -> Cell:
    """The (arch, shape) cell of the reference's ``build_cell``, built on
    ``device`` (``"meta"``: shapes and dtypes, no allocation) through the
    port's own cells; with ``mesh``, its placements."""
    family = get_arch(arch_id).family
    if family == "lm":
        return _lm_cell(arch_id, shape_name, mesh, device, seed)
    if family == "gnn":
        return _gnn_build(arch_id, shape_name, mesh, device, seed)
    if family == "recsys":
        return _recsys_build(arch_id, shape_name, mesh, device, seed)
    raise ValueError(family)
