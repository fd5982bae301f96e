"""DLRM (RM2): sparse embedding tables, the dot interaction and two MLPs
(port of ``repro/models/dlrm.py``).

The lookup is the paper's Reindexing applied to a recommender batch. A
batch's lookups become one flat key each, f · V + idx into the stacked
[F · V, D] table, and one stable sort of those keys (``lookup_layout``:
``core.pipeline.transpose_layout`` under ``SLICE_CFG``, the card's digit
pass and rank kernels) gives their transposed layout: the lookup
positions in key order (``rev_perm``) and each table row's span in that
order (``rev_ptr``). The forward is a row gather (``index_select``); the
table's gradient is one span sum over that layout
(``kernels.ptr_scan.GatherRows``, the span-sum kernel on the card): each
row's lookups summed in a fixed order, no float atomics, the dense
[F, V, D] gradient that ``jax.grad`` gives. The batch's indices follow a
power law (38% of a field's lookups hit row 0 in ``dlrm_batch``), so a
scatter-add would serialize on that row or round differently from run to
run.

``embedding_bag_dedup`` is the reference's sort-unique-rank from the same
layout: each distinct row is read once, and its gradient is two span sums
(the lookups into their unique row, the unique rows into the table).

Matmuls run in float32 with torch's default, TF32 off for matmuls.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.costmodel import SLICE_CFG, EngineConfig
from repro_torch.core.graph import SENTINEL
from repro_torch.core.pipeline import transpose_layout
from repro_torch.kernels.ptr_scan import GatherRows

from .common import mlp_apply, mlp_init, seeded_generator
from .gnn import load_reference_params


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    bot_mlp: tuple[int, ...] = (512, 256, 64)
    top_mlp: tuple[int, ...] = (512, 512, 256, 1)
    vocab_size: int = 1_000_000  # rows per table
    hot: int = 1  # multi-hot bag size
    dtype: torch.dtype = torch.float32
    dedup: bool = False  # AutoGNN-style per-batch row dedup


class DLRM(nn.Module):
    """The reference's ``dlrm_init`` tree: one stacked ``tables`` [F, V,
    D] (N(0, 1/D)), the ``bot`` MLP (n_dense → bot_mlp) and the ``top``
    MLP (the interaction's F(F + 1)/2 pairs plus D → top_mlp), their
    weights N(0, 1/d_in) and biases zero. Drawn in float32 from one
    generator seeded with ``seed`` on ``device`` (the values depend on the
    device's generator)."""

    def __init__(self, cfg: DLRMConfig, seed: int = 0, device="cuda"):
        super().__init__()
        self.cfg = cfg
        g = seeded_generator(seed, device)
        tables = torch.randn(
            (cfg.n_sparse, cfg.vocab_size, cfg.embed_dim), generator=g,
            dtype=torch.float32, device=device).mul_(
                1.0 / math.sqrt(cfg.embed_dim))
        self.tables = nn.Parameter(tables.to(cfg.dtype))
        n_int = cfg.n_sparse + 1
        d_inter = n_int * (n_int - 1) // 2 + cfg.embed_dim
        for name, dims in (("bot", (cfg.n_dense,) + cfg.bot_mlp),
                           ("top", (d_inter,) + cfg.top_mlp)):
            setattr(self, name, nn.ParameterDict({
                k: nn.Parameter(v) for k, v in
                mlp_init(g, dims, cfg.dtype, device).items()}))

    def forward(self, dense, sparse_idx):
        return dlrm_forward(self, dense, sparse_idx)


def load_reference_dlrm_params(model: DLRM, params) -> DLRM:
    """Carry a reference ``dlrm_init`` tree (arrays convertible by
    ``np.asarray``) into ``model``, in place."""
    return load_reference_params(model, params)


# ------------------------------------------------------------------- lookup
@dataclasses.dataclass
class LookupLayout:
    """A batch's lookups in key order. ``keys`` [L] int32: lookup (b, f,
    h) at position (f · B + b) · hot + h holds f · V + idx[b, f, h];
    ``rev_perm`` [L] int32: the positions stably sorted by key;
    ``rev_ptr`` [F · V + 1] int32: row r's lookups at rev_perm[rev_ptr[r]
    .. rev_ptr[r + 1]]."""

    keys: torch.Tensor
    rev_perm: torch.Tensor
    rev_ptr: torch.Tensor


def lookup_keys(idx: torch.Tensor, vocab: int) -> torch.Tensor:
    """idx [B, F, hot] int32, each in [0, vocab) → the flat keys [F · B ·
    hot] int32, field-major (all of field 0's lookups first)."""
    b, f, hot = idx.shape
    if f * vocab > SENTINEL:
        raise ValueError(f"{f} tables of {vocab} rows overflow int32 keys")
    offs = torch.arange(f, dtype=torch.int32, device=idx.device) * vocab
    return (idx.to(torch.int32).permute(1, 0, 2)
            + offs[:, None, None]).reshape(-1).contiguous()


def lookup_layout(idx: torch.Tensor, vocab: int,
                  cfg: EngineConfig = SLICE_CFG) -> LookupLayout:
    """The transposed layout of a batch's lookups: one stable sort of the
    flat keys over the F · vocab rows and its pointer build, routed by
    ``cfg`` (default ``SLICE_CFG``: the digit-pass kernels and the fused
    rank epilogue on the card, their twins on the CPU). The keys are
    padded with SENTINEL to a multiple of ``cfg.w_upe`` (the reference
    sort's histogram tile on the CPU route); the pad sorts last and is
    cut off."""
    keys = lookup_keys(idx, vocab)
    n, w = keys.shape[0], cfg.w_upe
    pad = (-n) % w if n > w else 0
    src = F.pad(keys, (0, pad), value=SENTINEL) if pad else keys
    rev_perm, rev_ptr = transpose_layout(src, idx.shape[1] * vocab, cfg)
    return LookupLayout(keys, rev_perm[:n].contiguous(), rev_ptr)


@dataclasses.dataclass
class DedupIndex:
    """The sort-unique-rank of a layout's keys, over all fields at once
    (the reference's per field: field f's live unique rows are
    ``uniq[first[f · m] : first[(f + 1) · m]]`` less f · V, m = B · hot).
    ``first`` [L + 1] int32: the distinct keys among the first p sorted
    lookups; ``rank`` [L] int32: a sorted position's unique id;
    ``uniq`` [L + 1] int32: a unique id's key, F · V past the live
    prefix; ``inv`` [L] int32: a lookup's unique id."""

    first: torch.Tensor
    rank: torch.Tensor
    uniq: torch.Tensor
    inv: torch.Tensor


def dedup_index(layout: LookupLayout, n_rows: int) -> DedupIndex:
    """``DedupIndex`` of ``layout`` over ``n_rows`` = F · V table rows;
    integers only, every scatter writes one value a slot (equal keys write
    equal values), so the result does not depend on the write order."""
    perm = layout.rev_perm.to(torch.int64)
    n = perm.shape[0]
    sk = layout.keys.index_select(0, perm)
    is_first = torch.ones(n, dtype=torch.int32, device=sk.device)
    is_first[1:] = (sk[1:] != sk[:-1]).to(torch.int32)
    first = F.pad(torch.cumsum(is_first, 0, dtype=torch.int32), (1, 0))
    rank = first[1:] - 1
    uniq = torch.full((n + 1,), n_rows, dtype=torch.int32,
                      device=sk.device).scatter_(0, rank.to(torch.int64), sk)
    inv = torch.empty_like(rank).scatter_(0, perm, rank)
    return DedupIndex(first, rank, uniq, inv)


def _layout_for(tables, idx, layout, needed: bool):
    if layout is None and needed:
        layout = lookup_layout(idx, tables.shape[1])
    return layout


def _bags(rows: torch.Tensor, b: int, f: int, hot: int) -> torch.Tensor:
    """Field-major gathered rows [F · B · hot, D] → the bag sums [B, F,
    D]."""
    return rows.view(f, b, hot, rows.shape[-1]).sum(dim=2).transpose(0, 1)


def embedding_bag(tables: torch.Tensor, idx: torch.Tensor,
                  layout: LookupLayout | None = None) -> torch.Tensor:
    """EmbeddingBag(sum): tables [F, V, D], idx [B, F, hot] → [B, F, D].
    When ``tables`` needs a gradient the gather is ``GatherRows`` over the
    batch's layout (built here unless given), else a plain row gather."""
    f, v, d = tables.shape
    b, _, hot = idx.shape
    flat = tables.reshape(f * v, d)
    grad = torch.is_grad_enabled() and tables.requires_grad
    layout = _layout_for(tables, idx, layout, grad)
    keys = lookup_keys(idx, v) if layout is None else layout.keys
    if grad:
        rows = GatherRows.apply(flat, keys.to(torch.int64), layout.rev_ptr,
                                layout.rev_perm)
    else:
        rows = flat.index_select(0, keys.to(torch.int64))
    return _bags(rows, b, f, hot)


def embedding_bag_dedup(tables: torch.Tensor, idx: torch.Tensor,
                        layout: LookupLayout | None = None) -> torch.Tensor:
    """``embedding_bag`` through the batch's distinct rows: each is read
    once (``dedup_index``), then gathered back to its lookups. Under grad
    both gathers are ``GatherRows``: the lookups' gradients summed into
    their unique row over ``rev_perm``, then each unique row's into its
    table row. The unique rows' tail (ids past the live prefix, L in
    all) reads the last table row and nothing reads it back."""
    f, v, d = tables.shape
    b, _, hot = idx.shape
    layout = _layout_for(tables, idx, layout, True)
    dd = dedup_index(layout, f * v)
    n = dd.rank.shape[0]
    # unique id r's lookups sit at sorted positions rev_ptr[uniq[r]] ..;
    # table row r holds the unique ids first[rev_ptr[r]] ..
    ptr_u = layout.rev_ptr.index_select(0, dd.uniq.to(torch.int64))
    ptr_t = dd.first.index_select(0, layout.rev_ptr.to(torch.int64))
    flat = tables.reshape(f * v, d)
    urows = GatherRows.apply(
        flat, dd.uniq[:n].clamp(max=f * v - 1).to(torch.int64), ptr_t, None)
    rows = GatherRows.apply(urows, dd.inv.to(torch.int64), ptr_u,
                            layout.rev_perm)
    return _bags(rows, b, f, hot)


# ------------------------------------------------------------------ forward
def dlrm_forward(model: DLRM, dense: torch.Tensor, sparse_idx: torch.Tensor,
                 layout: LookupLayout | None = None) -> torch.Tensor:
    """dense [B, n_dense] float32, sparse_idx [B, F, hot] int32 → logits
    [B]: the bottom MLP, the bags, the pairwise dot products of the F + 1
    vectors above the diagonal (row-major) beside the bottom output, the
    top MLP."""
    cfg = model.cfg
    x = mlp_apply(model.bot, dense.to(cfg.dtype), act=torch.relu,
                  final_act=True)
    bag = embedding_bag_dedup if cfg.dedup else embedding_bag
    emb = bag(model.tables, sparse_idx, layout)
    z = torch.cat([x[:, None, :], emb], dim=1)
    n = z.shape[1]
    inter = torch.bmm(z, z.transpose(1, 2)).reshape(z.shape[0], n * n)
    iu, ju = torch.triu_indices(n, n, offset=1, device=z.device)
    flat = inter.index_select(1, iu * n + ju)
    top_in = torch.cat([flat, x], dim=1)
    return mlp_apply(model.top, top_in, act=torch.relu)[:, 0]


def dlrm_loss(model: DLRM, dense, sparse_idx, labels,
              layout: LookupLayout | None = None) -> torch.Tensor:
    """Mean binary cross entropy of the logits against ``labels`` (0 / 1),
    the reference's stable form."""
    logits = dlrm_forward(model, dense, sparse_idx, layout).to(torch.float32)
    y = labels.to(torch.float32)
    return torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))


@torch.no_grad()
def dlrm_retrieval(model: DLRM, dense: torch.Tensor, user_idx: torch.Tensor,
                   cand_idx: torch.Tensor, top_k: int = 100
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """One query against N candidates, scored in one batch: dense [1,
    n_dense], user_idx [1, F_u, hot], cand_idx [N, F_c, hot] (F_u + F_c =
    F) → the ``top_k`` scores, largest first, and their candidate indices
    int32; equal scores keep the lower index first (a stable descending
    sort, as ``jax.lax.top_k`` orders them)."""
    n = cand_idx.shape[0]
    if top_k > n:
        raise ValueError(f"top_k {top_k} is larger than the {n} candidates")
    idx = torch.cat([user_idx.expand(n, -1, -1), cand_idx], dim=1)
    scores = dlrm_forward(model, dense.expand(n, -1), idx)
    top, ix = torch.sort(scores, descending=True, stable=True)
    return top[:top_k], ix[:top_k].to(torch.int32)
