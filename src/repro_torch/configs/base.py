"""Config registry of the port (port of ``repro/configs/base.py``): every
architecture the reference registers, its shape cells and per-cell skips.

Each ``configs/<module>.py`` exposes ``config()`` (the published numbers)
and ``smoke_config()`` (a small variant of the same family for CPU tests);
``launch/steps.py`` turns (arch, shape) into a cell. The registry keeps
the reference's ids, families, shapes, skips and notes.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any

LM_SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}

GNN_SHAPES = {
    "full_graph_sm": dict(kind="full_graph", n_nodes=2708, n_edges=10556,
                          d_feat=1433, n_classes=7),
    "minibatch_lg": dict(kind="minibatch", n_nodes=232965,
                         n_edges=114615892, batch_nodes=1024,
                         fanout=(15, 10), d_feat=602, n_classes=41),
    "ogb_products": dict(kind="full_graph", n_nodes=2449029,
                         n_edges=61859140, d_feat=100, n_classes=47),
    "molecule": dict(kind="batched_graphs", n_nodes=30, n_edges=64,
                     batch=128, d_feat=16, n_classes=2),
}

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1,
                           n_candidates=1_000_000),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    id: str
    family: str  # lm | gnn | recsys
    module: str
    shapes: tuple[str, ...]
    skips: dict[str, str] = dataclasses.field(default_factory=dict)
    notes: str = ""


ARCHS: dict[str, ArchSpec] = {}

def _reg(spec: ArchSpec):
    ARCHS[spec.id] = spec


_FULL_ATTN_SKIP = ("long_500k lowers serve_step with a 524288-token KV "
                   "cache; skipped per spec for pure full-attention archs "
                   "(see DESIGN.md §4).")

_reg(ArchSpec("grok-1-314b", "lm", "grok1_314b", tuple(LM_SHAPES),
              skips={"long_500k": _FULL_ATTN_SKIP},
              notes="MoE 8e top-2; dispatch uses UPE set-partitioning."))
_reg(ArchSpec("granite-moe-1b-a400m", "lm", "granite_moe_1b",
              tuple(LM_SHAPES), skips={"long_500k": _FULL_ATTN_SKIP},
              notes="MoE 32e top-8; expert-parallel over model axis."))
_reg(ArchSpec("qwen1.5-32b", "lm", "qwen15_32b", tuple(LM_SHAPES),
              skips={"long_500k": _FULL_ATTN_SKIP},
              notes="MHA (kv=40); int8 KV cache for decode_32k."))
_reg(ArchSpec("codeqwen1.5-7b", "lm", "codeqwen15_7b", tuple(LM_SHAPES),
              skips={"long_500k": _FULL_ATTN_SKIP},
              notes="qwen1.5 arch, 7B."))
_reg(ArchSpec("gemma2-9b", "lm", "gemma2_9b", tuple(LM_SHAPES),
              notes="local+global alternating → long_500k RUNS (local "
                    "layers are sliding-window; global layers use "
                    "sequence-sharded LSE-combined decode)."))

for _gid, _mod, _note in [
        ("graphsage-reddit", "graphsage_reddit",
         "THE paper's eval model (2-layer GraphSAGE, k=10)."),
        ("gat-cora", "gat_cora", "8-head GAT."),
        ("gatedgcn", "gatedgcn", "16-layer gated edge MPNN."),
        ("meshgraphnet", "meshgraphnet", "encode-process-decode, 15 steps.")]:
    _reg(ArchSpec(_gid, "gnn", _mod, tuple(GNN_SHAPES), notes=_note))

_reg(ArchSpec("dlrm-rm2", "recsys", "dlrm_rm2", tuple(RECSYS_SHAPES),
              notes="EmbeddingBag built on take+segment_sum; AutoGNN "
                    "reindex-dedup available."))


def get_arch(arch_id: str) -> ArchSpec:
    return ARCHS[arch_id]


def get_config(arch_id: str, smoke: bool = False) -> Any:
    """The config of ``arch_id`` (its smoke variant with ``smoke``); an
    unknown id raises ``KeyError``."""
    spec = ARCHS[arch_id]
    mod = importlib.import_module(f"repro_torch.configs.{spec.module}")
    return mod.smoke_config() if smoke else mod.config()


def all_cells() -> list[tuple[str, str]]:
    """Every (arch, shape) pair, 40 in all, skipped cells included, in the
    reference's order."""
    return [(a, s) for a, spec in ARCHS.items() for s in spec.shapes]
