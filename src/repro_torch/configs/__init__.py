"""Model configurations of the port: the four GNN families the serve
paths run (graphsage-reddit, gat-cora, gatedgcn, meshgraphnet) and
gemma2-9b (the LM prefill and training paths)."""
from __future__ import annotations

from . import gat_cora, gatedgcn, gemma2_9b, graphsage_reddit, meshgraphnet

_CONFIGS = {"graphsage-reddit": graphsage_reddit, "gat-cora": gat_cora,
            "gatedgcn": gatedgcn, "meshgraphnet": meshgraphnet,
            "gemma2-9b": gemma2_9b}

# the reference's LM shape cells (repro/configs/base.py) the port runs
LM_SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
}


# the reference's GNN shape cells (repro/configs/base.py)
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


def get_config(arch: str, smoke: bool = False):
    if arch not in _CONFIGS:
        raise KeyError(f"unknown or unported arch {arch!r}; "
                       f"ported: {sorted(_CONFIGS)}")
    mod = _CONFIGS[arch]
    return mod.smoke_config() if smoke else mod.config()
