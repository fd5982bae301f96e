"""gat-cora [arXiv:1710.10903]: 2 layers, d_hidden 8, 8 heads (the last
layer one), attention aggregation."""
from repro_torch.models.gnn import GNNConfig


def config() -> GNNConfig:
    return GNNConfig(
        name="gat-cora", kind="gat", n_layers=2, d_hidden=8, n_heads=8,
        aggregator="attn")


def smoke_config() -> GNNConfig:
    return GNNConfig(
        name="gat-smoke", kind="gat", n_layers=2, d_hidden=4, n_heads=2,
        aggregator="attn")
