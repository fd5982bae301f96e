"""gatedgcn [arXiv:2003.00982]: 16 layers, d_hidden 70, gated
aggregation with edge states."""
from repro_torch.models.gnn import GNNConfig


def config() -> GNNConfig:
    return GNNConfig(
        name="gatedgcn", kind="gatedgcn", n_layers=16, d_hidden=70,
        aggregator="gated")


def smoke_config() -> GNNConfig:
    return GNNConfig(
        name="gatedgcn-smoke", kind="gatedgcn", n_layers=3, d_hidden=8,
        aggregator="gated")
