"""graphsage-reddit [arXiv:1706.02216]: 2 layers, d_hidden 128, mean
aggregator, sample sizes 25-10 — the paper's own evaluation model."""
from repro_torch.models.gnn import GNNConfig


def config() -> GNNConfig:
    return GNNConfig(
        name="graphsage-reddit", kind="graphsage", n_layers=2, d_hidden=128,
        aggregator="mean", sample_sizes=(25, 10))


def smoke_config() -> GNNConfig:
    return GNNConfig(
        name="graphsage-smoke", kind="graphsage", n_layers=2, d_hidden=16,
        aggregator="mean", sample_sizes=(3, 2))
