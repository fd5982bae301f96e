"""meshgraphnet [arXiv:2010.03409]: 15 layers, d_hidden 128, sum
aggregation, 2-layer MLPs, encode-process-decode, node regression
(d_out 3)."""
from repro_torch.models.gnn import GNNConfig


def config() -> GNNConfig:
    return GNNConfig(
        name="meshgraphnet", kind="meshgraphnet", n_layers=15, d_hidden=128,
        aggregator="sum", mlp_layers=2, d_out=3)


def smoke_config() -> GNNConfig:
    return GNNConfig(
        name="meshgraphnet-smoke", kind="meshgraphnet", n_layers=2,
        d_hidden=16, aggregator="sum", mlp_layers=2, d_out=3)
