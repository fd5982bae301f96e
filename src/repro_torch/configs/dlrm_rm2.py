"""dlrm-rm2 [arXiv:1906.00091; paper]: 13 dense + 26 sparse features,
embed_dim=64, bot MLP 13-512-256-64, top MLP 512-512-256-1, dot
interaction; 1M rows per table (RM2 class)."""
import torch

from repro_torch.models.dlrm import DLRMConfig


def config() -> DLRMConfig:
    return DLRMConfig(
        name="dlrm-rm2", n_dense=13, n_sparse=26, embed_dim=64,
        bot_mlp=(512, 256, 64), top_mlp=(512, 512, 256, 1),
        vocab_size=1_000_000, hot=1, dtype=torch.float32)


def smoke_config() -> DLRMConfig:
    return DLRMConfig(
        name="dlrm-rm2-smoke", n_dense=13, n_sparse=6, embed_dim=16,
        bot_mlp=(32, 16), top_mlp=(32, 16, 1), vocab_size=1000, hot=2,
        dtype=torch.float32)
