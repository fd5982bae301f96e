"""Model configurations of the port and their registry (``base``): the
five LM architectures (gemma2-9b, granite-moe-1b-a400m, codeqwen1.5-7b,
qwen1.5-32b, grok-1-314b), the four GNN families (graphsage-reddit,
gat-cora, gatedgcn, meshgraphnet) and the recommender dlrm-rm2."""
from .base import (ARCHS, GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES, ArchSpec,
                   all_cells, get_arch, get_config)

__all__ = ["ARCHS", "ArchSpec", "GNN_SHAPES", "LM_SHAPES", "RECSYS_SHAPES",
           "all_cells", "get_arch", "get_config"]
