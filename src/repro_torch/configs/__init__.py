"""Model configurations of the port and their registry (``base``): the
five LM architectures (gemma2-9b, granite-moe-1b-a400m, codeqwen1.5-7b,
qwen1.5-32b, grok-1-314b), the four GNN families (graphsage-reddit,
gat-cora, gatedgcn, meshgraphnet) and dlrm-rm2, whose substrate waits for
ROADMAP.md A.8."""
from .base import (ARCHS, GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES, UNPORTED,
                   ArchSpec, all_cells, get_arch, get_config)

__all__ = ["ARCHS", "ArchSpec", "GNN_SHAPES", "LM_SHAPES", "RECSYS_SHAPES",
           "UNPORTED", "all_cells", "get_arch", "get_config"]
