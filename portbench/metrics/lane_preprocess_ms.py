"""The median, over the traced requests, of the device time of the
operations that one eager ``pipeline.sample_subgraph`` call launches at
the cell's shapes (sampling, reindexing and the subgraph's CSC)."""
from portbench.harness import median


def read(ctx):
    return median(ctx.lanes["preprocess"])
