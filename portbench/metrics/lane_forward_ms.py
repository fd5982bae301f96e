"""The median, over the traced requests, of the device time of the
forward on the request's subgraph (``subgraph_batch`` and the model)."""
from portbench.harness import median


def read(ctx):
    return median(ctx.lanes["forward"])
