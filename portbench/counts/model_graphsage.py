"""Forward operations of GraphSAGE (mean aggregator) on a live subgraph of
``n`` nodes and ``e`` edges, every layer over every live node:

* the neighbour mean: ``e * d_in`` additions and ``n * d_in`` divisions;
* the two products: ``2 * 2 * n * d_in * d_out``, and the bias ``n * d_out``;
* between layers ReLU ``n * d``, L2 norm ``2 * n * d`` (squares and their
  sum) plus ``n * d`` divisions;
* the head: ``2 * n * d * n_classes``.
"""


def forward_flops(model: dict, d_in: int, n_classes: int, n: int,
                  e: int) -> float:
    d = model["d_hidden"]
    flops, width = 0.0, d_in
    for i in range(model["n_layers"]):
        flops += (e + n) * width + 4.0 * n * width * d + n * d
        if i < model["n_layers"] - 1:
            flops += 4.0 * n * d
        width = d
    return flops + 2.0 * n * d * n_classes
