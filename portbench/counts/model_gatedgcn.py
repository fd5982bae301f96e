"""Forward operations of GatedGCN (zero initial edge states) on a live
subgraph of ``n`` nodes and ``e`` edges, width ``d``:

* the node embedding ``2 * n * d_in * d``; the head ``2 * n * d * n_classes``;
* per layer the node products A, B, U, V: ``4 * 2 * n * d * d``; the edge
  product C: ``2 * e * d * d``;
* per layer on edges: e' (2 additions), the gate (a sigmoid, counted 3),
  the message (1), the two neighbour sums (2), LayerNorm (8) and the
  residual ReLU (2): ``18 * e * d``;
* per layer on nodes: the quotient with its epsilon (2), the U addition
  (1), LayerNorm (8) and the residual ReLU (2): ``13 * n * d``.
"""


def forward_flops(model: dict, d_in: int, n_classes: int, n: int,
                  e: int) -> float:
    d = model["d_hidden"]
    per_layer = 8.0 * n * d * d + 2.0 * e * d * d + 18.0 * e * d + 13.0 * n * d
    return (2.0 * n * d_in * d + model["n_layers"] * per_layer
            + 2.0 * n * d * n_classes)
