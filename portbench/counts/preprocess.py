"""Bytes one request's preprocessing (sampling, reindexing, the subgraph's
CSC) must move, each input byte read once and each output byte written
once, from the live sizes the reference computes (4-byte ids):

* read: the seeds (``4 * n_seeds``), a pointer pair for every live
  frontier slot of every hop (``8 * frontier_live``) and the sampled
  neighbour id of every live edge (``4 * n_edges``);
* written: the node list (``4 * n_unique``), its pointers
  (``4 * (n_unique + 1)``) and the CSC's indices (``4 * n_edges``).

Nothing intermediate (the unsorted edge list, sort passes, maps) counts.
"""


def request_bytes(n_seeds: int, frontier_live: int, n_edges: int,
                  n_unique: int) -> int:
    return (4 * n_seeds + 8 * frontier_live + 4 * n_edges
            + 4 * n_unique + 4 * (n_unique + 1) + 4 * n_edges)
