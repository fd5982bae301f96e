"""Bytes a graph conversion must move: every live edge's dst and src read
(8 B) and its src written to the CSC's indices (4 B), and the n + 1
pointers written (4 B each)."""


def convert_bytes(n_nodes: int, n_edges: int) -> int:
    return 12 * n_edges + 4 * (n_nodes + 1)
