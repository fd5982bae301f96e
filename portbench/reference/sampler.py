"""One request's sampled subgraph, plainly: Floyd k-hop sampling under the
request's key, first-occurrence reindexing, and the subgraph's CSC.

Semantics (what the program must produce for the same graph, seeds and
key):

* The seeds row is ``seed_cap`` node ids, SENTINEL past the request's own.
* Layer l draws, for every frontier slot, k_l distinct neighbour positions
  by Floyd's algorithm with the l-th layer's k_l sub-keys
  (``prng.floyd_schedule``): step i draws t uniform in [0, j], j = deg -
  k_l + i, and takes j instead when t was taken before. A node with fewer
  than k_l neighbours takes them all, in order; an absent one (SENTINEL)
  has none. Unfilled slots are SENTINEL. Every slot's children are the
  next frontier; the edges are (frontier node, child).
* New ids number the distinct node ids of the concatenated frontiers in
  order of first occurrence (``order``), SENTINEL-padded to the list's
  length. An edge with a SENTINEL end is dropped.
* The subgraph's CSC orders its edges by (new dst, new src); ``ptr`` has
  one entry per slot of the node list plus one, ``idx`` is padded with
  SENTINEL to the next power of two of the sampled edge slots.
"""
from __future__ import annotations

import torch

from . import prng

SENTINEL = 0x7FFFFFFF


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return x[i.clamp(0, x.shape[0] - 1).to(torch.int64)]


def floyd_layer(ptr, idx, n_nodes, frontier, k, keys) -> torch.Tensor:
    """[F, k] neighbour ids of every frontier slot, SENTINEL-padded."""
    f = frontier.shape[0]
    dev = frontier.device
    valid = (frontier >= 0) & (frontier < n_nodes)
    fc = frontier.clamp(0, n_nodes - 1).to(torch.int64)
    start = ptr[fc]
    deg = torch.where(valid, ptr[fc + 1] - start, torch.zeros_like(start))
    u = prng.uniform_rows(keys, f, dev)
    sel = torch.full((f, k), -1, dtype=torch.int32, device=dev)
    for i in range(k):
        j = deg - k + i
        t = torch.floor(u[i] * (j + 1).to(torch.float32)).to(torch.int32)
        t = torch.minimum(t.clamp(min=0), j.clamp(min=0))
        taken = (sel == t[:, None]).any(dim=1)
        floyd = torch.where(taken, j, t)
        small = torch.where(deg > i, torch.full_like(deg, i),
                            torch.full_like(deg, -1))
        sel[:, i] = torch.where(deg >= k, floyd, small)
    nb = _take(idx, start[:, None] + sel)
    return torch.where(sel >= 0, nb, torch.full_like(nb, SENTINEL))


def _lex_sort(a: torch.Tensor, b: torch.Tensor):
    key = torch.sort((a.to(torch.int64) << 31) | b.to(torch.int64)).values
    return (key >> 31), (key & SENTINEL).to(torch.int32)


def sample(ptr: torch.Tensor, idx: torch.Tensor, n_nodes: int,
           seeds_row: torch.Tensor, fanouts, key) -> dict:
    """The request's subgraph and the live sizes the counts read."""
    dev = seeds_row.device
    frontier = seeds_row.to(torch.int32)
    nodes, e_dst, e_src = [frontier], [], []
    frontier_live = 0
    for layer, keys in enumerate(prng.floyd_schedule(key, fanouts)):
        k = len(keys)
        frontier_live += int((frontier != SENTINEL).sum())
        nbrs = floyd_layer(ptr, idx, n_nodes, frontier, k, keys)
        children = nbrs.reshape(-1)
        e_dst.append(frontier[:, None].expand(-1, k).reshape(-1))
        e_src.append(children)
        nodes.append(children)
        frontier = children
    nodes, e_dst, e_src = torch.cat(nodes), torch.cat(e_dst), torch.cat(e_src)
    n = nodes.shape[0]

    live = nodes != SENTINEL
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    uniq, inv = torch.unique(nodes[live], return_inverse=True)
    first = torch.full((uniq.shape[0],), n, dtype=torch.int64, device=dev)
    first = first.scatter_reduce(0, inv, pos[live], "amin")
    by_first = torch.argsort(first)
    n_unique = uniq.shape[0]
    new_of = torch.empty_like(by_first)
    new_of[by_first] = torch.arange(n_unique, device=dev)
    order = torch.full((n,), SENTINEL, dtype=torch.int32, device=dev)
    order[:n_unique] = uniq[by_first].to(torch.int32)

    ok = (e_dst != SENTINEL) & (e_src != SENTINEL)
    nd = new_of[torch.searchsorted(uniq, e_dst[ok])]
    ns = new_of[torch.searchsorted(uniq, e_src[ok])]
    sd, ss = _lex_sort(nd, ns)
    n_edges = sd.shape[0]
    sub_idx = torch.full((next_pow2(e_dst.shape[0]),), SENTINEL,
                         dtype=torch.int32, device=dev)
    sub_idx[:n_edges] = ss
    sub_ptr = torch.searchsorted(
        sd, torch.arange(n + 1, dtype=torch.int64, device=dev)
    ).to(torch.int32)
    return dict(order=order, n_unique=n_unique, ptr=sub_ptr, idx=sub_idx,
                n_edges=n_edges, edge_dst=sd, edge_src=ss.to(torch.int64),
                n_seeds=int((seeds_row != SENTINEL).sum()),
                frontier_live=frontier_live)
