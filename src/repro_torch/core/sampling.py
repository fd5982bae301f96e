"""Unique random Selecting with Floyd's algorithm (port of the ``floyd``
path of ``repro/core/sampling.py``).

Each of the k steps draws from the not-yet-sampled range and resolves a
collision with a k-wide membership compare, vectorised over the whole
frontier. The draws come from ``prng`` with the reference's key schedule
(``fold_in(key, layer)``, then one ``split`` per step), so the sampled
neighbours equal the reference's bit for bit. The schedule's sub-keys are
one [sum(fanouts), 2] table (``prng.key_schedule``): a key given as a
tuple is laid out first, a table already on the device (the serve step's)
is read as it is. ``keysort``, ``reservoir`` and layer-wise selection are
not ported yet.
"""
from __future__ import annotations

import torch

from . import prng
from .graph import CSC, SENTINEL, take


def _ranges(csc: CSC, frontier: torch.Tensor):
    """(start, degree) per frontier node; sentinel/OOB nodes get degree 0."""
    nv = csc.n_nodes
    f = torch.clamp(frontier, 0, nv - 1)
    start = take(csc.ptr, f)
    deg = take(csc.ptr, f + 1) - start
    valid = (frontier >= 0) & (frontier < nv)
    return start, torch.where(valid, deg, torch.zeros_like(deg))


def select_floyd(csc: CSC, frontier: torch.Tensor, k: int,
                 subkeys: torch.Tensor) -> torch.Tensor:
    """Floyd's k unique uniform draws for every frontier node: neighbour
    VIDs [F, k], SENTINEL-padded where deg < k. ``subkeys`` is the layer's
    [k, 2] slice of the key schedule, on the frontier's device."""
    start, deg = _ranges(csc, frontier)
    f = frontier.shape[0]
    u_all = prng.uniform_rows(subkeys, f, frontier.device)  # [k, F]
    sel = torch.full((f, k), -1, dtype=torch.int32, device=frontier.device)
    for i in range(k):
        j = deg - k + i  # Floyd index (valid when deg >= k)
        t = torch.floor(u_all[i] * (j + 1).to(torch.float32)).to(torch.int32)
        t = torch.minimum(torch.clamp(t, min=0), torch.clamp(j, min=0))
        member = (sel == t[:, None]).any(dim=1)
        floyd_pick = torch.where(member, j, t)
        small_pick = torch.where(i < deg, torch.full_like(deg, i),
                                 torch.full_like(deg, -1))
        sel[:, i] = torch.where(deg >= k, floyd_pick, small_pick)
    nbrs = take(csc.idx, start[:, None] + sel)
    return torch.where(sel >= 0, nbrs, torch.full_like(nbrs, SENTINEL))


def schedule_of(key, fanouts, device) -> torch.Tensor:
    """``key`` as its [sum(fanouts), 2] schedule on ``device``: a tuple key
    is laid out by ``prng.key_schedule``, a table is checked and kept."""
    if not isinstance(key, torch.Tensor):
        return prng.key_schedule(key, fanouts).to(device)
    if tuple(key.shape) != (sum(fanouts), 2) or key.dtype != torch.int64:
        raise ValueError(f"a key schedule is [{sum(fanouts)}, 2] int64, got "
                         f"{tuple(key.shape)} {key.dtype}")
    return key


def sample_khop(csc: CSC, batch_nodes: torch.Tensor, fanouts: tuple[int, ...],
                key, selection: str = "floyd"
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Node-wise k-hop expansion → (all_nodes, edge_dst, edge_src) in
    original VIDs, SENTINEL-padded, duplicates kept (Reindexing dedups).
    The sampled child is the edge's source, the frontier node its dst.
    ``key`` is a request key or its schedule (``schedule_of``)."""
    if selection != "floyd":
        raise NotImplementedError(
            f"selection {selection!r} is not ported yet (only 'floyd')")
    frontier = batch_nodes.to(torch.int32)
    schedule = schedule_of(key, fanouts, frontier.device)
    nodes = [frontier]
    e_dst, e_src = [], []
    row = 0
    for k_l in fanouts:
        nbrs = select_floyd(csc, frontier, k_l, schedule[row:row + k_l])
        row += k_l
        children = nbrs.reshape(-1)
        e_dst.append(frontier[:, None].expand(-1, k_l).reshape(-1))
        e_src.append(children)
        nodes.append(children)
        frontier = children
    return torch.cat(nodes), torch.cat(e_dst), torch.cat(e_src)
