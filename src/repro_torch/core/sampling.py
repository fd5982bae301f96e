"""Unique random Selecting (port of ``repro/core/sampling.py``): the
node-wise selectors (Floyd's algorithm, keysort and reservoir) and
layer-wise selection.

* ``floyd``: each of the k steps draws from the not-yet-sampled range and
  resolves a collision with a k-wide membership compare, vectorised over
  the whole frontier.
* ``keysort``: a uniform key for each neighbour slot of a bounded window
  (masked slots hold 2.0), the k smallest taken in ascending order, ties
  to the lower slot (``lax.top_k``'s rule: a stable ascending sort).
* ``reservoir``: the sequential baseline, one reservoir step a slot past
  the first k, up to the window.

The draws come from ``prng`` with the reference's key schedule
(``fold_in(key, layer)``, then the selector's ``split`` chain), so the
sampled neighbours equal the reference's bit for bit. The schedule's
sub-keys are one [K, 2] table (``prng.key_schedule``, its layout a
function of the selection, the fanouts and the window): a key given as a
tuple is laid out first, a table already on the device (the serve
step's) is read as it is.

Layer-wise selection (``select_layerwise``, ``sample_layerwise``) draws k
nodes a layer from the union of the frontier's neighbourhoods, its keys
derived on the host with ``prng.split`` / ``fold_in`` as the reference
derives them.
"""
from __future__ import annotations

import torch

from . import prng
from .graph import CSC, SENTINEL, take
from .set_count import rank_in_sorted

DEFAULT_WINDOW = 1024  # the reference's sample_khop window


def _ranges(csc: CSC, frontier: torch.Tensor):
    """(start, degree) per frontier node; sentinel/OOB nodes get degree 0."""
    nv = csc.n_nodes
    f = torch.clamp(frontier, 0, nv - 1)
    start = take(csc.ptr, f)
    deg = take(csc.ptr, f + 1) - start
    valid = (frontier >= 0) & (frontier < nv)
    return start, torch.where(valid, deg, torch.zeros_like(deg))


def _neighbours(csc: CSC, start: torch.Tensor, sel: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """VIDs at positions ``start + sel`` ([F, k]), SENTINEL where not
    ``valid``."""
    nbrs = take(csc.idx, start[:, None] + sel)
    return torch.where(valid, nbrs, torch.full_like(nbrs, SENTINEL))


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
    return _neighbours(csc, start, sel, sel >= 0)


def smallest_k(r: torch.Tensor, k: int) -> torch.Tensor:
    """Column indices [F, k] of each row's k smallest values in ascending
    order, ties to the lower column: ``lax.top_k(-r, k)``'s indices,
    as the first k columns of a stable ascending sort (``torch.topk``
    promises no tie order)."""
    return torch.sort(r, dim=1, stable=True).indices[:, :k]


def select_keysort(csc: CSC, frontier: torch.Tensor, k: int,
                   subkeys: torch.Tensor,
                   window: int = DEFAULT_WINDOW) -> torch.Tensor:
    """Random-key top-k over each node's first ``window`` neighbours:
    ``r`` [F, window] is ``uniform(layer key, (F, window))`` (row-major
    counters), masked slots 2.0; the k smallest in ascending order, ties
    to the lower slot, are a stable ascending sort's first k columns.
    ``subkeys`` is the layer's [1, 2] row (the layer key)."""
    start, deg = _ranges(csc, frontier)
    f = frontier.shape[0]
    offs = torch.arange(window, dtype=torch.int32,
                        device=frontier.device)[None, :]
    mask = offs < torch.clamp(deg, max=window)[:, None]  # [F, W]
    r = prng.uniform_rows(subkeys, f * window,
                          frontier.device).reshape(f, window)
    r = torch.where(mask, r, torch.full_like(r, 2.0))
    idx = smallest_k(r, k)
    return _neighbours(csc, start, idx.to(torch.int32),
                       torch.gather(mask, 1, idx))


def select_reservoir(csc: CSC, frontier: torch.Tensor, k: int,
                     subkeys: torch.Tensor,
                     window: int = DEFAULT_WINDOW) -> torch.Tensor:
    """Reservoir sampling, serial in the window: slots 0..k-1 first, then
    step i (k <= i < window) draws j uniform in [0, i] and, where node
    has an i-th neighbour and j < k, puts i into reservoir slot j.
    ``subkeys`` is the layer's [window - k, 2] slice, one row a step."""
    start, deg = _ranges(csc, frontier)
    f = frontier.shape[0]
    slots = torch.arange(k, dtype=torch.int32,
                         device=frontier.device)[None, :]
    res = torch.where(slots < deg[:, None], slots, torch.full_like(slots, -1))
    u_all = prng.uniform_rows(subkeys, f, frontier.device)  # [W - k, F]
    for step, i in enumerate(range(k, window)):
        j = torch.floor(u_all[step] * float(i + 1)).to(torch.int32)
        hit = (slots == j[:, None]) & ((i < deg) & (j < k))[:, None]
        res = torch.where(hit, torch.full_like(res, i), res)
    return _neighbours(csc, start, res, res >= 0)


def select_layerwise(csc: CSC, frontier: torch.Tensor, k: int, key,
                     window: int = 64) -> torch.Tensor:
    """Layer-wise selection: up to ``window`` neighbours of every frontier
    node (from a random start in its range, so long lists are covered)
    form one candidate array; repeats are masked (a sort, then SENTINEL on
    each equal successor) and k of the rest are drawn uniformly: the k
    smallest of ``uniform(k2, ...)`` (SENTINEL slots 2.0), in ascending
    order, ties to the lower slot (``lax.top_k(-r, k)``). ``key`` is one
    request key ``(k0, k1)``; ``k1, k2 = split(key)``. Returns [k] node ids,
    SENTINEL where the union is smaller than k."""
    start, deg = _ranges(csc, frontier)
    f = frontier.shape[0]
    dev = frontier.device
    k1, k2 = prng.split(key)
    max_start = torch.clamp(deg - window, min=0)
    off0 = torch.floor(prng.uniform(k1, f, dev)
                       * (max_start + 1).to(torch.float32)).to(torch.int32)
    offs = off0[:, None] + torch.arange(window, dtype=torch.int32,
                                        device=dev)[None, :]
    cand = take(csc.idx, start[:, None] + offs)
    cand = torch.where(offs < deg[:, None], cand,
                       torch.full_like(cand, SENTINEL)).reshape(-1)
    cand = torch.sort(cand).values
    dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                     cand[1:] == cand[:-1]])
    cand = torch.where(dup, torch.full_like(cand, SENTINEL), cand)
    r = prng.uniform(k2, cand.shape[0], dev)
    r = torch.where(cand != SENTINEL, r, torch.full_like(r, 2.0))
    return take(cand, smallest_k(r[None, :], k)[0])


def sample_layerwise(csc: CSC, batch_nodes: torch.Tensor,
                     layer_sizes: tuple[int, ...], key, window: int = 64
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Layer-wise k-hop sampling → (nodes, edge_dst, edge_src) like
    ``sample_khop``: layer l draws ``layer_sizes[l]`` nodes with
    ``select_layerwise`` under ``fold_in(key, l)``; its edges join each
    frontier node to the drawn nodes among its first ``window``
    neighbours (a rank search in the sorted draw), SENTINEL elsewhere."""
    frontier = batch_nodes.to(torch.int32)
    dev = frontier.device
    nodes = [frontier]
    e_dst, e_src = [], []
    offs = torch.arange(window, dtype=torch.int32, device=dev)[None, :]
    for layer, k_l in enumerate(layer_sizes):
        picked = select_layerwise(csc, frontier, k_l,
                                  prng.fold_in(key, layer), window=window)
        start, deg = _ranges(csc, frontier)
        sp = torch.sort(picked).values
        f = frontier.shape[0]
        nbr = take(csc.idx, start[:, None] + offs)
        nbr = torch.where(offs < torch.clamp(deg, max=window)[:, None], nbr,
                          torch.full_like(nbr, SENTINEL))
        r = rank_in_sorted(sp, nbr.reshape(-1)).reshape(f, window)
        hit = take(sp, torch.clamp(r, 0, k_l - 1)) == nbr
        sen = torch.full_like(nbr, SENTINEL)
        e_dst.append(torch.where(hit, frontier[:, None].expand_as(nbr),
                                 sen).reshape(-1))
        e_src.append(torch.where(hit, nbr, sen).reshape(-1))
        nodes.append(picked)
        frontier = picked
    return torch.cat(nodes), torch.cat(e_dst), torch.cat(e_src)


_SELECTORS = {"floyd": select_floyd, "keysort": select_keysort,
              "reservoir": select_reservoir}


def schedule_of(key, fanouts, device, selection: str = "floyd",
                window: int = DEFAULT_WINDOW) -> torch.Tensor:
    """``key`` as its [K, 2] schedule on ``device``: a tuple key is laid
    out by ``prng.key_schedule``, a table is checked and kept."""
    if not isinstance(key, torch.Tensor):
        return prng.key_schedule(key, fanouts, selection, window).to(device)
    rows = sum(prng.schedule_rows(selection, fanouts, window))
    if tuple(key.shape) != (rows, 2) or key.dtype != torch.int64:
        raise ValueError(f"a {selection} key schedule is [{rows}, 2] int64, "
                         f"got {tuple(key.shape)} {key.dtype}")
    return key


def sample_khop(csc: CSC, batch_nodes: torch.Tensor, fanouts: tuple[int, ...],
                key, selection: str = "floyd", window: int = DEFAULT_WINDOW
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Node-wise k-hop expansion → (all_nodes, edge_dst, edge_src) in
    original VIDs, SENTINEL-padded, duplicates kept (Reindexing dedups).
    The sampled child is the edge's source, the frontier node its dst.
    ``key`` is a request key or its schedule (``schedule_of``); ``window``
    bounds keysort's and reservoir's neighbour range."""
    if selection not in _SELECTORS:
        raise ValueError(f"unknown selection {selection!r}; node-wise "
                         f"selections: {sorted(_SELECTORS)}")
    select = _SELECTORS[selection]
    frontier = batch_nodes.to(torch.int32)
    schedule = schedule_of(key, fanouts, frontier.device, selection, window)
    nodes = [frontier]
    e_dst, e_src = [], []
    row = 0
    for k_l, n in zip(fanouts, prng.schedule_rows(selection, fanouts,
                                                  window)):
        sub = schedule[row:row + n]
        row += n
        nbrs = (select(csc, frontier, k_l, sub) if selection == "floyd"
                else select(csc, frontier, k_l, sub, window))
        children = nbrs.reshape(-1)
        e_dst.append(frontier[:, None].expand(-1, k_l).reshape(-1))
        e_src.append(children)
        nodes.append(children)
        frontier = children
    return torch.cat(nodes), torch.cat(e_dst), torch.cat(e_src)
