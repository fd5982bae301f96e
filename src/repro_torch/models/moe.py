"""Mixture-of-Experts layer with atomic-free token dispatch (port of
``moe_init`` and ``moe_apply`` of ``repro/models/moe.py``).

Token → expert dispatch is a set partition of the (token, expert) pairs
by expert id: a pair's rank inside its expert's bucket is an exclusive
prefix sum (``core.set_partition.prefix_sum``) over a one-hot of the
expert ids, and the rank is the pair's capacity slot; pairs ranked at or
past the capacity are dropped. The expert products run grouped,
``[E, cap, d]`` against ``[E, d, d_ff]`` (``torch.bmm``), and the
combine sums each token's k weighted rows over k (the pairs are
token-major, so no scatter-add and no float atomics); the backward of the
tokens' gather into their slots sums a token's k slot rows the same way.

Every shape is fixed by (T, E, k, cap) and nothing is read on the host,
so the layer can run inside a captured decode step: a dropped pair is
scattered into a spare row past ``E · cap`` that is thrown away (the
reference's ``mode="drop"``), not masked out by a boolean index.

``moe_apply_local`` is the reference's shard-local dispatch (GShard-style
per-data-shard capacity groups): a data-parallel rank holds its own
tokens, and they are its group, so its capacity and ranks come from its
tokens alone and no dispatch crosses a rank; only the aux loss's means
(f and P) are all-reduced over the dp group. With no mesh, or a dp
extent of 1, it is ``moe_apply``. The forward routes through it, the
decode step through ``moe_apply``, as the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.set_partition import prefix_sum
from repro_torch.dist.groups import Reduce, dp_group
from repro_torch.dist.hints import _current_mesh, mesh_info
from repro_torch.dist.sharding import _axes_size

from .common import dense_init, normal_init


def moe_init(generator: torch.Generator, d_model: int, d_ff: int,
             n_experts: int, dtype=torch.float32,
             device=None) -> dict[str, torch.Tensor]:
    """The reference's tree: a float32 ``router`` [d, E] (1/√d), and
    ``w_gate``, ``w_in`` [E, d, d_ff] (1/√d) and ``w_out`` [E, d_ff, d]
    (1/√d_ff) in ``dtype``, each drawn in float32 by ``generator``."""
    def normal(shape, scale):
        return normal_init(generator, shape, scale, dtype, device)
    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    return {
        "router": dense_init(generator, d_model, n_experts, torch.float32,
                             device),
        "w_gate": normal((n_experts, d_model, d_ff), s_in),
        "w_in": normal((n_experts, d_model, d_ff), s_in),
        "w_out": normal((n_experts, d_ff, d_model), s_out),
    }


def capacity(t: int, top_k: int, n_experts: int,
             capacity_factor: float = 1.25) -> int:
    """Slots an expert for ``t`` tokens (``moe.py:49``): at least 1."""
    return max(int(capacity_factor * top_k * t / n_experts + 0.5), 1)


def moe_route(router: torch.Tensor, x: torch.Tensor, *, top_k: int,
              cap: int) -> dict[str, torch.Tensor]:
    """The dispatch of x [T, d] under the float32 ``router`` [d, E]:
    ``probs`` [T, E] (softmax of the float32 logits), the top-k experts a
    token ``top_e`` [T, k] (largest first, the lower expert first on a
    tie, as ``jax.lax.top_k``) and their renormalized weights ``top_p``;
    over the flat token-major pairs [T · k]: ``rank`` in the expert's
    bucket, ``keep`` (rank < cap) and ``slot`` (expert · cap + rank, or
    E · cap where dropped); and ``onehot`` [T · k, E] int32."""
    e = router.shape[1]
    probs = torch.softmax(x.to(torch.float32) @ router, dim=-1)
    # a stable descending sort keeps equal probabilities in expert order
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :top_k], top_e[:, :top_k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    flat_e = top_e.reshape(-1)
    onehot = (flat_e[:, None] == torch.arange(e, device=x.device)[None, :]
              ).to(torch.int32)
    # the exclusive prefix sum down the pairs, taken along the last axis
    # of the transposed one-hot: the same integers, but torch scans a
    # leading axis one column a thread on the card, serially down a
    # prefill's T · k pairs
    within = prefix_sum(onehot.t().contiguous(), axis=1, exclusive=True).t()
    rank = (onehot * within).sum(dim=1)
    keep = rank < cap
    slot = torch.where(keep, flat_e * cap + rank,
                       torch.full_like(flat_e, e * cap))
    return dict(probs=probs, top_p=top_p, top_e=top_e, onehot=onehot,
                rank=rank, keep=keep, slot=slot)


class _SlotRows(torch.autograd.Function):
    """The slots' token rows: x [T, d] → [S, d], slot i reading row
    slot_token[i] (T for an empty slot: a zero row). The gradient of token
    t is the sum of its k pairs' slot rows (``slot`` [T · k], S where
    dropped: a zero), summed over k in token-major order: no scatter-add,
    so the same bits on every run (a float scatter-add is not
    deterministic on the CPU)."""

    @staticmethod
    def forward(ctx, x, slot_token, slot, top_k):
        ctx.save_for_backward(slot)
        ctx.top_k = top_k
        return F.pad(x, (0, 0, 0, 1)).index_select(0, slot_token)

    @staticmethod
    def backward(ctx, g):
        (slot,) = ctx.saved_tensors
        rows = F.pad(g, (0, 0, 0, 1)).index_select(0, slot)
        gx = rows.view(-1, ctx.top_k, g.shape[1]).sum(dim=1)
        return gx, None, None, None


def _moe(p, x: torch.Tensor, top_k: int, capacity_factor: float):
    """(y, f, P): the layer's output and its aux loss's per-expert kept
    share f (× k) and mean probability P over x's tokens."""
    router, w_gate, w_in, w_out = p.router, p.w_gate, p.w_in, p.w_out
    t, d = x.shape
    e = w_in.shape[0]
    cap = capacity(t, top_k, e, capacity_factor)
    r = moe_route(router, x, top_k=top_k, cap=cap)
    flat_t = torch.arange(t * top_k, device=x.device) // top_k

    # scatter the token ids into the slots (dropped pairs into the spare
    # row e · cap), then gather the rows: slots left empty read zeros
    slot_token = torch.full((e * cap + 1,), t, dtype=torch.int64,
                            device=x.device)
    slot_token.scatter_(0, r["slot"].to(torch.int64), flat_t)
    xe = _SlotRows.apply(x, slot_token[:e * cap], r["slot"].to(torch.int64),
                         top_k).reshape(e, cap, d)

    h = F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_in)
    ye = torch.bmm(h, w_out).reshape(e * cap, d)

    rows = ye[torch.clamp(r["slot"], max=e * cap - 1).to(torch.int64)]
    rows = torch.where(r["keep"][:, None], rows,
                       torch.zeros((), dtype=ye.dtype, device=x.device))
    weighted = rows * r["top_p"].reshape(-1, 1).to(rows.dtype)
    y = weighted.reshape(t, top_k, d).to(torch.float32).sum(dim=1)

    f = (r["onehot"] * r["keep"][:, None]).to(torch.float32).mean(dim=0) * (
        t * top_k / max(t, 1))
    return y.to(x.dtype), f, r["probs"].mean(dim=0)


def moe_apply(p, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [T, d] → (y [T, d] in x's dtype, the Switch aux loss, a float32
    0-d tensor). ``p`` has the attributes ``router``, ``w_gate``, ``w_in``
    and ``w_out`` (a block's ``MoE``). The model runs the reference's
    default ``capacity_factor``; the argument lets the tests hold the
    dropping and the non-dropping capacities against the reference's.

    The combine rounds each weighted row to the model's dtype (the
    reference's product), then sums a token's k rows in float32 and
    rounds once: in float32 that is the reference's sum up to the order of
    k additions; in bf16 it may differ from the reference's bf16
    segment sum by a bf16 ulp of the sum a token."""
    y, f, pe = _moe(p, x, top_k, capacity_factor)
    e = f.shape[0]
    return y, e * torch.sum(f * pe) / top_k


def _moe_groups(p, groups: list, reduce: Reduce, n: int, top_k: int,
                capacity_factor: float):
    """The capacity groups this process holds (``groups``, token blocks)
    each dispatched alone: (their y in order, the aux loss of f and P
    averaged over all ``n`` groups by ``reduce``, differentiable in P)."""
    outs = [_moe(p, x, top_k, capacity_factor) for x in groups]
    f = reduce.sum([o[1].detach() for o in outs])
    pe = reduce.sum([o[2] for o in outs], grad=True)
    e = f.shape[0]
    return [o[0] for o in outs], e * torch.sum((f / n) * (pe / n)) / top_k


def moe_apply_local(p, x: torch.Tensor, *, top_k: int,
                    capacity_factor: float = 1.25
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Shard-local dispatch: x [T_l, d] is this data-parallel rank's
    tokens, one capacity group of ``max(int(cf · k · T_l / E + 0.5), 1)``
    slots an expert, ranked within the group; y is ``moe_apply``'s on the
    group. The aux loss takes f and P averaged over the dp group's ranks
    (the reference's means over every group's tokens, all groups of one
    size): an all-reduce of each. With no mesh in ``dist.hints.layout``,
    or a dp extent of 1, ``moe_apply``."""
    mesh = _current_mesh()
    dp = mesh_info()[0]
    n = 1 if mesh is None else _axes_size(mesh, dp)
    if n <= 1:
        return moe_apply(p, x, top_k=top_k, capacity_factor=capacity_factor)
    (y,), aux = _moe_groups(p, [x], Reduce(dp_group(mesh, dp)), n, top_k,
                            capacity_factor)
    return y, aux


def moe_apply_groups(p, x: torch.Tensor, n_groups: int, *, top_k: int,
                     capacity_factor: float = 1.25
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``moe_apply_local`` at a dp extent of ``n_groups`` run in this
    process: x [T, d] cut into ``n_groups`` contiguous groups of tokens,
    each dispatched alone, f and P folded over the groups in order (the
    same body, ``Reduce`` with no group)."""
    ys, aux = _moe_groups(p, list(x.chunk(n_groups)), Reduce(), n_groups,
                          top_k, capacity_factor)
    return torch.cat(ys), aux
