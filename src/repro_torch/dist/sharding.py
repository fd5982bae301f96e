"""Placement builders (port of ``repro/dist/sharding.py``).

Every rank runs the same program and holds its own shard of each tensor
as a plain tensor (explicit SPMD); a *placement* says which slice: one
entry a mesh dim, ``Shard(d)`` (tensor dim d is cut over that mesh dim)
or ``Replicate()``. The builders return a tree of such tuples shaped like
their input, by the reference's rules, which read only a leaf's name and
shape: an axis that does not divide its dim is dropped (the dim stays
whole), so the rules hold on the production (16, 16) mesh, the
multi-pod (2, 16, 16) mesh and the smallest test meshes alike.

* ``model`` mesh dim — tensor parallel: column-parallel on ``wq``,
  ``wk``, ``wv`` (and their biases), ``w_gate``, ``w_in`` and
  ``lm_head`` (last dim), row-parallel on ``wo`` and ``w_out`` (the
  contraction dim), vocab-parallel on ``embed``; MoE expert tensors are
  cut by expert when the experts cover the axis.
* the data-parallel dims (every mesh dim but ``model``) — FSDP: the
  largest remaining dim of a leaf, when asked for.

A mesh is a ``torch.distributed`` ``DeviceMesh`` or anything with its
``mesh_dim_names``, ``ndim`` and ``size(i)`` (the rules never touch a
process group). ``placement_spec`` reads a placement tuple back as the
reference's ``PartitionSpec`` entries; ``local_shard`` cuts a whole
tensor to a rank's shard.
"""
from __future__ import annotations

import torch

try:  # torch >= 2.4
    from torch.distributed.tensor import Replicate, Shard
except ImportError:  # pragma: no cover - older torch
    from torch.distributed._tensor import Replicate, Shard

__all__ = ["Replicate", "Shard", "axis_names", "batch_sharding",
           "dlrm_param_shardings", "dp_axes", "gnn_batch_shardings",
           "lm_cache_shardings", "lm_param_shardings", "local_shape",
           "local_shard", "model_axis_size", "placement_spec",
           "placements", "replicated"]


def axis_names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or
                 (f"dim{i}" for i in range(mesh.ndim)))


def _shape(mesh) -> dict[str, int]:
    return {a: mesh.size(i) for i, a in enumerate(axis_names(mesh))}


def dp_axes(mesh) -> tuple[str, ...]:
    """Data-parallel axes: every mesh axis except ``model``."""
    return tuple(a for a in axis_names(mesh) if a != "model")


def model_axis_size(mesh) -> int:
    return _shape(mesh).get("model", 1)


def _axes_size(mesh, axes) -> int:
    shape = _shape(mesh)
    n = 1
    for a in axes:
        n *= shape.get(a, 1)
    return n


def placements(mesh, spec) -> tuple:
    """The placement tuple of a reference ``PartitionSpec``'s entries
    ``spec`` (one a tensor dim: None, an axis name or a tuple of them, in
    mesh order: a dim is cut row-major over its axes)."""
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"axes {axes} are not in the mesh's order")
        for a in axes:
            i = names.index(a)
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {a!r} shards two dims")
            out[i] = Shard(d)
    return tuple(out)


def placement_spec(mesh, pl: tuple, ndim: int) -> tuple:
    """The reference's ``PartitionSpec`` entries of a placement tuple: a
    tensor dim cut over one axis names it, over several the tuple of
    them in mesh order; a whole dim is None."""
    names = axis_names(mesh)
    spec = []
    for d in range(ndim):
        axes = tuple(names[i] for i, p in enumerate(pl) if p == Shard(d))
        spec.append(None if not axes else axes[0] if len(axes) == 1
                    else axes)
    return tuple(spec)


def _tree_map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _leaf_name(path) -> str:
    """The last string key of a leaf's path; a dotted key (a module's
    parameter name) gives its last part."""
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry.rsplit(".", 1)[-1]
    return ""


def replicated(mesh, tree):
    """Every leaf whole on every rank."""
    rep = placements(mesh, ())
    return _tree_map(lambda _, __: rep, tree)


def batch_sharding(mesh, ndim: int = 2, batch_dim: int = 0) -> tuple:
    """The batch dim of a rank-``ndim`` tensor over the dp axes."""
    spec = [None] * ndim
    spec[batch_dim] = dp_axes(mesh)
    return placements(mesh, spec)


# ------------------------------------------------------------------- LM ----
_COL_PARALLEL = ("wq", "wk", "wv", "bq", "bk", "bv", "w_gate", "w_in",
                 "lm_head")
_ROW_PARALLEL = ("wo", "w_out")
_MOE_EXPERT = ("w_gate", "w_in", "w_out")


def lm_param_shardings(mesh, params, *, fsdp: bool = False,
                       n_experts: int = 0):
    """Placements of an LM's parameters: any tree of tensors (or of
    anything with a ``.shape``) whose leaf names are the reference's —
    ``dict(model.named_parameters())``, or the reference's stacked
    ``lm_init`` tree, where the leading layer axis is one more candidate
    dim."""
    msz = model_axis_size(mesh)
    dp = dp_axes(mesh)
    dsz = _axes_size(mesh, dp)
    expert_parallel = (n_experts and msz > 1 and n_experts % msz == 0
                       and n_experts >= msz)

    def one(path, leaf):
        name = _leaf_name(path)
        shape = tuple(leaf.shape)
        nd = len(shape)
        spec = [None] * nd
        model_dim = None
        if msz > 1:
            if expert_parallel and name in _MOE_EXPERT and nd >= 3:
                model_dim = nd - 3  # expert axis [..., E, a, b]
            elif name in _COL_PARALLEL:
                model_dim = nd - 1
            elif name in _ROW_PARALLEL:
                model_dim = nd - 2
            elif name == "embed":
                model_dim = nd - 2  # vocab rows
            if model_dim is not None and shape[model_dim] % msz == 0 \
                    and shape[model_dim] >= msz:
                spec[model_dim] = "model"
            else:
                model_dim = None
        if fsdp and dsz > 1:
            for i in sorted((i for i in range(nd) if i != model_dim),
                            key=lambda i: -shape[i]):
                if shape[i] % dsz == 0 and shape[i] >= dsz:
                    spec[i] = dp
                    break
        return placements(mesh, spec)

    return _tree_map(one, params)


def lm_cache_shardings(mesh, cache, *, seq_sharded: bool = False):
    """Placements of a KV cache tree of [L, B, Hkv, S, dh | 1] leaves:
    heads over ``model``; the batch over the dp axes, or with
    ``seq_sharded`` the sequence (``dist.collectives
    .sharded_decode_attention_seq`` combines the slices)."""
    msz = model_axis_size(mesh)
    dp = dp_axes(mesh)
    dsz = _axes_size(mesh, dp)

    def one(_, leaf):
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        if len(shape) == 5:
            if msz > 1 and shape[2] % msz == 0:
                spec[2] = "model"
            if seq_sharded:
                if dsz > 1 and shape[3] % dsz == 0:
                    spec[3] = dp
            elif dsz > 1 and shape[1] % dsz == 0:
                spec[1] = dp
        return placements(mesh, spec)

    return _tree_map(one, cache)


# ----------------------------------------------------------------- DLRM ----
def dlrm_param_shardings(mesh, params):
    """The stacked embedding tables [F, V, D] row-cut over ``model``; the
    MLPs stay whole."""
    msz = model_axis_size(mesh)

    def one(path, leaf):
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        if _leaf_name(path) == "tables" and len(shape) == 3 \
                and msz > 1 and shape[1] % msz == 0:
            spec[1] = "model"
        return placements(mesh, spec)

    return _tree_map(one, params)


# ------------------------------------------------------------------ GNN ----
def gnn_batch_shardings(mesh, batch):
    """A graph batch: every leaf's leading dim over the dp axes where it
    divides."""
    dp = dp_axes(mesh)
    dsz = _axes_size(mesh, dp)

    def one(_, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        spec = [None] * len(shape)
        if shape and dsz > 1 and shape[0] % dsz == 0:
            spec[0] = dp
        return placements(mesh, spec)

    return _tree_map(one, batch)


# ------------------------------------------------------------ local shards --
def _cuts(mesh, pl: tuple, ndim: int, coord) -> list:
    """(index, count) of each tensor dim's piece at mesh coordinate
    ``coord``: row-major over the mesh dims that cut it."""
    cuts = [(0, 1)] * ndim
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            idx, cnt = cuts[p.dim]
            cuts[p.dim] = (idx * mesh.size(i) + coord[i], cnt * mesh.size(i))
    return cuts


def local_shape(shape, mesh, pl: tuple) -> tuple[int, ...]:
    """The shape of one rank's shard (every dim divides)."""
    coord = [0] * len(pl)
    out = []
    for n, (_, cnt) in zip(shape, _cuts(mesh, pl, len(shape), coord)):
        if n % cnt:
            raise ValueError(f"dim {n} does not divide over {cnt} ranks")
        out.append(n // cnt)
    return tuple(out)


def local_shard(t: torch.Tensor, mesh, pl: tuple,
                coord=None) -> torch.Tensor:
    """The slice of the whole tensor ``t`` that the rank at mesh
    coordinate ``coord`` (default: this rank's) holds under ``pl``; a
    view."""
    coord = mesh.get_coordinate() if coord is None else coord
    for d, (idx, cnt) in enumerate(_cuts(mesh, pl, t.ndim, coord)):
        if cnt > 1:
            if t.shape[d] % cnt:
                raise ValueError(f"dim {t.shape[d]} does not divide over "
                                 f"{cnt} ranks")
            n = t.shape[d] // cnt
            t = t.narrow(d, idx * n, n)
    return t
