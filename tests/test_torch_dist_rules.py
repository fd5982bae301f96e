"""repro_torch ``dist.sharding`` and ``dist.hints`` against the reference's
``repro/dist``.

Placement rules read only a leaf's name and shape, so they are held
in-process: the reference's side on a ``jax.sharding.AbstractMesh`` (no
virtual devices), the port's on the ``SimpleNamespace`` stand-in of a
``DeviceMesh`` (names and sizes), on meshes (1, 1), (2, 4), (4, 2) and
(16, 16) ``data`` × ``model`` and (2, 2, 2) ``pod`` × ``data`` ×
``model``. The port's placements, read back as ``PartitionSpec`` entries
(``placement_spec``), must equal the reference's on every leaf:

* LM parameters of every LM config's smoke tree, with and without FSDP,
  the experts named for MoE: the port's rule on the reference's own
  ``lm_init`` tree (its stacked layer axes and names), and on the port's
  module (``named_parameters``, one leaf a layer) against the reference's
  rule on leaves of the same names and shapes;
* the KV cache of each LM config, with and without ``seq_sharded``;
* dlrm-rm2's parameters and a GNN batch.

``local_shard`` cuts a whole tensor to the pieces whose concatenation is
the tensor, in the placements' order. The hints mirror the reference's
``tests/test_dist_hints.py``; a spawned gloo mesh of 2 checks that
``shard_hint`` redistributes a ``DTensor`` and leaves a plain tensor as
it is.
"""
import itertools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.dist import sharding as js  # noqa: E402
from repro.models.dlrm import dlrm_init  # noqa: E402
from repro.models.transformer import lm_init  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.dist import hints as th  # noqa: E402
from repro_torch.dist import sharding as ts  # noqa: E402
from repro_torch.models.transformer import LM, make_cache  # noqa: E402

from torch_dist_worker import run_ranks  # noqa: E402

MESHES = [((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((4, 2), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]
LM_ARCHS = [a for a, s in tconfigs.ARCHS.items() if s.family == "lm"]


def _meshes(sizes, names):
    port = SimpleNamespace(mesh_dim_names=names, ndim=len(sizes),
                           size=lambda i: sizes[i])
    return port, AbstractMesh(sizes, names)


def _norm(spec, ndim):
    out = [None if e is None else (e,) if isinstance(e, str) else tuple(e)
           for e in spec]
    return tuple(out + [None] * (ndim - len(out)))


def _placement(x):
    return isinstance(x, tuple) and all(
        isinstance(p, (ts.Shard, ts.Replicate)) for p in x)


def _leaves(tree, path=()):
    """(path, leaf) of a tree whose leaves are placement tuples."""
    if _placement(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _meta(tree):
    """The reference tree's shapes as meta tensors (the port's leaves)."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_meta(v) for v in tree)
    return torch.empty(tree.shape, device="meta")


def _same_tree(pm, port_tree, jtree, what):
    n = 0
    for path, pl in _leaves(port_tree):
        ns = _get(jtree, path)
        ndim = len(ns.spec)
        got = _norm(ts.placement_spec(pm, pl, ndim), ndim)
        assert got == _norm(ns.spec, ndim), (what, path, got, ns.spec)
        n += 1
    assert n


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str,
                                                                    m[0])))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_param_placements_equal_the_reference(arch, mesh):
    pm, am = _meshes(*mesh)
    jcfg = jconfigs.get_config(arch, smoke=True)
    tree = jax.eval_shape(lambda: lm_init(jcfg, jax.random.PRNGKey(0)))
    e = getattr(jcfg, "moe_experts", 0) or 0
    model = LM(tconfigs.get_config(arch, smoke=True), seed=0, device="cpu")
    named = dict(model.named_parameters())
    for fsdp in (False, True):
        # the reference's own tree, stacked layer axes included
        got = ts.lm_param_shardings(pm, _meta(tree), fsdp=fsdp, n_experts=e)
        want = js.lm_param_shardings(am, tree, fsdp=fsdp, n_experts=e)
        _same_tree(pm, got, want, (arch, fsdp, "stacked"))
        # the port's module: a leaf a layer, its dotted names
        got = ts.lm_param_shardings(pm, named, fsdp=fsdp, n_experts=e)
        for name, p in named.items():
            leaf = {name.rsplit(".", 1)[-1]: jax.ShapeDtypeStruct(
                tuple(p.shape), jnp.float32)}
            want = js.lm_param_shardings(am, leaf, fsdp=fsdp, n_experts=e)
            _same_tree(pm, {name.rsplit(".", 1)[-1]: got[name]}, want,
                       (arch, fsdp, name))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str,
                                                                    m[0])))
def test_cache_dlrm_and_gnn_placements_equal_the_reference(mesh):
    pm, am = _meshes(*mesh)
    for arch in LM_ARCHS:
        cache = make_cache(tconfigs.get_config(arch, smoke=True), batch=16,
                           max_len=64, device="meta")
        jcache = {s: {k: jax.ShapeDtypeStruct(tuple(t.shape), jnp.float32)
                      for k, t in c.items()} for s, c in cache.items()}
        for seq in (False, True):
            _same_tree(pm, ts.lm_cache_shardings(pm, cache, seq_sharded=seq),
                       js.lm_cache_shardings(am, jcache, seq_sharded=seq),
                       (arch, seq))
    dtree = jax.eval_shape(lambda: dlrm_init(
        jconfigs.get_config("dlrm-rm2", smoke=True), jax.random.PRNGKey(0)))
    _same_tree(pm, ts.dlrm_param_shardings(pm, _meta(dtree)),
               js.dlrm_param_shardings(am, dtree), "dlrm")
    tables = {"tables": jax.ShapeDtypeStruct((4, 64, 8), jnp.float32)}
    _same_tree(pm, ts.dlrm_param_shardings(pm, _meta(tables)),
               js.dlrm_param_shardings(am, tables), "tables")
    batch = {"x": jax.ShapeDtypeStruct((96, 7), jnp.float32),
             "edge_src": jax.ShapeDtypeStruct((256,), jnp.int32),
             "graph_id": jax.ShapeDtypeStruct((30,), jnp.int32),
             "n": jax.ShapeDtypeStruct((), jnp.int32)}
    _same_tree(pm, ts.gnn_batch_shardings(pm, _meta(batch)),
               js.gnn_batch_shardings(am, batch), "gnn")
    _same_tree(pm, {"b": ts.batch_sharding(pm, 3, 1)},
               {"b": js.batch_sharding(am, 3, 1)}, "batch")
    assert ts.dp_axes(pm) == js.dp_axes(am)
    assert ts.model_axis_size(pm) == js.model_axis_size(am)


@pytest.mark.parametrize("mesh", MESHES[1:], ids=lambda m: "x".join(map(
    str, m[0])))
def test_local_shards_tile_the_whole_tensor(mesh):
    sizes, names = mesh
    pm, _ = _meshes(sizes, names)
    x = torch.arange(256 * 16 * 16).reshape(256, 16, 16)
    for spec in ((ts.dp_axes(pm), None, "model"), (None, "model", None),
                 (ts.dp_axes(pm) + ("model",), None, None)):
        pl = ts.placements(pm, spec)
        assert _norm(ts.placement_spec(pm, pl, 3), 3) == _norm(spec, 3)
        seen = torch.zeros_like(x, dtype=torch.bool)
        for coord in itertools.product(*(range(s) for s in sizes)):
            piece = ts.local_shard(x, pm, pl, coord)
            assert tuple(piece.shape) == ts.local_shape(x.shape, pm, pl)
            seen.view(-1)[piece.reshape(-1)] = True
        assert seen.all()
    with pytest.raises(ValueError, match="order"):
        ts.placements(pm, (("model",) + ts.dp_axes(pm),))


# -------------------------------------------------------------------- hints
def test_shard_hint_identity_without_mesh():
    x = torch.arange(12.0).reshape(3, 4)
    assert th.shard_hint(x, "dp", "model") is x
    assert th.shard_hint(x, "dp", None) is x


def test_shard_hint_rank_mismatch_is_identity():
    pm, _ = _meshes((2, 4), ("data", "model"))
    x = torch.ones(2, 3, 4)
    with th.layout(pm):
        assert th.shard_hint(x, "dp", None) is x
        assert th.hint_spec(pm, (2, 3, 4), ("dp", None)) is None


def test_layout_nesting_restores_previous_mesh():
    assert th._current_mesh() is None
    m1, _ = _meshes((1, 1), ("data", "model"))
    m2, _ = _meshes((1,), ("data",))
    with th.layout(m1):
        assert th._current_mesh() is m1 and th.current_layout() == "tp"
        with th.layout(m2, "dp_only"):
            assert th._current_mesh() is m2
            assert th.current_layout() == "dp_only"
        assert th._current_mesh() is m1 and th.current_layout() == "tp"
    assert th._current_mesh() is None and th.current_layout() == "tp"


def test_layout_by_name_inherits_the_enclosing_mesh():
    m, _ = _meshes((1, 1), ("data", "model"))
    with th.layout(m):
        with th.layout("dp_only"):
            assert th.current_layout() == "dp_only"
            assert th._current_mesh() is m
        assert th.current_layout() == "tp"


def test_layout_restores_on_exception():
    m, _ = _meshes((1, 1), ("data", "model"))
    with pytest.raises(RuntimeError):
        with th.layout(m):
            raise RuntimeError("boom")
    assert th._current_mesh() is None


def test_mesh_info_without_mesh_and_per_layout():
    assert th.mesh_info() == (("data",), 1)
    m, _ = _meshes((2, 4), ("data", "model"))
    with th.layout(m):
        assert th.mesh_info() == (("data",), 4)
    with th.layout(m, "dp_only"):
        assert th.mesh_info() == (("data", "model"), 1)
    p, _ = _meshes((2, 2, 2), ("pod", "data", "model"))
    with th.layout(p):
        assert th.mesh_info() == (("pod", "data"), 2)
    with th.layout(p, "dp_only"):
        assert th.mesh_info() == (("data", "model"), 2)


def test_hint_spec_resolves_as_the_reference():
    m, _ = _meshes((2, 4), ("data", "model"))
    with th.layout(m):
        assert th.hint_spec(m, (8, 12), ("dp", "model")) == (("data",),
                                                              "model")
        assert th.hint_spec(m, (3, 12), ("dp", "model")) == (None, "model")
        assert th.hint_spec(m, (8, 6), ("dp", "model")) == (("data",), None)
        assert th.hint_spec(m, (8, 8), ("model", "model")) == ("model",
                                                               None)
    with th.layout(m, "dp_only"):
        assert th.hint_spec(m, (16, 5), ("dp", None)) == (("data", "model"),
                                                          None)
    x = torch.ones(8, 12)
    with th.layout(m), th.suspend_hints():
        assert th.shard_hint(x, "dp", "model") is x


def test_shard_hint_redistributes_a_dtensor_on_a_gloo_mesh():
    out = run_ranks("hints", {}, (2,), ("data",))
    for r, o in enumerate(out):
        assert o["plain_is_same"]
        assert o["placements"] == "(Shard(dim=0),)"
        np.testing.assert_array_equal(o["local"], np.arange(4.0)[2 * r:
                                                                 2 * r + 2])
