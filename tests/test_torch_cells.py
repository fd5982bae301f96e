"""``launch/steps.py`` ``build_cell`` and the dry run against the
reference's ``build_cell``: all 40 (arch, shape) cells build on meta with
no tensor off meta; the skips and their reasons are the reference's; each
cell's argument shapes and dtypes equal the reference's at a (1, 1) mesh
(an LM parameter through ``models.transformer.reference_leaf``, the
stacked layer axes taken apart; a GNN's or DLRM's parameters and moments
by their totals a dtype, their trees being laid out differently); and on
a described (2, 4) mesh the placements of one cell a family, read back by
``placement_spec``, equal the reference's ``PartitionSpec``s (a layer
parameter against the reference's rule on that one leaf, as
``tests/test_torch_dist_rules.py`` holds them)."""
import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import all_cells as j_all_cells  # noqa: E402
from repro.dist import sharding as js  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro_torch.configs import all_cells, get_arch, get_config  # noqa: E402
from repro_torch.dist.sharding import placement_spec  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import DescribedMesh  # noqa: E402
from repro_torch.launch.steps import batch_fields, build_cell  # noqa: E402
from repro_torch.models.transformer import reference_leaf  # noqa: E402

CELLS = all_cells()
MESH11 = jax.make_mesh((1, 1), ("data", "model"))


def _dt(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _tensors(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, torch.Tensor):
        yield x
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))


def _sds(x):
    return [leaf for leaf in jax.tree.leaves(x)
            if isinstance(leaf, jax.ShapeDtypeStruct)]


def _totals(leaves):
    out = collections.Counter()
    for t in leaves:
        out[_dt(t.dtype)] += int(np.prod(t.shape))
    return out


def test_cell_registry_is_the_reference_s():
    assert CELLS == list(j_all_cells()) and len(CELLS) == 40


@pytest.fixture(scope="module")
def meta_cells():
    return {c: build_cell(*c, device="meta") for c in CELLS}


@pytest.fixture(scope="module")
def ref_cells():
    return {c: jsteps.build_cell(*c, MESH11) for c in CELLS}


def test_every_cell_builds_on_meta(meta_cells):
    for key, cell in meta_cells.items():
        if cell.skipped:
            continue
        leaves = list(_tensors(cell.args))
        assert leaves, key
        off = {t.device for t in leaves if t.device.type != "meta"}
        assert not off, (key, off)
        assert len(cell.roles) == len(cell.args), key


def test_skips_and_reasons_equal_the_reference(meta_cells, ref_cells):
    for (arch, shape), cell in meta_cells.items():
        ref = ref_cells[arch, shape]
        assert cell.skipped == ref.skipped, (arch, shape)
        assert cell.skipped == get_arch(arch).skips.get(shape, "")


def _same(t, ref, what):
    assert tuple(t.shape) == tuple(ref.shape), what
    assert _dt(t.dtype) == str(ref.dtype), what


def _zero_stride(tree):
    """SDS leaves as zero-stride numpy arrays (``reference_leaf`` reads
    numpy arrays): the shapes and dtypes, nothing allocated."""
    return jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), tree)


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "-".join(c))
def test_argument_shapes_and_dtypes_equal_the_reference(cell, meta_cells,
                                                        ref_cells):
    arch, shape = cell
    ours, ref = meta_cells[cell], ref_cells[cell]
    if ours.skipped:
        return
    assert len(ours.args) == len(ref.args)
    family = get_arch(arch).family
    params, ref_params = ours.args[0], ref.args[0]
    if family == "lm":
        model = ours.fn.__closure__ and next(
            c.cell_contents for c in ours.fn.__closure__
            if hasattr(c.cell_contents, "layers"))
        tree = _zero_stride(ref_params)
        for name, p in params.items():
            _same(p, reference_leaf(model, tree, name), name)
    assert _totals(params.values()) == _totals(_sds(ref_params))
    for i, role in enumerate(ours.roles[1:], start=1):
        mine, theirs = ours.args[i], ref.args[i]
        if role == "optimizer":
            assert _totals(_tensors(mine)) == _totals(_sds(theirs))
        elif role == "cache":
            for stack, c in mine.items():
                for name, t in c.items():
                    _same(t, theirs[stack][name], (stack, name))
        elif dataclasses.is_dataclass(mine):
            fields = batch_fields(mine)
            want = {f.name: getattr(theirs, f.name)
                    for f in dataclasses.fields(theirs)
                    if getattr(theirs, f.name) is not None
                    and not isinstance(getattr(theirs, f.name), int)}
            assert set(fields) == set(want)
            for k, t in fields.items():
                _same(t, want[k], k)
        else:
            _same(mine, theirs, (role, i))


def _norm(spec, ndim):
    out = [None if e is None else (e,) if isinstance(e, str) else tuple(e)
           for e in spec]
    return tuple(out + [None] * (ndim - len(out)))


def _spec_eq(mesh, pl, sharding, ndim, what):
    assert _norm(placement_spec(mesh, pl, ndim), ndim) == _norm(
        sharding.spec, ndim), what


@pytest.mark.parametrize("cell", [("gemma2-9b", "decode_32k"),
                                  ("gemma2-9b", "long_500k"),
                                  ("granite-moe-1b-a400m", "train_4k"),
                                  ("graphsage-reddit", "minibatch_lg"),
                                  ("dlrm-rm2", "train_batch"),
                                  ("dlrm-rm2", "retrieval_cand")],
                         ids=lambda c: "-".join(c))
def test_placements_equal_the_reference_on_a_described_mesh(cell):
    arch, shape = cell
    pm = DescribedMesh((2, 4), ("data", "model"))
    am = AbstractMesh((2, 4), ("data", "model"))
    ours, ref = build_cell(arch, shape, pm, device="meta"), \
        jsteps.build_cell(arch, shape, am)
    family = get_arch(arch).family
    params, p_pl = ours.args[0], ours.placements[0]
    for name, p in params.items():
        if family == "lm":
            cfg = get_config(arch)
            leaf = {name.rsplit(".", 1)[-1]: jax.ShapeDtypeStruct(
                tuple(p.shape), jnp.float32)}
            dp_only = (ours.note == "train_step"
                       and cfg.train_layout == "dp_only")
            want = (js.replicated(am, leaf) if dp_only else
                    js.lm_param_shardings(am, leaf, fsdp=True,
                                          n_experts=cfg.moe_experts))
            _spec_eq(pm, p_pl[name], next(iter(want.values())), p.ndim,
                     name)
            if not name.startswith("layers."):  # unstacked: the cell's own
                _spec_eq(pm, p_pl[name], ref.in_shardings[0][name], p.ndim,
                         name)
        else:
            want = {s.spec for s in jax.tree.leaves(
                ref.in_shardings[0], is_leaf=lambda x: hasattr(x, "spec"))}
            # GNN weights whole; DLRM tables row-cut, the MLPs whole
            spec = _norm(placement_spec(pm, p_pl[name], p.ndim), p.ndim)
            assert any(_norm(w, p.ndim) == spec for w in want), name
    for i in range(1, len(ours.args)):
        role, mine, pl = ours.roles[i], ours.args[i], ours.placements[i]
        theirs = ref.in_shardings[i]
        if role == "optimizer":
            continue  # the moments follow the parameters (checked above)
        if role == "cache":
            for stack, c in mine.items():
                for name, t in c.items():
                    _spec_eq(pm, pl[stack][name], theirs[stack][name],
                             t.ndim, (stack, name))
        elif dataclasses.is_dataclass(mine):
            for k, t in batch_fields(mine).items():
                _spec_eq(pm, pl[k], getattr(theirs, k), t.ndim, k)
        else:
            _spec_eq(pm, pl, theirs, mine.ndim, (role, i))


def test_dry_run_reports_every_cell_on_meta():
    """The dry run over all 40 cells and the engine's three on the
    production mesh (16 × 16, described): the reference's 4 skips, every
    other cell ok, a rank's bytes within the whole; gemma2-9b's bf16
    parameters at least its 9,241,705,984 (the mesh pads heads and
    vocabulary)."""
    records = dryrun.run(CELLS, True, ["single"], out=lambda s: None)
    status = collections.Counter(r["status"] for r in records)
    assert status == {"ok": 36 + 3, "skipped": 4}, status
    for r in records:
        if r["status"] == "ok" and "rank_bytes" in r:
            assert 0 < r["rank_bytes"] <= r["argument_bytes"], r["cell"]
    gemma = next(r for r in records if r["cell"] == "gemma2-9b__train_4k")
    assert gemma["bytes"]["params"] >= 2 * 9_241_705_984
    assert gemma["rank_bytes"] < gemma["argument_bytes"] / 100


# ------------------------------------------- the step functions, on the CPU
SMALL_LM = {
    "train_4k": dict(kind="train", seq_len=16, global_batch=2),
    "prefill_32k": dict(kind="prefill", seq_len=16, global_batch=2),
    "decode_32k": dict(kind="decode", seq_len=32, global_batch=2),
    "long_500k": dict(kind="decode", seq_len=32, global_batch=1)}
SMALL_GNN = {
    "minibatch_lg": dict(kind="minibatch", n_nodes=64, n_edges=0,
                         batch_nodes=4, fanout=(2, 2), d_feat=8,
                         n_classes=3),
    "molecule": dict(kind="batched_graphs", n_nodes=6, n_edges=8, batch=4,
                     d_feat=8, n_classes=2)}
SMALL_RECSYS = {
    "train_batch": dict(kind="train", batch=64),
    "serve_p99": dict(kind="serve", batch=16),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=128)}


@pytest.fixture
def small(monkeypatch):
    """``launch.steps`` at the smoke configs and cut shapes: its config
    lookup and shape tables patched for the test (the cells' code runs
    unchanged)."""
    from repro_torch.launch import steps
    monkeypatch.setattr(steps, "get_config",
                        lambda arch, smoke=False: get_config(arch, True))
    monkeypatch.setattr(steps, "LM_SHAPES", SMALL_LM)
    monkeypatch.setattr(steps, "GNN_SHAPES", SMALL_GNN)
    monkeypatch.setattr(steps, "RECSYS_SHAPES", SMALL_RECSYS)
    return steps


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_equal, a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def _ported_step(steps, arch, shape):
    """The same step through the port's existing cells (seed 0): its
    result and the model it stepped."""
    family = get_arch(arch).family
    if family == "gnn":
        cell = steps._gnn_cell(arch, shape, device="cpu")
        return cell.step(), cell.model
    if family == "recsys":
        cell = steps._recsys_cell(arch, shape, device="cpu")
        return cell.step(), cell.model
    kind = SMALL_LM[shape]["kind"]
    if kind == "train":
        cell = steps.lm_train_cell(arch, device="cpu")
        return cell.step(), cell.model
    if kind == "prefill":
        cell = steps.lm_prefill_cell(arch, device="cpu")
        return cell.step(), cell.model
    from repro_torch.models.transformer import LM
    d = SMALL_LM[shape]
    cfg = get_config(arch, True)
    model = LM(cfg, seed=0, device="cpu")
    cache = steps.make_cache(cfg, d["global_batch"], d["seq_len"],
                             device="cpu")
    tokens = torch.zeros((d["global_batch"], 1), dtype=torch.int32)
    out = steps.lm_decode_step(model, cache, tokens,
                               torch.zeros((), dtype=torch.int32))
    return (out, cache), model


STEP_CELLS = [("gemma2-9b", "train_4k"), ("gemma2-9b", "prefill_32k"),
              ("gemma2-9b", "decode_32k"), ("gemma2-9b", "long_500k"),
              ("graphsage-reddit", "minibatch_lg"), ("gatedgcn", "molecule"),
              ("dlrm-rm2", "train_batch"), ("dlrm-rm2", "serve_p99"),
              ("dlrm-rm2", "retrieval_cand")]


@pytest.mark.parametrize("cell", STEP_CELLS, ids=lambda c: "-".join(c))
def test_cell_step_equals_the_port_s_cell_step(cell, small):
    """``fn(*args)`` of a smoke cell, built on the CPU with no mesh, runs
    one step and gives the bits of the port's existing cell (or, for
    decode, ``lm_decode_step``) on the same seed; a step that trains
    leaves the same parameters."""
    arch, shape = cell
    c = small.build_cell(arch, shape, device="cpu")
    got = c.fn(*c.args)
    if c.roles[1:2] == ("cache",):
        got = (got, c.args[1])
    want, model = _ported_step(small, arch, shape)
    assert _equal(got, want), cell
    assert _equal(c.args[0], dict(model.named_parameters())), cell


@pytest.mark.parametrize("cell", [("gemma2-9b", "prefill_32k"),
                                  ("gemma2-9b", "train_4k"),
                                  ("dlrm-rm2", "serve_p99")],
                         ids=lambda c: "-".join(c))
def test_cell_step_takes_its_params_argument(cell, small):
    """``fn`` runs on the parameters it is given: seed 0's cell stepped
    with seed 1's parameters equals seed 1's cell on the same other
    arguments; a dict not named as the model's parameters is refused."""
    arch, shape = cell
    c0 = small.build_cell(arch, shape, device="cpu", seed=0)
    c1 = small.build_cell(arch, shape, device="cpu", seed=1)
    # each its own zero AdamW state; the inputs seed 0's
    opt = 2 if "optimizer" in c0.roles else 1
    got = c0.fn(c1.args[0], *c0.args[1:])
    want = c1.fn(*c1.args[:opt], *c0.args[opt:])
    assert _equal(got, want), cell
    assert _equal(c0.args[0], c1.args[0]), cell
    with pytest.raises(ValueError, match="named"):
        c0.fn({}, *c0.args[1:])


def test_sequence_placed_decode_steps_on_a_described_mesh(small):
    """long_500k on a described (2, 4) mesh: the cache's sequence placed
    over dp, and ``fn`` runs the whole-cache step of the padded config
    with no process group."""
    from repro_torch.models.transformer import LM
    pm = DescribedMesh((2, 4), ("data", "model"))
    c = small.build_cell("gemma2-9b", "long_500k", pm, device="cpu")
    assert "sequence-sharded" in c.note
    got = c.fn(*c.args)
    cfg = small._lm_config("gemma2-9b", False, 4)
    model = LM(cfg, seed=0, device="cpu")
    cache = small.make_cache(cfg, 1, SMALL_LM["long_500k"]["seq_len"],
                             device="cpu")
    want = small.lm_decode_step(model, cache, torch.zeros(
        (1, 1), dtype=torch.int32), torch.zeros((), dtype=torch.int32))
    assert torch.equal(got, want) and _equal(c.args[1], cache)
