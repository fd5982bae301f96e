"""repro_torch's collectives on gloo process groups of CPU processes
(``tests/torch_dist_worker.py``), against the reference; and the sliced
AdamW.

* **Decode attention** (``dist/collectives.py``) in groups of 2 and 4
  over ``data`` and of (2, 2) ``data`` × ``model``: the sequence-sharded
  decode (every rank its slice of the cache, the slices combined by an
  all-reduce MAX and two SUMs) and the head-sharded decode, bf16 and int8
  caches, a logit cap on and off, lengths that leave whole slices dead,
  each rank's output within ``kernels.decode_attention.twin_tolerance``
  of the reference's dense jnp ``decode_attention`` (the decode tests'
  tolerance: float32 rounding of the sums and of the combine).
* **The int8 all-reduce** (``train/compress.py``) in groups of 2 and 4:
  ``compressed_psum_tree`` over two steps (the error buffers carried) is
  bit-equal to the reference's under ``jax.vmap(axis_name="pod")``,
  values and error buffers, float32 and bf16 leaves;
  ``make_compressed_allreduce`` gives the same values.
* **MoE** (``models/moe.py`` ``moe_apply_local``) in a group of 2: each
  rank's y equals the reference's ``moe_apply`` on its tokens (1e-5, the
  MoE tests' float32 tolerance), the aux loss the reference's formula of
  ``moe_apply_local`` (f and P averaged over the groups; 1e-6 relative);
  with no mesh it is ``moe_apply``.
* **Mesh serving** (``serve/engine.py``) on a gloo mesh of 2: gemma2's
  and granite-moe's smoke configs, the cache sequence-sharded over the
  ranks, serve the tokens of the port's single-device engine on the same
  stream (granite-moe's capacity couples a step's slots: both engines
  admit synchronously, one schedule).
* **Sliced AdamW** (``train/optim.py``): a leaf updated in slices of its
  first axis is bit-equal to the whole-leaf update.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as ja  # noqa: E402
from repro.models import moe as jm  # noqa: E402
from repro.train import compress as jcomp  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.decode_attention import twin_tolerance  # noqa: E402
from repro_torch.models.attention import quantize_kv  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.serve import feeder as t_feeder  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.train import optim  # noqa: E402

from torch_dist_worker import run_ranks, synchronous_polls  # noqa: E402

MESHES = {"2": ((2,), ("data",)), "4": ((4,), ("data",)),
          "2x2": ((2, 2), ("data", "model"))}
# (B, H, Hkv, S, dh, lengths, cap, int8)
DECODE = [(3, 8, 4, 64, 32, (64, 20, 5), 50.0, False),
          (3, 8, 4, 64, 32, (33, 1, 48), None, True),
          (2, 4, 2, 32, 16, (32, 9), 50.0, True)]


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@functools.lru_cache(maxsize=None)
def _decode_cases():
    out = []
    for i, (b, h, hkv, s, dh, lens, cap, int8) in enumerate(DECODE):
        rng = np.random.default_rng(40 + i)
        c = dict(q=_bf16(rng.normal(size=(b, h, 1, dh)).astype(np.float32)),
                 lens=np.array(lens, np.int32), cap=cap, int8=int8)
        k, v = (_bf16(rng.normal(size=(b, hkv, s, dh)).astype(np.float32))
                for _ in range(2))
        if int8:
            (kq, ks), (vq, vs) = (quantize_kv(torch.from_numpy(x))
                                  for x in (k, v))
            c.update(k=kq.numpy(), v=vq.numpy(), k_scale=ks.numpy(),
                     v_scale=vs.numpy())
        else:
            c.update(k=k, v=v)
        out.append(c)
    return out


def _grads(n):
    rng = np.random.default_rng(n)
    return {"f32_a": rng.normal(size=(n, 5, 7)).astype(np.float32) * 3,
            "bf16_b": _bf16(rng.normal(size=(n, 13)).astype(np.float32)),
            "f32_c": rng.normal(size=(n, 1)).astype(np.float32) * 1e-3}


MOE = dict(d=16, f=24, e=8, top_k=2, tokens=12, cf=1.25)


def _moe_inputs(n):
    rng = np.random.default_rng(7)
    d, f, e = MOE["d"], MOE["f"], MOE["e"]
    w = {name: (rng.normal(size=shape) / np.sqrt(fan)).astype(np.float32)
         for name, shape, fan in (("router", (d, e), d),
                                  ("w_gate", (e, d, f), d),
                                  ("w_in", (e, d, f), d),
                                  ("w_out", (e, f, d), f))}
    x = rng.normal(size=(n, MOE["tokens"], d)).astype(np.float32)
    return dict(w=w, x=x, top_k=MOE["top_k"], cf=MOE["cf"])


def _serve_reqs(vocab, seed=0, n=5):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(rng.integers(1, 9))).tolist(),
             int(rng.integers(1, 6))) for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _world(mesh):
    """Every case of one mesh in one spawn a case kind."""
    shape, names = MESHES[mesh]
    n = int(np.prod(shape))
    out = {"decode": run_ranks("decode", {"cases": _decode_cases()},
                               shape, names)}
    if names == ("data",):
        out["compress"] = run_ranks("compress", {"grads": _grads(n)}, shape,
                                    names)
    if mesh == "2":
        out["moe"] = run_ranks("moe", _moe_inputs(n), shape, names)
        out["serve"] = {arch: run_ranks("serve", dict(
            arch=arch, reqs=_serve_reqs(256, seed=i),
            synchronous_polls=arch.startswith("granite")), shape, names)
            for i, arch in enumerate(("gemma2-9b", "granite-moe-1b-a400m"))}
    return out


# ------------------------------------------------------------------ decode
def _reference_decode(c):
    kw = {}
    if c["int8"]:
        kw = dict(k_scale=jnp.asarray(c["k_scale"]),
                  v_scale=jnp.asarray(c["v_scale"]))
    out = ja.decode_attention(jnp.asarray(c["q"], jnp.bfloat16),
                              jnp.asarray(c["k"]), jnp.asarray(c["v"]),
                              jnp.asarray(c["lens"]), logit_cap=c["cap"],
                              **kw)
    return np.asarray(out.astype(jnp.float32))


def _tolerance(c):
    kw = {}
    if c["int8"]:
        kw = dict(k_scale=torch.from_numpy(c["k_scale"]),
                  v_scale=torch.from_numpy(c["v_scale"]))
        k, v = torch.from_numpy(c["k"]), torch.from_numpy(c["v"])
    else:
        k, v = (torch.from_numpy(c[x]).to(torch.bfloat16) for x in "kv")
    return twin_tolerance(torch.from_numpy(c["q"]).to(torch.bfloat16), k, v,
                          torch.from_numpy(c["lens"]), logit_cap=c["cap"],
                          **kw).numpy()


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("which", ["seq", "head"])
def test_sharded_decode_within_tolerance_of_the_reference(mesh, which):
    for rank, outs in enumerate(_world(mesh)["decode"]):
        for c, (seq, head) in zip(_decode_cases(), outs):
            got = seq if which == "seq" else head
            err = np.abs(got - _reference_decode(c))
            assert np.all(np.isfinite(got))
            assert np.all(err <= _tolerance(c)), (mesh, which, rank,
                                                  err.max())


@pytest.mark.parametrize("world", [1, 2, 4])
def test_rank_by_rank_seq_decode_within_tolerance(world):
    """``sharded_decode_attention_seq_ranks``: every rank's slice in turn
    in one process (the card's form), the combine in rank order."""
    from repro_torch.dist.collectives import (
        sharded_decode_attention_seq_ranks)
    for c in _decode_cases():
        kw = {}
        if c["int8"]:
            kw = dict(k_scale=torch.from_numpy(c["k_scale"]),
                      v_scale=torch.from_numpy(c["v_scale"]))
            k, v = torch.from_numpy(c["k"]), torch.from_numpy(c["v"])
        else:
            k, v = (torch.from_numpy(c[x]).to(torch.bfloat16) for x in "kv")
        got = sharded_decode_attention_seq_ranks(
            torch.from_numpy(c["q"]).to(torch.bfloat16), k, v,
            torch.from_numpy(c["lens"]), world, logit_cap=c["cap"], **kw)
        err = np.abs(got.float().numpy() - _reference_decode(c))
        assert np.all(err <= _tolerance(c)), (world, err.max())


def test_a_dead_slice_is_weighed_by_zero():
    """Lengths 5 and 1 leave ranks 1..3 of a 4-way cut with no live
    position: their partials (-inf, 0, 0) add nothing and no NaN."""
    assert min(DECODE[0][5]) < DECODE[0][3] // 4
    assert min(DECODE[1][5]) < DECODE[1][3] // 4
    for outs in _world("4")["decode"]:
        for seq, _ in outs:
            assert not np.isnan(seq).any()


# -------------------------------------------------------------- compression
def _reference_compress(n):
    g = _grads(n)
    jg = {k: jnp.asarray(a, jnp.bfloat16 if k.startswith("bf16")
                         else jnp.float32) for k, a in g.items()}
    errs = jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), jg)
    fn = jax.vmap(lambda gr, er: jcomp.compressed_psum_tree(gr, er, "pod"),
                  axis_name="pod")
    steps = []
    for _ in range(2):
        red, errs = fn(jg, errs)
        steps.append((red, errs))
    return steps


@pytest.mark.parametrize("mesh", ["2", "4"])
def test_compressed_psum_tree_is_bit_equal_to_the_reference(mesh):
    n = int(mesh)
    want = _reference_compress(n)
    for r, outs in enumerate(_world(mesh)["compress"]):
        for (red, errs), (jred, jerrs) in zip(outs[:2], want):
            for k in red:
                np.testing.assert_array_equal(
                    red[k], np.asarray(jred[k][r].astype(jnp.float32)))
                np.testing.assert_array_equal(errs[k], np.asarray(jerrs[k][r]))
        for k, a in outs[2].items():
            np.testing.assert_array_equal(a, outs[0][0][k])


# ---------------------------------------------------------------------- MoE
def _reference_aux(inp, n):
    """The reference moe_apply_local's aux: f and P over every group."""
    e, k = MOE["e"], MOE["top_k"]
    cap = max(int(MOE["cf"] * k * MOE["tokens"] / e + 0.5), 1)
    router = jnp.asarray(inp["w"]["router"])
    fs, ps = [], []
    for r in range(n):
        probs = jax.nn.softmax(jnp.asarray(inp["x"][r]) @ router, axis=-1)
        _, top_e = jax.lax.top_k(probs, k)
        onehot = (top_e.reshape(-1)[:, None] == jnp.arange(e)[None, :]
                  ).astype(jnp.int32)
        within = jnp.cumsum(onehot, axis=0) - onehot
        keep = jnp.sum(onehot * within, axis=-1) < cap
        fs.append(np.asarray(jnp.mean((onehot * keep[:, None]).astype(
            jnp.float32), axis=0)) * k)
        ps.append(np.asarray(jnp.mean(probs, axis=0)))
    f, pe = np.mean(fs, axis=0), np.mean(ps, axis=0)
    return float(e * np.sum(f * pe) / k)


def test_moe_apply_local_groups_and_aux():
    inp = _moe_inputs(2)
    jp = {k: jnp.asarray(a) for k, a in inp["w"].items()}
    want_aux = _reference_aux(inp, 2)
    for r, out in enumerate(_world("2")["moe"]):
        y, aux = jm.moe_apply(jp, jnp.asarray(inp["x"][r]), top_k=MOE["top_k"],
                              capacity_factor=MOE["cf"])
        np.testing.assert_allclose(out["y"], np.asarray(y), atol=1e-5)
        assert abs(out["aux"] - want_aux) <= 1e-6 * abs(want_aux)
        np.testing.assert_array_equal(out["y_nomesh"], out["y"])
        assert abs(out["aux_nomesh"] - float(aux)) <= 1e-6 * abs(float(aux))


def test_moe_apply_groups_is_every_rank_in_turn():
    """``moe_apply_groups`` in one process: the ranks' y concatenated, and
    the reference's aux formula over the groups."""
    from types import SimpleNamespace

    from repro_torch.models.moe import moe_apply_groups
    inp = _moe_inputs(2)
    p = SimpleNamespace(**{k: torch.from_numpy(a)
                           for k, a in inp["w"].items()})
    y, aux = moe_apply_groups(p, torch.from_numpy(
        inp["x"].reshape(-1, MOE["d"])), 2, top_k=MOE["top_k"],
        capacity_factor=MOE["cf"])
    ranks = _world("2")["moe"]
    np.testing.assert_array_equal(
        y.numpy(), np.concatenate([o["y"] for o in ranks]))
    want = _reference_aux(inp, 2)
    assert abs(float(aux) - want) <= 1e-6 * abs(want)


# ------------------------------------------------------------- mesh serving
def _single_device_tokens(arch, reqs, monkeypatch):
    if arch.startswith("granite"):
        monkeypatch.setattr(t_feeder.AdmissionFeeder, "poll",
                            t_feeder.AdmissionFeeder.poll)
        synchronous_polls(t_feeder)
    cfg = get_config(arch, smoke=True)
    model = LM(cfg, seed=0, device="cpu")
    eng = ServeEngine(cfg, model, n_slots=2, max_len=64, prompt_cap=8,
                      device="cpu")
    handles = [eng.submit(p, g) for p, g in reqs]
    eng.close_submissions()
    eng.run()
    return [list(h.tokens_out) for h in handles], eng.stats.steps


@pytest.mark.parametrize("arch", ["gemma2-9b", "granite-moe-1b-a400m"])
def test_mesh_serving_gives_the_single_device_tokens(arch, monkeypatch):
    i = ("gemma2-9b", "granite-moe-1b-a400m").index(arch)
    want, steps = _single_device_tokens(arch, _serve_reqs(256, seed=i),
                                        monkeypatch)
    outs = _world("2")["serve"][arch]
    for r, out in enumerate(outs):
        assert out["tokens"] == want, (arch, r)
        assert out["steps"] == outs[0]["steps"]
        # every stack's sequence cut in two: this rank's half
        for stack, (length, pos0, head0) in out["shards"].items():
            assert pos0 == r * length // 2 and head0 == 0
            assert out["cache"][stack][3] == length // 2
    if arch.startswith("granite"):
        assert outs[0]["steps"] == steps


# ------------------------------------------------------------ sliced AdamW
@pytest.mark.parametrize("dtype,mom", [(torch.float32, torch.float32),
                                       (torch.bfloat16, torch.float32),
                                       (torch.bfloat16, torch.bfloat16),
                                       (torch.float32, torch.bfloat16)])
def test_sliced_adamw_is_bit_equal_to_the_whole_leaf(dtype, mom,
                                                    monkeypatch):
    rng = np.random.default_rng(3)
    shapes = {"experts": (8, 6, 10), "embed": (37, 5), "bias": (9,),
              "scalar": ()}

    def tree(scale):
        return {k: torch.from_numpy(np.asarray(
            rng.normal(size=s) * scale, np.float32)).to(dtype)
            for k, s in shapes.items()}

    params, grads = tree(1.0), [tree(0.1) for _ in range(3)]
    cfg = optim.AdamWConfig(warmup_steps=2)
    runs = []
    for slice_elems in (optim.SLICE_ELEMS, 60, 1):
        monkeypatch.setattr(optim, "SLICE_ELEMS", slice_elems)
        p = {k: t.clone() for k, t in params.items()}
        st = optim.adamw_init(p, mom_dtype=mom)
        for g in grads:
            optim.adamw_update(cfg, g, st, p)
        runs.append((p, st))
    assert optim.leaf_slices((8, 6, 10), 60) == [slice(i, i + 1)
                                                 for i in range(8)]
    assert len(optim.leaf_slices((37, 5), 60)) == 4
    assert optim.leaf_slices((9,), 60) == [None]
    for p, st in runs[1:]:
        for k in shapes:
            for a, b in ((p[k], runs[0][0][k]), (st["m"][k], runs[0][1]["m"][k]),
                         (st["v"][k], runs[0][1]["v"][k])):
                assert torch.equal(a, b), k


# ------------------------------------------------- the kernels' C entries
def _c_entries(path):
    import re
    src = open(path).read()
    out = {}
    for m in re.finditer(r'extern "C" \w+ (\w+)\((.*?)\)\s*\{', src, re.S):
        params = [p.strip() for p in m.group(2).split(",")]
        out[m.group(1)] = ["p" if "*" in p else "f" if p.startswith("float")
                           else "l" if ("long" in p or "int64" in p) else "i"
                           for p in params]
    return out


def test_every_ctypes_signature_matches_its_c_entry():
    """Each kernel module's ctypes argument types (the ``_build.load``
    tables) against its library's ``extern "C"`` declarations: as many
    arguments, pointer / int / long long / float in order (a CPU run
    never calls them, so only this holds them here)."""
    import ctypes
    import importlib
    import os
    import re
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src", "repro_torch")
    kind = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_float: "f",
            ctypes.c_longlong: "l"}
    checked = 0
    for fname in sorted(os.listdir(os.path.join(root, "kernels"))):
        src = open(os.path.join(root, "kernels", fname)).read() \
            if fname.endswith(".py") else ""
        for lib, table in set(re.findall(r'_build\.load\("(\w+)", (\w+)\)',
                                         src)):
            mod = importlib.import_module(f"repro_torch.kernels.{fname[:-3]}")
            entries = _c_entries(os.path.join(root, "csrc", f"{lib}.cu"))
            for name, (_, args) in getattr(mod, table).items():
                assert [kind[a] for a in args] == entries[name], (lib, name)
                checked += 1
    assert checked >= 20
