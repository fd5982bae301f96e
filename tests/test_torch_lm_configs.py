"""repro_torch's LM configurations beyond gemma2 against the JAX
reference: the config registry (``configs/base.py``: ``ARCHS``,
``all_cells``, the shape tables, every LM config full and smoke); and the
smoke configs of granite-moe-1b-a400m (MoE 8 experts top-4, GQA, tied),
codeqwen1.5-7b (MHA, qkv_bias), qwen1.5-32b (MHA, qkv_bias, int8 cache)
and grok-1-314b (MoE 4 experts top-2, GQA) with the reference's
``lm_init`` weights carried over by ``load_reference_lm_params``, under
both layer layouts (the stacked ``blocks`` tree, ``scan_layers=True``,
and the unrolled ``blocks_list``): ``lm_forward`` logits and aux loss,
``lm_prefill``, ``lm_loss`` and 12 ``lm_decode_step`` s (tokens equal on
each side's own cache; logits and the updated cache from the reference's
cache), the caches' shapes and dtypes, and no sliding window on any of
their layers at a length past a small ``sliding_window``. Token ids come
from numpy seeds.

Every test but the registry's draws the biases and norm scales, which
``lm_init`` fills with zeros and ones, from a numpy seed before both
sides load them (``randomized``), and
``test_each_qkv_bias_moves_the_logits`` shows that each bias moves the
prefill's and the decode's logits.

Tolerances (float32): logits and prefill logits within 1e-5 (another
summation order in the matmuls, the softmax and the MoE combine's k-term
sum; measured at most 4.8e-6 on the forward's logits, on a CPU); decode
logits from the reference's cache within 1e-3, its cache within a bf16
ulp or an int8 step (a value rounded on the other side of a boundary:
``test_decode_steps_match_the_reference`` gives why); the aux loss within
1e-6 relative. bf16 (granite's smoke config; measured 0.0044 to 0.0107
on seeds 0 to 2, logits up to 0.64): the bound of
``test_torch_lm.test_lm_prefill_matches_reference_bf16``, 0.05."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.models.common import rms_norm as j_rms_norm  # noqa: E402
from repro.models.common import softcap as j_softcap  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.launch.steps import (lm_prefill_cell,  # noqa: E402
                                      lm_train_cell)
from repro_torch.models import transformer as tt  # noqa: E402

from test_torch_lm import _port_cfg  # noqa: E402

ARCHS = ["granite-moe-1b-a400m", "codeqwen1.5-7b", "qwen1.5-32b",
         "grok-1-314b"]
LM_ARCHS = ARCHS + ["gemma2-9b"]
SEQ = 32
DECODE_STEPS = 12
TOL = 1e-5


def _jcfg(arch, scan=True, **change):
    return dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                               scan_layers=scan, **change)


# the leaves ``lm_init`` fills with zeros or ones
_CONSTANT_LEAVES = ("bq", "bk", "bv", "ln_attn", "ln_mlp", "ln_final",
                    "ln_post_attn", "ln_post_mlp")


def randomized(jcfg, params, seed):
    """The reference tree with its qkv biases and norm scales (all zeros
    or ones from ``lm_init``) drawn from a numpy seed, a value an element
    and a layer: biases N(0, 0.5²), scales 1 + N(0, 0.1²) (N(0, 0.1²)
    zero-centred), so that a bias dropped, misplaced or loaded into
    another's place shows."""
    rng = np.random.default_rng(1000 + seed)

    def draw(name, leaf):
        shape = np.shape(leaf)
        if name.startswith("b"):
            a = 0.5 * rng.normal(size=shape)
        else:
            a = 0.1 * rng.normal(size=shape) + (
                0.0 if jcfg.norm_zero_centered else 1.0)
        return jnp.asarray(a, jnp.float32).astype(leaf.dtype)

    def walk(node):
        if isinstance(node, list):
            return [walk(n) for n in node]
        if isinstance(node, dict):
            return {k: draw(k, v) if k in _CONSTANT_LEAVES else walk(v)
                    for k, v in node.items()}
        return node
    return walk(params)


def _load(jcfg, params, seed=0):
    model = tt.LM(_port_cfg(jcfg), seed=seed, device="cpu")
    return tt.load_reference_lm_params(model,
                                       jax.tree.map(np.asarray, params))


def _pair(jcfg, seed=0):
    """(reference params with seeded biases and norm scales, port model
    with those params)."""
    params = randomized(jcfg, jt.lm_init(jcfg, jax.random.PRNGKey(seed)),
                        seed)
    return params, _load(jcfg, params, seed)


def _tokens(vocab, b=2, s=SEQ, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


# ---------------------------------------------------------------- registry
def test_registry_equals_the_reference():
    assert list(tconfigs.ARCHS) == list(jconfigs.ARCHS)
    for aid, spec in jconfigs.ARCHS.items():
        assert dataclasses.asdict(tconfigs.get_arch(aid)) == \
            dataclasses.asdict(spec), aid
    assert tconfigs.all_cells() == jconfigs.all_cells()
    assert len(tconfigs.all_cells()) == 40
    assert tconfigs.LM_SHAPES == jconfigs.LM_SHAPES
    assert tconfigs.GNN_SHAPES == jconfigs.GNN_SHAPES
    assert tconfigs.RECSYS_SHAPES == jconfigs.RECSYS_SHAPES


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_config_equals_the_reference(arch, smoke):
    got = tconfigs.get_config(arch, smoke=smoke)
    assert [f.name for f in dataclasses.fields(got)] == list(
        jt.LMConfig.__dataclass_fields__)
    assert got == _port_cfg(jconfigs.get_config(arch, smoke=smoke))


def test_unported_arch_names_its_roadmap_item():
    """Every registered arch is ported: dlrm-rm2's configs (the
    recommender substrate, ROADMAP.md A.8) equal the reference's field by
    field; an unknown id raises ``KeyError``."""
    for smoke in (False, True):
        got = tconfigs.get_config("dlrm-rm2", smoke=smoke)
        want = jconfigs.get_config("dlrm-rm2", smoke=smoke)
        assert [f.name for f in dataclasses.fields(got)] == [
            f.name for f in dataclasses.fields(want)]
        for f in dataclasses.fields(want):
            if f.name != "dtype":
                assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")
    assert tconfigs.get_arch("dlrm-rm2").family == "recsys"


# ----------------------------------------------------------------- forward
@pytest.mark.parametrize("scan", [True, False], ids=["blocks",
                                                     "blocks_list"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_the_reference(arch, scan):
    jcfg = _jcfg(arch, scan)
    params, model = _pair(jcfg)
    assert ("blocks" in params) == scan and ("blocks_list" in params) != scan
    toks = _tokens(jcfg.vocab)
    want, jaux = jt.lm_forward(jcfg, params, jnp.asarray(toks))
    with torch.no_grad():
        got, aux = tt.lm_forward(model, torch.from_numpy(toks))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))
    assert aux.dtype == torch.float32
    if jcfg.is_moe:
        assert float(aux) > 0
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    else:
        assert float(aux) == float(jaux) == 0.0
    pre = tt.lm_prefill(model, torch.from_numpy(toks))
    jpre = np.asarray(jt.lm_prefill(jcfg, params, jnp.asarray(toks)))
    np.testing.assert_allclose(pre.numpy(), jpre, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(pre.argmax(-1).numpy(), jpre.argmax(-1))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "grok-1-314b"])
def test_lm_loss_adds_the_moe_aux_loss(arch):
    jcfg = _jcfg(arch)
    params, model = _pair(jcfg, seed=2)
    toks = _tokens(jcfg.vocab, seed=2)
    want = float(jt.lm_loss(jcfg, params, jnp.asarray(toks)))
    with torch.no_grad():
        got = float(tt.lm_loss(model, torch.from_numpy(toks)))
        _, aux = tt.lm_forward(model, torch.from_numpy(toks))
    assert float(aux) > 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "codeqwen1.5-7b",
                                  "qwen1.5-32b"])
def test_both_layouts_load_one_model_alike(arch):
    """The stacked tree and the same weights as a list of per-layer trees
    load into equal modules, which give equal logits."""
    jcfg = _jcfg(arch)
    params = jax.tree.map(np.asarray, randomized(
        jcfg, jt.lm_init(jcfg, jax.random.PRNGKey(3)), 3))
    listed = {k: v for k, v in params.items() if k != "blocks"}
    listed["blocks_list"] = [jax.tree.map(lambda a, i=i: a[i],
                                          params["blocks"])
                             for i in range(jcfg.n_layers)]
    cfg = _port_cfg(jcfg)
    a = tt.load_reference_lm_params(tt.LM(cfg, device="cpu"), params)
    b = tt.load_reference_lm_params(
        tt.LM(dataclasses.replace(cfg, scan_layers=False), device="cpu"),
        listed)
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb), na
    names = [n for n, _ in a.named_parameters()]
    assert ("layers.1.moe.router" in names) == jcfg.is_moe
    assert ("layers.1.bk" in names) == jcfg.qkv_bias
    toks = torch.from_numpy(_tokens(cfg.vocab, seed=3))
    assert torch.equal(tt.lm_prefill(a, toks), tt.lm_prefill(b, toks))


@pytest.mark.parametrize("fault", ["bk and bv swapped", "bq zero",
                                   "bk zero", "bv zero"])
@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "qwen1.5-32b"])
def test_each_qkv_bias_moves_the_logits(arch, fault):
    """The parity tests see every bias: a tree with bk and bv swapped, or
    with one of bq, bk and bv zero, gives other prefill logits and other
    decode logits than the tree as drawn (which the reference's equal),
    by far more than the parity tolerance (read: 0.32 to 6.0 on this
    CPU)."""
    jcfg = _jcfg(arch)
    params, model = _pair(jcfg, seed=6)
    blocks = dict(params["blocks"])
    if fault == "bk and bv swapped":
        blocks["bk"], blocks["bv"] = blocks["bv"], blocks["bk"]
    else:
        name = fault.split()[0]
        blocks[name] = jnp.zeros_like(blocks[name])
    faulty = _load(jcfg, {**params, "blocks": blocks}, seed=6)
    toks = torch.from_numpy(_tokens(jcfg.vocab, seed=6))
    want = np.asarray(jt.lm_prefill(jcfg, params, jnp.asarray(toks.numpy())))
    good, bad = tt.lm_prefill(model, toks), tt.lm_prefill(faulty, toks)
    np.testing.assert_allclose(good.numpy(), want, rtol=TOL, atol=TOL)
    assert float((good - bad).abs().max()) > 1e3 * TOL
    caches = [tt.make_cache(m.cfg, batch=3, max_len=32, device="cpu")
              for m in (model, faulty)]
    apart = 0.0
    for toks, pos in _steps(3, jcfg.vocab, seed=6):
        (_, lg), (_, lb) = (tt.lm_decode_step(
            m, c, torch.from_numpy(toks), torch.from_numpy(pos),
            return_logits=True) for m, c in zip((model, faulty), caches))
        apart = max(apart, float((lg - lb).abs().max()))
    assert apart > 1e3 * TOL


def test_loader_refuses_a_tree_of_another_depth():
    jcfg = _jcfg("codeqwen1.5-7b")
    model = tt.LM(_port_cfg(jcfg), device="cpu")
    deeper = jax.tree.map(np.asarray, jt.lm_init(
        dataclasses.replace(jcfg, n_layers=3), jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="depth"):
        tt.load_reference_lm_params(model, deeper)
    listed = jax.tree.map(np.asarray, jt.lm_init(
        dataclasses.replace(jcfg, n_layers=3, scan_layers=False),
        jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="layer count"):
        tt.load_reference_lm_params(model, listed)


def test_no_sliding_window_past_a_small_sliding_window():
    """A config without local_global attends every earlier key in every
    layer, whatever ``sliding_window`` says: at 32 tokens past a window of
    4 the port equals the reference (which ignores the window there) and
    differs from the same model with a window."""
    jcfg = _jcfg("codeqwen1.5-7b", sliding_window=4)
    params, model = _pair(jcfg, seed=4)
    assert [model.window(i) for i in range(len(model.layers))] == [None] * 2
    toks = _tokens(jcfg.vocab, seed=4)
    seen = []
    real = tt.flash_attention_bhsd

    def spy(q, k, v, **kw):
        seen.append(kw["window"])
        return real(q, k, v, **kw)
    tt.flash_attention_bhsd = spy
    try:
        got = tt.lm_prefill(model, torch.from_numpy(toks))
    finally:
        tt.flash_attention_bhsd = real
    assert seen == [None, None]
    want = np.asarray(jt.lm_prefill(jcfg, params, jnp.asarray(toks)))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    windowed = np.asarray(jt.lm_prefill(
        dataclasses.replace(jcfg, local_global=True), params_lg(params),
        jnp.asarray(toks)))
    assert np.abs(windowed - want).max() > 1e-3


def params_lg(params):
    """The stacked 2-layer tree as gemma2's (local, global) stacks."""
    return {**{k: v for k, v in params.items() if k != "blocks"},
            "local": jax.tree.map(lambda a: a[0::2], params["blocks"]),
            "global": jax.tree.map(lambda a: a[1::2], params["blocks"])}


def test_bf16_moe_prefill_matches_the_reference():
    """granite's smoke config in bf16: routing runs on the float32 router
    (the same experts on both sides); the bf16 rounding points differ
    (XLA fuses elementwise chains in float32), as in gemma2's bf16
    test."""
    jcfg = _jcfg("granite-moe-1b-a400m", dtype=jnp.bfloat16)
    params, model = _pair(jcfg, seed=1)
    toks = _tokens(jcfg.vocab, seed=1)
    got = tt.lm_prefill(model, torch.from_numpy(toks))
    want = jt.lm_prefill(jcfg, params, jnp.asarray(toks))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=0.05)


# ------------------------------------------------------------------ decode
@pytest.mark.parametrize("arch", ARCHS)
def test_make_cache_equals_the_reference(arch):
    jcfg = _jcfg(arch)
    want = jt.make_cache(jcfg, batch=3, max_len=16)
    got = tt.make_cache(_port_cfg(jcfg), batch=3, max_len=16, device="cpu")
    assert list(got) == list(want) == ["blocks"]
    for name, w in want["blocks"].items():
        g = got["blocks"][name]
        assert tuple(g.shape) == w.shape, name
        assert str(g.dtype).split(".")[1] == str(w.dtype), name
    view = tt.layer_cache(got, 1)
    assert view["k"].data_ptr() == got["blocks"]["k"][1].data_ptr()


def _j_decode_logits(cfg, params, cache, tokens, pos):
    """The reference's ``lm_decode_step`` (stacked or unrolled layers)
    returning the logits as well: its own lines, the head's result
    kept."""
    x = jnp.take(params["embed"], tokens[:, 0], axis=0)[:, None, :].astype(
        cfg.dtype)
    if "blocks_list" in params:
        slices = []
        for i, pb in enumerate(params["blocks_list"]):
            cb = jax.tree.map(lambda c: c[i], cache["blocks"])
            x, ncb = jt._decode_block(cfg, pb, x, cb, pos)
            slices.append(ncb)
        ncb = jax.tree.map(lambda *xs: jnp.stack(xs), *slices)
    else:
        def one(x, xs):
            return jt._decode_block(cfg, xs[0], x, xs[1], pos)
        x, ncb = jax.lax.scan(one, x, (params["blocks"], cache["blocks"]))
    x = j_rms_norm(x, params["ln_final"],
                   zero_centered=cfg.norm_zero_centered)
    head = params["embed"].T if cfg.tied_embed else params["lm_head"]
    logits = j_softcap(x @ head.astype(x.dtype), cfg.final_logit_cap)
    return logits[:, -1], {"blocks": ncb}


def _steps(b, vocab, seed=1):
    rng = np.random.default_rng(seed)
    for step in range(DECODE_STEPS):
        toks = rng.integers(0, vocab, (b, 1)).astype(np.int32)
        yield toks, np.array([step, step + 3, max(step - 4, 0)], np.int32)


@pytest.mark.parametrize("scan", [True, False], ids=["blocks",
                                                     "blocks_list"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_the_reference(arch, scan):
    """12 steps at a position a row: on each side's own cache the next
    tokens are equal at every step; from the reference's cache (copied
    into the port's) the logits and the updated cache within the bounds
    of ``test_torch_decode.test_lm_decode_step_logits_and_cache_match_
    reference``: a k or v value that the two sides' float32 noise puts on
    opposite sides of a bf16 or int8 rounding boundary moves by one ulp or
    one int8 step and moves the layers after it (read: one bf16 v value a
    step, 4.4e-4 on codeqwen's logits, this CPU). Logits 1e-3; bf16 values
    one bf16 ulp (2^-7 relative) plus 1e-5; int8 values one step; scales
    1e-3 relative."""
    jcfg = _jcfg(arch, scan)
    params, model = _pair(jcfg, seed=5)
    b = 3
    jcache = jt.make_cache(jcfg, batch=b, max_len=32)
    own = tt.make_cache(model.cfg, batch=b, max_len=32, device="cpu")
    mirror = tt.make_cache(model.cfg, batch=b, max_len=32, device="cpu")
    dec = jax.jit(lambda p, c, t, pos: jt.lm_decode_step(jcfg, p, c, t, pos))
    logits_fn = jax.jit(lambda p, c, t, pos: _j_decode_logits(jcfg, p, c, t,
                                                              pos))
    for step, (toks, pos) in enumerate(_steps(b, jcfg.vocab)):
        for name, w in jcache["blocks"].items():
            a = np.array(w)
            mirror["blocks"][name].copy_(torch.from_numpy(
                a.astype(np.float32) if a.dtype == jnp.bfloat16 else a))
        jn, _ = dec(params, jcache, jnp.asarray(toks), jnp.asarray(pos))
        jl, jcache = logits_fn(params, jcache, jnp.asarray(toks),
                               jnp.asarray(pos))
        np.testing.assert_array_equal(np.argmax(np.asarray(jl), -1),
                                      np.asarray(jn)[:, 0])
        tn = tt.lm_decode_step(model, own, torch.from_numpy(toks),
                               torch.from_numpy(pos))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn),
                                      err_msg=f"step {step}")
        _, tl = tt.lm_decode_step(model, mirror, torch.from_numpy(toks),
                                  torch.from_numpy(pos), return_logits=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-3, err_msg=f"step {step}")
        for name, w in jcache["blocks"].items():
            got, w = mirror["blocks"][name].float().numpy(), np.array(w)
            w, what = w.astype(np.float32), f"step {step} {name}"
            if name.endswith("scale"):
                np.testing.assert_allclose(got, w, rtol=1e-3, atol=0,
                                           err_msg=what)
            elif jcfg.kv_cache_dtype == "int8":
                assert np.abs(got - w).max() <= 1, what
            else:
                np.testing.assert_allclose(got, w, rtol=2 ** -7, atol=1e-5,
                                           err_msg=what)


# ------------------------------------------------------------------- cells
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cell_runs_each_smoke_model(arch):
    cell = lm_prefill_cell(arch, seq_len=16, batch=2, device="cpu", seed=5,
                           smoke=True)
    out = cell.step()
    assert out.shape == (2, cell.model.cfg.vocab)
    assert bool(torch.isfinite(out).all())
    assert torch.equal(out, lm_prefill_cell(arch, seq_len=16, batch=2,
                                            device="cpu", seed=5,
                                            smoke=True).step())


@pytest.mark.parametrize("arch", ARCHS)
def test_training_of_the_new_lms_names_its_roadmap_item(arch, tmp_path,
                                                        capsys):
    """LM training of these configs (A.7's training half) is ported: one
    smoke step of the train cell gives a finite loss near ln(vocab) and
    moves every parameter the loss reaches, and the CLI trains a step."""
    cell = lm_train_cell(arch, seq_len=16, batch=2, smoke=True, device="cpu")
    before = {n: p.detach().clone()
              for n, p in cell.model.named_parameters()}
    m = cell.step()
    loss = float(m["loss"])
    assert np.isfinite(loss) and abs(loss - np.log(cell.model.cfg.vocab)) < 1
    for n, p in cell.model.named_parameters():
        assert not torch.equal(p.detach(), before[n]), n
    tlaunch.main(["--arch", arch, "--smoke", "--steps", "1", "--device",
                  "cpu", "--ckpt-dir", str(tmp_path)])
    assert "'step': 0" in capsys.readouterr().out
