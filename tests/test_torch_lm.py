"""repro_torch LM prefill path against the JAX reference: gemma2-9b's
smoke configuration (4 layers, d 64, window 8, both softcaps, zero-centred
norms with post-norms, tied head) at a sequence of 32, so the window
bites, with the reference's ``lm_init`` parameters carried over by
``load_reference_lm_params``. ``lm_forward`` logits and ``lm_prefill``
agree within 1e-5 in float32 with equal argmax; the shared components
(``rms_norm``, ``softcap``, the gated MLP) within the same bound; the
loader refuses a tree of another depth or shape. The other LMConfig
branches (MoE, ``qkv_bias``, the ``blocks`` and ``blocks_list`` layouts)
are held in ``test_torch_lm_configs.py``. Token ids come from a numpy
seed."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.gemma2_9b import smoke_config as j_smoke  # noqa: E402
from repro.models import common as jc  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import LM_SHAPES, get_config  # noqa: E402
from repro_torch.launch.steps import lm_prefill_cell  # noqa: E402
from repro_torch.models import common as tc  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

SEQ = 32


def _port_cfg(jcfg):
    """The port's LMConfig with the reference config's fields."""
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    fields["dtype"] = (torch.bfloat16 if jcfg.dtype == jnp.bfloat16
                       else torch.float32)
    return tt.LMConfig(**fields)


def _pair(jcfg, seed=0):
    """(reference params, port model with those params)."""
    params = jt.lm_init(jcfg, jax.random.PRNGKey(seed))
    model = tt.LM(_port_cfg(jcfg), seed=seed, device="cpu")
    tt.load_reference_lm_params(model, jax.tree.map(np.asarray, params))
    return params, model


def _tokens(vocab, b=2, s=SEQ, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def test_port_config_equals_reference_config():
    for smoke in (False, True):
        got = get_config("gemma2-9b", smoke=smoke)
        want = jt.LMConfig.__dataclass_fields__  # field names
        assert [f.name for f in dataclasses.fields(got)] == list(want)
        from repro.configs import get_config as j_get
        assert got == _port_cfg(j_get("gemma2-9b", smoke=smoke))
    assert LM_SHAPES["prefill_32k"] == dict(kind="prefill", seq_len=32768,
                                            global_batch=32)


@pytest.mark.parametrize("variant", ["gemma2-smoke", "plain-variant"])
def test_lm_forward_and_prefill_match_reference_float32(variant):
    jcfg = j_smoke()
    if variant == "plain-variant":
        # the branches gemma2 does not take but the port carries: an untied
        # head, no post-norms, plain RMSNorm weights, no embedding scale,
        # no softcaps and SiLU (the name does not start with "gemma")
        jcfg = dataclasses.replace(
            jcfg, name="lg-variant", tied_embed=False, post_norm=False,
            norm_zero_centered=False, embed_scale=False,
            attn_logit_cap=None, final_logit_cap=None, sliding_window=5)
    params, model = _pair(jcfg)
    toks = _tokens(jcfg.vocab)
    want, _ = jt.lm_forward(jcfg, params, jnp.asarray(toks))
    with torch.no_grad():
        got, aux = tt.lm_forward(model, torch.from_numpy(toks))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))
    assert float(aux) == 0.0
    pre = tt.lm_prefill(model, torch.from_numpy(toks))
    jpre = np.asarray(jt.lm_prefill(jcfg, params, jnp.asarray(toks)))
    assert pre.shape == (2, jcfg.vocab)
    np.testing.assert_allclose(pre.numpy(), jpre, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(pre.argmax(-1).numpy(), jpre.argmax(-1))


def test_lm_prefill_matches_reference_bf16():
    """bf16 weights and activations. The two frameworks round to bf16 at
    other points (XLA fuses elementwise chains in float32 and rounds once;
    PyTorch rounds after each op), so a bf16 ulp (2^-8 relative) differs
    here and there and compounds over the 4 layers. Measured on this
    input and two other seeds: at most 0.0102 on logits of magnitude up
    to 0.57 (about five ulps); the bound is 0.05, five times that."""
    jcfg = dataclasses.replace(j_smoke(), dtype=jnp.bfloat16)
    params, model = _pair(jcfg, seed=1)
    toks = _tokens(jcfg.vocab, seed=1)
    got = tt.lm_prefill(model, torch.from_numpy(toks))
    want = jt.lm_prefill(jcfg, params, jnp.asarray(toks))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=0.05)


def test_loader_refuses_stacked_tree_and_wrong_shapes():
    model = tt.LM(get_config("gemma2-9b", smoke=True), device="cpu")
    stacked = jax.tree.map(np.asarray, jt.lm_init(
        dataclasses.replace(j_smoke(), local_global=False, n_layers=3),
        jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="depth"):
        tt.load_reference_lm_params(model, stacked)
    params = jax.tree.map(np.asarray, jt.lm_init(
        dataclasses.replace(j_smoke(), d_ff=64), jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="shape"):
        tt.load_reference_lm_params(model, params)


def test_common_components_match_reference():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32) * 0.1
    for zc in (False, True):
        got = tc.rms_norm(torch.from_numpy(x), torch.from_numpy(scale),
                          zero_centered=zc)
        want = jc.rms_norm(jnp.asarray(x), jnp.asarray(scale),
                           zero_centered=zc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(
        tc.softcap(torch.from_numpy(x * 40), 30.0).numpy(),
        np.asarray(jc.softcap(jnp.asarray(x * 40), 30.0)), rtol=1e-5,
        atol=1e-5)
    assert torch.equal(tc.softcap(torch.from_numpy(x), None),
                       torch.from_numpy(x))
    w = [rng.normal(size=s).astype(np.float32) * 0.1
         for s in ((64, 96), (64, 96), (96, 64))]
    p = dict(zip(("w_gate", "w_in", "w_out"), w))
    got = tc.glu_apply(*map(torch.from_numpy, w), torch.from_numpy(x),
                       act=tc.gelu_tanh)
    want = jc.glu_apply({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), act=jax.nn.gelu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_initialisers_use_the_reference_scales():
    g = torch.Generator().manual_seed(0)
    w = tc.dense_init(g, 1024, 512)
    assert abs(float(w.std()) - 1024 ** -0.5) < 0.02 * 1024 ** -0.5
    e = tc.embed_init(g, 4096, 64, dtype=torch.bfloat16)
    assert e.dtype == torch.bfloat16
    assert abs(float(e.float().std()) - 0.02) < 0.001
    glu = tc.glu_init(g, 64, 128)
    assert {k: tuple(v.shape) for k, v in glu.items()} == {
        "w_gate": (64, 128), "w_in": (64, 128), "w_out": (128, 64)}


def test_seeded_init_is_deterministic_and_layer_ordered():
    cfg = get_config("gemma2-9b", smoke=True)
    a, b = tt.LM(cfg, seed=3, device="cpu"), tt.LM(cfg, seed=3, device="cpu")
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    assert len(a.layers) == cfg.n_layers
    assert [a.window(i) for i in range(4)] == [8, None, 8, None]
    assert not torch.equal(a.embed, tt.LM(cfg, seed=4, device="cpu").embed)


def test_prefill_cell_runs_the_smoke_model():
    cell = lm_prefill_cell("gemma2-9b", seq_len=SEQ, batch=2, device="cpu",
                           seed=5, smoke=True)
    assert cell.tokens.shape == (2, SEQ) and cell.tokens.dtype == torch.int32
    again = lm_prefill_cell("gemma2-9b", seq_len=SEQ, batch=2, device="cpu",
                            seed=5, smoke=True)
    assert torch.equal(cell.tokens, again.tokens)
    out = cell.step()
    assert out.shape == (2, cell.model.cfg.vocab)
    assert bool(torch.isfinite(out).all())
    assert torch.equal(out, again.step())
    assert float(out.abs().max()) <= 30.0  # the final softcap
