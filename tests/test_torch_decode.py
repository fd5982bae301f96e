"""repro_torch decode path against the JAX reference: ``quantize_kv`` /
``dequantize_kv`` bit for bit (values at exact half steps of the scale,
zeros and ±amax included); ``make_cache`` shapes and dtypes;
``_cache_insert`` under scalar and [B] positions, bf16 and int8, across a
ring wrap, bit for bit on equal inputs; ``decode_attention`` (the plain
twin, and the kernel wrapper on CPU tensors) and
``decode_attention_partial`` against the reference's, bf16 and int8
caches, with and without the cap and a window, at cache lengths 1, mid
and full; the decode kernel's split-and-combine arithmetic run in torch
against the unsplit twin; the derived tolerance ``twin_tolerance`` holding
those and rejecting four planted faults; and ``lm_decode_step`` on the
float32 gemma2 smoke config (window 8) with bf16 and int8 caches, scalar
and vector positions, over 40 steps (the ring wraps): the next tokens
equal to the reference's, each side on its own cache; and from the
reference's cache at every step, the logits and the updated cache within
the stated bounds (``test_lm_decode_step_logits_and_cache_match_reference``
gives them and why).

Tolerances: attention outputs against the reference (another float32
summation order) within ``twin_tolerance`` (derived from float32 rounding,
see its docstring); the partial (m, l, acc) within rtol = 1e-5 of the
reference's (a dh-16 dot product and a 40-term sum in float32 differ by a
few ulps; 1e-5 is ~80 ulps)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.configs.gemma2_9b import config as j_full  # noqa: E402
from repro.configs.gemma2_9b import smoke_config as j_smoke  # noqa: E402
from repro.models import attention as ja  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.models.common import rms_norm as j_rms_norm  # noqa: E402
from repro.models.common import softcap as j_softcap  # noqa: E402
from repro_torch.kernels import decode_attention as tda  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

from test_torch_lm import _port_cfg  # noqa: E402

STEPS = 40  # decode steps: the smoke config's window-8 ring wraps 5 times


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _j_np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


# ------------------------------------------------------------ quantization
def _kv_rows(seed, dtype):
    """[2, 3, 5, 16] KV values: random rows, rows on exact half steps of
    their scale (the rounding's ties), a zero row, rows at ±amax."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 3, 5, 16)).astype(np.float32) * rng.uniform(
        1e-3, 10.0, (2, 3, 5, 1)).astype(np.float32)
    amax = np.float32(rng.uniform(0.5, 4.0))
    scale = np.maximum(amax, np.float32(1e-8)) / np.float32(127.0)
    steps = rng.integers(-126, 126, 16) + 0.5
    x[0, 0, 0] = (steps * scale).astype(np.float32)
    x[0, 0, 0, 0] = amax
    x[0, 0, 1] = 0.0
    x[0, 0, 2, :8], x[0, 0, 2, 8:] = amax, -amax
    x[1, 2, 4] = np.float32(1e-9)  # below the 1e-8 floor of the scale
    if dtype == "bf16":
        return _np(torch.from_numpy(x).to(torch.bfloat16))
    return x


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1), dtype=st.sampled_from(["f32",
                                                                  "bf16"]))
def test_quantize_kv_bit_identical_to_reference(seed, dtype):
    x = _kv_rows(seed, dtype)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jq, js = ja.quantize_kv(jnp.asarray(x, jdt))
    tq, ts = ta.quantize_kv(_t(x).to(tdt))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    jd = ja.dequantize_kv(jq, js)
    td = ta.dequantize_kv(tq, ts)
    assert td.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(td), _j_np(jd))


# ------------------------------------------------------------------- cache
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("full", [False, True])
def test_make_cache_shapes_and_dtypes_equal_reference(kv, full):
    jcfg = dataclasses.replace(j_full() if full else j_smoke(),
                               kv_cache_dtype=kv)
    want = jt.make_cache(jcfg, batch=2, max_len=16 if full else 32)
    got = tt.make_cache(_port_cfg(jcfg), batch=2,
                        max_len=16 if full else 32, device="cpu")
    assert sorted(got) == sorted(want)
    for stack in want:
        assert sorted(got[stack]) == sorted(want[stack])
        for name, w in want[stack].items():
            g = got[stack][name]
            assert tuple(g.shape) == tuple(w.shape), (stack, name)
            assert str(g.dtype).split(".")[-1] == str(w.dtype), (stack, name)
            assert not bool(g.any())


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("vector", [False, True])
def test_cache_insert_bit_identical_across_a_ring_wrap(kv, vector):
    """A local (ring of 8) and a global layer's cache under 20 inserts of
    equal inputs: the positions pass the ring's length twice."""
    jcfg = dataclasses.replace(j_smoke(), kv_cache_dtype=kv)
    cfg = _port_cfg(jcfg)
    b = 3
    jcache = jt.make_cache(jcfg, batch=b, max_len=32)
    tcache = tt.make_cache(cfg, batch=b, max_len=32, device="cpu")
    rng = np.random.default_rng(7)
    for step in range(20):
        k, v = (rng.normal(size=(b, cfg.n_kv_heads, 1, cfg.dh)).astype(
            np.float32) * 3 for _ in range(2))
        pos = (np.array([step, 2 * step, max(step - 5, 0)], np.int32)
               if vector else step)
        for stack in ("local", "global"):
            jl = {n: c[0] for n, c in jcache[stack].items()}
            jl = jt._cache_insert(jcfg, jl, jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(pos))
            for n in jcache[stack]:
                jcache[stack][n] = jcache[stack][n].at[0].set(jl[n])
            tt._cache_insert(cfg, tt.layer_cache(tcache, 0 if stack ==
                                                 "local" else 1),
                             _t(k), _t(v), _t(pos) if vector else pos)
    for stack in jcache:
        for n, w in jcache[stack].items():
            np.testing.assert_array_equal(_np(tcache[stack][n]), _j_np(w),
                                          err_msg=f"{stack}.{n}")


# -------------------------------------------------------- decode attention
B, H, HKV, S, DH = 3, 4, 2, 40, 16


def _attn_inputs(kv, seed=0, b=B, h=H, hkv=HKV, s=S, dh=DH, q_scale=1.0,
                 q_dtype=torch.float32):
    """(q, k, v, k_scale, v_scale) as torch tensors (scales None for a
    bf16 cache): q [b, h, 1, dh], the cache [b, hkv, s, dh]."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(b, h, 1, dh)).astype(
        np.float32) * q_scale).to(q_dtype)
    k, v = (torch.from_numpy(rng.normal(size=(b, hkv, s, dh)).astype(
        np.float32)) for _ in range(2))
    if kv == "int8":
        (k, ks), (v, vs) = ta.quantize_kv(k), ta.quantize_kv(v)
        return q, k, v, ks, vs
    return q, k.to(torch.bfloat16), v.to(torch.bfloat16), None, None


def _lens(kind, b=B, s=S):
    return torch.tensor({"one": [1] * b, "mid": [s // 2, 7, s - 3],
                         "full": [s] * b}[kind][:b], dtype=torch.int32)


def _j(t):
    if t is None:
        return None
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _ratio(got, want, tol):
    """The worst |got − want| / tol (0 where they are equal)."""
    diff = (got.double() - want.double()).abs()
    return float(torch.where(diff == 0, 0.0, diff / tol).max())


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("cap", [None, 50.0])
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("lens", ["one", "mid", "full"])
def test_decode_attention_matches_reference(kv, cap, window, lens):
    q, k, v, ks, vs = _attn_inputs(kv, seed=hash((kv, cap, window)) % 1000,
                                   q_scale=8.0)
    cl = _lens(lens)
    kw = dict(window=window, logit_cap=cap, k_scale=ks, v_scale=vs)
    got = ta.decode_attention_plain(q, k, v, cl, **kw)
    want = ja.decode_attention(_j(q), _j(k), _j(v), _j(cl), window=window,
                               logit_cap=cap, k_scale=_j(ks),
                               v_scale=_j(vs))
    tol = tda.twin_tolerance(q, k, v, cl, **kw)
    assert _ratio(got, _t(_j_np(want)), tol) <= 1.0
    # the wrapper runs the twin on CPU tensors
    assert torch.equal(tda.decode_attention(q, k, v, cl, **kw), got)
    # the kernel's arithmetic: splits of 7 positions (dead ones too)
    split = ta.decode_attention_split(q, k, v, cl, split=7, **kw)
    assert _ratio(split, got, tol) <= 1.0


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("cap", [None, 50.0])
def test_decode_attention_partial_matches_reference(kv, cap):
    q, k, v, ks, vs = _attn_inputs(kv, seed=3)
    if kv == "int8":  # the partial takes a dequantized shard
        k, v = ta.dequantize_kv(k, ks), ta.dequantize_kv(v, vs)
    mask = ta.decode_mask(_lens("mid"), S)
    got = ta.decode_attention_partial(q, k, v, mask, logit_cap=cap)
    want = ja.decode_attention_partial(_j(q), _j(k), _j(v), _j(mask),
                                       logit_cap=cap)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def test_decode_attention_bf16_q_matches_reference():
    """gemma2-9b's heads (16 over 8, dh 256), a bf16 q and an int8 cache:
    the output rounds to bf16 on both sides (one ulp in the tolerance)."""
    q, k, v, ks, vs = _attn_inputs("int8", seed=5, b=2, h=16, hkv=8, s=300,
                                   dh=256, q_dtype=torch.bfloat16)
    cl = torch.tensor([300, 123], dtype=torch.int32)
    kw = dict(logit_cap=50.0, k_scale=ks, v_scale=vs)
    got = ta.decode_attention_plain(q, k, v, cl, **kw)
    assert got.dtype == torch.bfloat16
    want = ja.decode_attention(_j(q), _j(k), _j(v), _j(cl), logit_cap=50.0,
                               k_scale=_j(ks), v_scale=_j(vs))
    tol = tda.twin_tolerance(q, k, v, cl, **kw)
    assert _ratio(got, _t(_j_np(want)), tol) <= 1.0


def _faulted(q, k, v, cl, ks, vs, fault):
    """The twin with one planted fault (what the kernel check must see)."""
    kw = dict(logit_cap=50.0, k_scale=ks, v_scale=vs)
    if fault == "no_cap":
        kw["logit_cap"] = None
    elif fault == "len_plus_1":
        cl = cl + 1
    elif fault == "next_kv_head":
        k, v = k.roll(1, dims=1), v.roll(1, dims=1)
        kw["k_scale"], kw["v_scale"] = ks.roll(1, dims=1), vs.roll(1, dims=1)
    elif fault == "dequant_f32":  # int8 × scale widened without bf16
        return ta.decode_attention_plain(q, k.to(torch.float32) * ks,
                                         v.to(torch.float32) * vs, cl,
                                         logit_cap=50.0)
    return ta.decode_attention_plain(q, k, v, cl, **kw)


@pytest.mark.parametrize("fault,q_scale", [("no_cap", 8.0),
                                           ("dequant_f32", 8.0),
                                           ("len_plus_1", 1.0),
                                           ("next_kv_head", 1.0)])
def test_split_form_within_tolerance_and_faults_outside(fault, q_scale):
    """At gemma2-9b's heads, an int8 cache of 1,024 positions (4 splits of
    SPLIT) and lengths 1, 300 and 1,023: the split-and-combine arithmetic
    (the kernel's) within ``twin_tolerance`` of the twin; the planted
    fault outside it. The cap and the dequantization's bf16 rounding show
    where the scores are large (q × 8, as a cap of 50 acts there), one
    position more and the next kv head where the softmax is spread
    (q × 1). float32 q: no output rounding in the way."""
    q, k, v, ks, vs = _attn_inputs("int8", seed=11, b=3, h=16, hkv=8,
                                   s=1024, dh=256, q_scale=q_scale)
    cl = torch.tensor([1, 300, 1023], dtype=torch.int32)
    kw = dict(logit_cap=50.0, k_scale=ks, v_scale=vs)
    want = ta.decode_attention_plain(q, k, v, cl, **kw)
    tol = tda.twin_tolerance(q, k, v, cl, **kw)
    split = ta.decode_attention_split(q, k, v, cl,
                                      split=tda.split_size(1024), **kw)
    assert _ratio(split, want, tol) <= 1.0
    bad = _faulted(q, k, v, cl, ks, vs, fault)
    assert _ratio(bad, want, tol) > 2.0, fault


@pytest.mark.parametrize("s", [1, 40, 300, 1024, 4096, 8192, 8193, 16384,
                               32768, 65536, 131072, 1 << 20])
def test_split_size_bounds_the_splits(s):
    """A split is a multiple of the kernel's chunk within [SPLIT,
    MAX_SPLIT]; a cache never has more splits than at SPLIT positions a
    split (so ``twin_tolerance``'s split term never grows), and from
    8,192 positions to 65,536 it has TARGET_SPLITS or fewer."""
    split = tda.split_size(s)
    assert split % tda.CHUNK == 0 and tda.SPLIT <= split <= tda.MAX_SPLIT
    assert tda.n_splits(s) == -(-s // split) <= -(-s // tda.SPLIT)
    if 8192 <= s <= 65536:
        assert tda.n_splits(s) <= tda.TARGET_SPLITS
    if s <= 8192:
        assert split == tda.SPLIT


@pytest.mark.parametrize("kv,dh,offset,want", [
    ("int8", 256, 0, 16), ("int8", 256, 4, 4), ("int8", 256, 1, 1),
    ("int8", 40, 0, 4), ("int8", 37, 0, 1), ("int8", 16, 0, 16),
    ("bf16", 16, 0, 16), ("bf16", 256, 2, 4), ("bf16", 256, 1, 1),
    ("bf16", 37, 0, 1)])
def test_load_width_follows_rows_and_addresses(kv, dh, offset, want):
    """The kernel's copy unit: 16 bytes where a row's bytes and both
    caches' addresses allow it, else 4, else 1 (``offset`` elements into
    a 16-byte aligned buffer)."""
    dtype = torch.int8 if kv == "int8" else torch.bfloat16
    shape = (2, 2, 5, dh)
    n = int(np.prod(shape))
    bufs = [torch.empty(n + 16, dtype=dtype) for _ in range(2)]
    views = []
    for buf in bufs:
        pad = (-buf.data_ptr() % 16) // buf.element_size()
        views.append(buf[pad + offset:pad + offset + n].view(shape))
    assert tda.load_width(*views) == want
    assert tda.load_width(views[0], views[0][:, :, :, :]) == want


def _kernel_dequant(c, s):
    """``csrc/decode_attention.cu``'s dequantization in float32 numpy
    (IEEE round-to-nearest-even, as the kernel's _rn intrinsics): the
    byte in the mantissa of 2^23 less 2^23 + 128, the product with the
    scale, then round-to-nearest-even to bf16 on the bits (what
    cvt.rn.bf16x2 does to a finite float32)."""
    u = (c.astype(np.int32).astype(np.uint32) & 0xFF) ^ 0x80
    f = (u | np.uint32(0x4B000000)).view(np.float32) - np.float32(8388736.0)
    assert np.array_equal(f, c.astype(np.float32))
    p = (f * s).astype(np.float32).view(np.uint32).astype(np.uint64)
    r = (p + 0x7FFF + ((p >> 16) & 1)) & 0xFFFF0000
    return r.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("scales", ["quantized", "binades", "edges"])
def test_kernel_dequantization_is_the_references_bit_for_bit(scales):
    """The kernel's dequantization (no I2F: the byte trick) equals the
    reference's ``dequantize_kv`` (int8 × scale in float32, rounded to
    bf16) and the port's bit for bit for every int8 value at scales from
    quantize_kv of N(0, 1) rows, log-uniform over float32's normal range
    (the reference's CPU flushes subnormal products to zero; quantize_kv's
    least scale is 1e-8 / 127), and at its edges (the least normal scale,
    the largest finite products)."""
    rng = np.random.default_rng(7)
    if scales == "quantized":
        _, sc = ta.quantize_kv(torch.from_numpy(
            rng.normal(size=(1, 1, 4096, 256)).astype(np.float32)))
        s = sc.numpy().reshape(-1)
    elif scales == "binades":
        s = np.exp2(rng.uniform(-126, 120, 4096)).astype(np.float32)
    else:
        s = np.array([2.0 ** -126, 1e-8 / 127, 1 / 127, 1.0,
                      3.0, 2.0 ** 119, np.finfo(np.float32).max / 128],
                     dtype=np.float32)
    c = np.arange(-128, 128, dtype=np.int8)
    cc, ss = np.broadcast_arrays(c[None, :], s[:, None])
    got = _kernel_dequant(cc, ss)
    want = ja.dequantize_kv(jnp.asarray(cc), jnp.asarray(ss))
    np.testing.assert_array_equal(got.view(np.uint32),
                                  _j_np(want).view(np.uint32))
    port = ta.dequantize_kv(torch.from_numpy(cc.copy()),
                            torch.from_numpy(ss.copy()))
    np.testing.assert_array_equal(got.view(np.uint32),
                                  _np(port).view(np.uint32))


# ------------------------------------------------------------- decode step
def _j_decode_logits(cfg, params, cache, tokens, pos):
    """The reference's ``lm_decode_step`` (gemma2 layout) returning the
    logits as well: its own lines, the head's result kept."""
    x = jnp.take(params["embed"], tokens[:, 0], axis=0)[:, None, :].astype(
        cfg.dtype)
    if cfg.embed_scale:
        x = x * jnp.asarray(cfg.d_model ** 0.5, cfg.dtype)

    def pair(x, xs):
        pl_, pg, cl, cg = xs
        x, ncl = jt._decode_block(cfg, pl_, x, cl, pos)
        x, ncg = jt._decode_block(cfg, pg, x, cg, pos)
        return x, (ncl, ncg)
    x, (ncl, ncg) = jax.lax.scan(pair, x, (params["local"], params["global"],
                                          cache["local"], cache["global"]))
    x = j_rms_norm(x, params["ln_final"],
                   zero_centered=cfg.norm_zero_centered)
    logits = j_softcap(x @ params["embed"].T.astype(x.dtype),
                       cfg.final_logit_cap)[:, -1]
    return logits, {"local": ncl, "global": ncg}


def _decode_pair(kv):
    jcfg = dataclasses.replace(j_smoke(), kv_cache_dtype=kv)
    params = jt.lm_init(jcfg, jax.random.PRNGKey(0))
    model = tt.LM(_port_cfg(jcfg), seed=0, device="cpu")
    tt.load_reference_lm_params(model, jax.tree.map(np.asarray, params))
    return jcfg, params, model


def _steps(b, vector, seed=1):
    """STEPS (tokens [b, 1], pos) pairs: a position a row (vector) or one
    for all, past the window-8 ring several times."""
    rng = np.random.default_rng(seed)
    for step in range(STEPS):
        toks = rng.integers(0, 256, (b, 1)).astype(np.int32)
        yield toks, (np.array([step, step + 3, max(step - 4, 0)], np.int32)
                     if vector else np.int32(step))


def _port_pos(pos, vector):
    return _t(pos) if vector else int(pos)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("vector", [False, True])
def test_lm_decode_step_tokens_equal_reference(kv, vector):
    """Each side decoding on its own cache for STEPS steps: the same next
    tokens at every step."""
    jcfg, params, model = _decode_pair(kv)
    b = 3
    jcache = jt.make_cache(jcfg, batch=b, max_len=64)
    tcache = tt.make_cache(model.cfg, batch=b, max_len=64, device="cpu")
    dec = jax.jit(lambda p, c, t, pos: jt.lm_decode_step(jcfg, p, c, t, pos))
    for step, (toks, pos) in enumerate(_steps(b, vector)):
        jn, jcache = dec(params, jcache, jnp.asarray(toks), jnp.asarray(pos))
        tn = tt.lm_decode_step(model, tcache, _t(toks),
                               _port_pos(pos, vector))
        assert tn.dtype == torch.int32 and tuple(tn.shape) == (b, 1)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn),
                                      err_msg=f"step {step}")


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("vector", [False, True])
def test_lm_decode_step_logits_and_cache_match_reference(kv, vector):
    """Every step from the reference's cache (copied into the port's): the
    next tokens equal, the logits and the updated cache within the stated
    bounds. A k or v value that the two sides' float32 noise (~1e-6) puts
    on opposite sides of a bf16 or int8 rounding boundary moves by one
    ulp or one int8 step (1/127 of its row's amax), and that moves the
    layers after it: read up to 8.6e-5 on the logits, 9.4e-5 relative on
    a scale and 1.9e-6 on a bf16 value near zero (this CPU). Bounds: the
    logits 1e-3; bf16 values one bf16 ulp (2^-7 relative) plus 1e-5;
    int8 values one step; scales 1e-3 relative."""
    jcfg, params, model = _decode_pair(kv)
    b = 3
    jcache = jt.make_cache(jcfg, batch=b, max_len=64)
    tcache = tt.make_cache(model.cfg, batch=b, max_len=64, device="cpu")
    logits_fn = jax.jit(lambda p, c, t, pos: _j_decode_logits(jcfg, p, c, t,
                                                              pos))
    dec = jax.jit(lambda p, c, t, pos: jt.lm_decode_step(jcfg, p, c, t, pos))
    for step, (toks, pos) in enumerate(_steps(b, vector)):
        for stack, c in jcache.items():
            for name, w in c.items():
                tcache[stack][name].copy_(_t(_j_np(w)))
        jn, _ = dec(params, jcache, jnp.asarray(toks), jnp.asarray(pos))
        jl, jcache = logits_fn(params, jcache, jnp.asarray(toks),
                               jnp.asarray(pos))
        # the mirror of the reference's step is faithful
        np.testing.assert_array_equal(np.argmax(np.asarray(jl), -1),
                                      np.asarray(jn)[:, 0])
        tn, tl = tt.lm_decode_step(model, tcache, _t(toks),
                                   _port_pos(pos, vector),
                                   return_logits=True)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn),
                                      err_msg=f"step {step}")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-3, err_msg=f"step {step}")
        for stack, c in jcache.items():
            for name, w in c.items():
                got, w = _np(tcache[stack][name]), _j_np(w)
                what = f"step {step} {stack}.{name}"
                if name.endswith("scale"):
                    np.testing.assert_allclose(got, w, rtol=1e-3, atol=0,
                                               err_msg=what)
                elif kv == "int8":
                    assert np.abs(got - w).max() <= 1, what
                else:
                    np.testing.assert_allclose(got, w, rtol=2 ** -7,
                                               atol=1e-5, err_msg=what)


def test_decode_step_on_the_ring_attends_the_rings_extent():
    """Past the window, a local layer attends min(pos + 1, length)
    positions of its ring: the step reads exactly the ring's slots."""
    cfg = _port_cfg(j_smoke())
    model = tt.LM(cfg, seed=3, device="cpu")
    cache = tt.make_cache(cfg, batch=1, max_len=32, device="cpu")
    seen = []
    real = tt.decode_attention

    def spy(q, k, v, cache_len, **kw):
        seen.append((k.shape[2], cache_len.tolist()))
        return real(q, k, v, cache_len, **kw)
    tt.decode_attention = spy
    try:
        for pos in range(12):
            tt.lm_decode_step(model, cache, torch.tensor([[pos + 1]],
                                                         dtype=torch.int32),
                              pos)
    finally:
        tt.decode_attention = real
    local = [(s, n) for i, (s, n) in enumerate(seen) if i % 2 == 0]
    glob = [(s, n) for i, (s, n) in enumerate(seen) if i % 2 == 1]
    assert all(s == cfg.sliding_window for s, _ in local)
    assert [n[0] for _, n in local[::2]] == [min(p + 1, 8)
                                             for p in range(12)]
    assert [n[0] for _, n in glob[::2]] == [p + 1 for p in range(12)]
