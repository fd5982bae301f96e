"""repro_torch flash attention against the JAX reference: the port's
kernel wrapper ``flash_attention_bhsd`` (on the CPU its plain twin, the
blocked scan) against the reference model's
``flash_attention`` and against its Pallas kernel ``flash_attention_bhsd``
in interpret mode, on the parameter grid of ``tests/test_flash_kernel.py``
(causal or not, window 16, cap 50, three block pairs, dh 16/64/128 in
float32 and bf16, GQA 4:2) plus a ``q_offset`` case, at the reference's
own tolerances: rtol = atol = 2e-5 in float32, 2e-2 in bf16. Inputs are
numpy arrays from a seed, handed to both. A test-local emulation of the
bf16 card kernel's rounding of P (split into bf16 hi and lo halves, each
multiplied by V) is held within the card checks' one-bf16-ulp tolerance
of the reference model at gemma2's head shapes; a single bf16 rounding of
P is shown to exceed it."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention_bhsd as j_kernel  # noqa: E402
from repro.models import attention as ja  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402

TOL = {np.float32: 2e-5, "bf16": 2e-2}
# the card checks' bf16 tolerance (tests/test_torch_gpu.py FLASH_TOL,
# chip_smoke.py FLASH_RTOL / FLASH_ATOL): one bf16 ulp of the output plus
# float32 sums that cancel near zero
BF16_RTOL, BF16_ATOL = 2 ** -7, 1e-5


def _qkv(seed, b=1, h=2, hkv=1, sq=64, skv=64, dh=32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, sq, dh)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, dh)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, dh)).astype(np.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a).astype(dtype)


@pytest.mark.parametrize("causal,window,cap", [
    (True, None, None), (False, None, None), (True, 16, None),
    (True, None, 50.0)])
@pytest.mark.parametrize("bq,bk", [(16, 16), (32, 64), (64, 32)])
def test_flash_matches_reference_model_and_kernel(causal, window, cap, bq,
                                                  bk):
    q, k, v = _qkv(0)
    kw = dict(causal=causal, window=window, logit_cap=cap)
    got = tfa.flash_attention_bhsd(_t(q), _t(k), _t(v), kv_block=bk, **kw).numpy()
    want_model = ja.flash_attention(_j(q), _j(k), _j(v), kv_block=bk, **kw)
    want_kernel = j_kernel(_j(q), _j(k), _j(v), bq=bq, bk=bk, **kw)
    np.testing.assert_allclose(got, np.asarray(want_model), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(want_kernel), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("dh", [16, 64, 128])
@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_flash_shape_dtype_sweep(dh, dtype):
    q, k, v = _qkv(1, b=2, h=2, hkv=2, sq=32, skv=64, dh=dh)
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    got = tfa.flash_attention_bhsd(_t(q, tdt), _t(k, tdt), _t(v, tdt),
                                   kv_block=16)
    assert got.dtype == tdt
    want = j_kernel(_j(q, jdt), _j(k, jdt), _j(v, jdt), bq=16, bk=16)
    want_model = ja.flash_attention(_j(q, jdt), _j(k, jdt), _j(v, jdt),
                                    kv_block=16)
    tol = TOL[dtype]
    for w in (want, want_model):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   rtol=tol, atol=tol)


def test_flash_gqa_matches_reference():
    q, k, v = _qkv(2, b=2, h=4, hkv=2, sq=32, skv=32, dh=16)
    got = tfa.flash_attention_bhsd(_t(q), _t(k), _t(v), kv_block=16).numpy()
    np.testing.assert_allclose(
        got, np.asarray(ja.flash_attention(_j(q), _j(k), _j(v), kv_block=16)),
        rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        got, np.asarray(j_kernel(_j(q), _j(k), _j(v), bq=16, bk=16)),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window", [None, 24])
def test_flash_q_offset_matches_reference(window):
    """A chunk of 32 queries at positions 32..63 over 64 keys (chunked
    prefill), with and without a window."""
    q, k, v = _qkv(3, b=1, h=4, hkv=2, sq=32, skv=64, dh=16)
    kw = dict(causal=True, window=window, logit_cap=50.0, kv_block=16,
              q_offset=32)
    got = tfa.flash_attention_bhsd(_t(q), _t(k), _t(v), **kw).numpy()
    want = ja.flash_attention(_j(q), _j(k), _j(v), **kw)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


def test_flash_twin_returns_reference_lse():
    """The scan's (out, lse) pair, the state the backward kernel will
    read, equals the reference's."""
    q, k, v = _qkv(4, b=1, h=4, hkv=2, sq=32, skv=32, dh=16)
    scale = 16 ** -0.5
    kw = dict(sq=32, kv_block=16, q_offset=0, causal=True, window=8,
              logit_cap=50.0)
    qg = ta._group_q(_t(q), 2) * scale
    kb = torch.movedim(_t(k).reshape(1, 2, 2, 16, 16), 2, 0)
    vb = torch.movedim(_t(v).reshape(1, 2, 2, 16, 16), 2, 0)
    out, lse = ta._flash_fwd_scan(qg, kb, vb, **kw)
    jqg = ja._group_q(_j(q), 2) * scale
    jkb = jnp.moveaxis(_j(k).reshape(1, 2, 2, 16, 16), 2, 0)
    jvb = jnp.moveaxis(_j(v).reshape(1, 2, 2, 16, 16), 2, 0)
    jout, jlse = ja._flash_fwd_scan(jqg, jkb, jvb, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("sq,q_offset,window", [(16, 0, 5), (8, 20, None)])
def test_blk_mask_matches_reference(sq, q_offset, window):
    for j in range(3):
        got = ta._blk_mask(sq, 8, j, q_offset, True, window).numpy()
        want = ja._blk_mask(sq, 8, j, q_offset, True, window)
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_rope_matches_reference(dtype):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 3, 40, 16)).astype(np.float32)
    pos = np.arange(40)
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    got = ta.rope(_t(x, tdt), torch.from_numpy(pos)[None, None, :], 10000.0)
    want = ja.rope(_j(x, jdt), jnp.asarray(pos)[None, None, :], 10000.0)
    assert got.dtype == tdt
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_wrapper_refuses_mismatched_shapes():
    q, k, v = _qkv(6, h=3, hkv=2, dh=16)
    with pytest.raises(ValueError, match="H % Hkv"):
        tfa.flash_attention_bhsd(_t(q), _t(k), _t(v))
    with pytest.raises(ValueError, match="k, v"):
        tfa.flash_attention_bhsd(_t(q), _t(k), _t(v)[:, :, :32])


def _emulated_bf16_kernel(q, k, v, *, window, cap, split):
    """The bf16 kernel's rounding of P, emulated in float32 over the whole
    row at once: scores of the bf16 q (scaled by dh^-0.5) and k, softcap,
    mask, p = exp(s - max) in float32 and l its float32 sum; P rounded to
    bf16 as hi = bf16(p) and, with ``split``, lo = bf16(p - hi), each half
    multiplied by the bf16 V (exact products, float32 sums); out = P V / l
    rounded to bf16. q [B,H,S,dh], k, v [B,Hkv,S,dh] bf16 torch tensors."""
    b, h, sq, dh = q.shape
    g = h // k.shape[1]
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    sc = torch.einsum("bhqd,bhkd->bhqk", q.float() * dh ** -0.5, kf)
    sc = cap * torch.tanh(sc / cap)
    i = torch.arange(sq)
    live = (i[:, None] >= i[None, :])
    if window is not None:
        live &= (i[:, None] - i[None, :]) < window
    sc = torch.where(live, sc, torch.tensor(-1e30))
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    hi = p.bfloat16().float()
    pv = torch.einsum("bhqk,bhkd->bhqd", hi.double(), vf.double())
    if split:
        lo = (p - hi).bfloat16().float()
        pv = pv + torch.einsum("bhqk,bhkd->bhqd", lo.double(), vf.double())
    return (pv.float() / l).bfloat16()


@pytest.mark.parametrize("window", [None, 64])
def test_bf16_p_split_holds_the_card_tolerance(window):
    """gemma2's heads (16 over 8, dh 256, cap 50) at 512 tokens, q x 8 so
    that the cap acts: the hi/lo split of P stays within one bf16 ulp
    (+ 1e-5) of the reference model's attention; one bf16 rounding of P
    does not (errors of up to 2^-9 of sum p|v| on outputs near zero)."""
    q, k, v = _qkv(9, b=1, h=16, hkv=8, sq=512, skv=512, dh=256)
    q = q * 8
    tq, tk, tv = (_t(a, torch.bfloat16) for a in (q, k, v))
    want = np.asarray(ja.flash_attention(
        _j(q, jnp.bfloat16), _j(k, jnp.bfloat16), _j(v, jnp.bfloat16),
        causal=True, window=window, logit_cap=50.0).astype(jnp.float32))
    bound = BF16_ATOL + BF16_RTOL * np.abs(want)
    kw = dict(window=window, cap=50.0)
    split = _emulated_bf16_kernel(tq, tk, tv, split=True, **kw).float()
    single = _emulated_bf16_kernel(tq, tk, tv, split=False, **kw).float()
    assert (np.abs(split.numpy() - want) <= bound).all()
    assert (np.abs(single.numpy() - want) > bound).any()
