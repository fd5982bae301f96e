"""repro_torch flash attention against the JAX reference: the port's
kernel wrapper ``flash_attention_bhsd`` (on the CPU its plain twin, the
blocked scan) against the reference model's
``flash_attention`` and against its Pallas kernel ``flash_attention_bhsd``
in interpret mode, on the parameter grid of ``tests/test_flash_kernel.py``
(causal or not, window 16, cap 50, three block pairs, dh 16/64/128 in
float32 and bf16, GQA 4:2) plus a ``q_offset`` case, at the reference's
own tolerances: rtol = atol = 2e-5 in float32, 2e-2 in bf16. Inputs are
numpy arrays from a seed, handed to both."""
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
