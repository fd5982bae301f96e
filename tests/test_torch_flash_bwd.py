"""repro_torch flash attention backward against the JAX reference: the
gradients of the port's ``FlashAttention`` (on the CPU its twins, the
blocked forward scan with lse and ``_flash_bwd_scan``) against the
reference's Pallas ``flash_attention_bwd`` in interpret mode and against
``jax.grad`` of the reference model's ``flash_attention`` (its
custom VJP), on the grid of ``tests/test_flash_bwd_kernel.py`` (causal or
not, window 16, cap 50, two block pairs, rectangular Sq != Skv) plus GQA
4:2, a ``q_offset`` case and queries scaled by 8 so that the cap acts.
Tolerance: rtol = atol = 2e-5 in float32 (the sums run in another order;
the reference kernel's own test allows 2e-4 against a dense oracle).
Queries scaled by 32, where the cap saturates, are held with both
packages against a float64 witness within 2e-5 of each gradient's
largest magnitude.
Inputs are numpy arrays from a seed, handed to both."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention_bwd as j_bwd  # noqa: E402
from repro.models import attention as ja  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402

TOL = 2e-5


def _inputs(seed, b=1, h=2, hkv=1, sq=32, skv=32, dh=16, q_scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, sq, dh)).astype(np.float32) * q_scale,
            rng.normal(size=(b, hkv, skv, dh)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, dh)).astype(np.float32),
            rng.normal(size=(b, h, sq, dh)).astype(np.float32))  # dout


def _port_grads(q, k, v, dout, **kw):
    """(out, dq, dk, dv) of the port's differentiable flash attention."""
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention_bhsd(qt, kt, vt, **kw)
    (out * torch.from_numpy(dout)).sum().backward()
    return [t.detach().numpy() for t in (out, qt.grad, kt.grad, vt.grad)]


def _model_grads(q, k, v, dout, **kw):
    """jax.grad of the reference model's flash_attention (custom VJP)."""
    def loss(q, k, v):
        return jnp.sum(ja.flash_attention(q, k, v, **kw) * dout)
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _kernel_grads(q, k, v, dout, *, bq, bk, **kw):
    """The reference's Pallas backward on flat heads, k and v repeated per
    query head as its wrapper does, and dk / dv summed over each group."""
    b, h, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = h // hkv
    rep = [np.repeat(a, g, axis=1).reshape(b * h, skv, dh) for a in (k, v)]
    dq, dk, dv = j_bwd(jnp.asarray(q.reshape(b * h, sq, dh)),
                       jnp.asarray(rep[0]), jnp.asarray(rep[1]),
                       jnp.asarray(dout.reshape(b * h, sq, dh)), bq=bq,
                       bk=bk, **kw)
    return [np.asarray(dq).reshape(q.shape)] + [
        np.asarray(t).reshape(b, hkv, g, skv, dh).sum(2) for t in (dk, dv)]


def _close(got, want, tol=TOL):
    for gt, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(gt, w, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("causal,window,cap", [
    (True, None, None), (False, None, None), (True, 16, None),
    (True, None, 50.0)])
@pytest.mark.parametrize("bq,bk", [(16, 16), (32, 16)])
def test_flash_bwd_matches_reference_kernel_and_model(causal, window, cap,
                                                      bq, bk):
    q, k, v, dout = _inputs(0)
    kw = dict(causal=causal, window=window, logit_cap=cap)
    _, *got = _port_grads(q, k, v, dout, kv_block=bk, **kw)
    _close(got, _kernel_grads(q, k, v, dout, bq=bq, bk=bk, **kw))
    _close(got, _model_grads(q, k, v, dout, kv_block=bk, **kw))


def test_flash_bwd_rectangular():
    q, k, v, dout = _inputs(1, sq=32, skv=64)
    _, *got = _port_grads(q, k, v, dout, causal=False, kv_block=16)
    _close(got, _kernel_grads(q, k, v, dout, causal=False, bq=16, bk=16))
    _close(got, _model_grads(q, k, v, dout, causal=False, kv_block=16))
    assert got[0].shape == q.shape and got[1].shape == k.shape


@pytest.mark.parametrize("window", [None, 16])
def test_flash_bwd_gqa_and_active_cap(window):
    """GQA 4:2 with queries scaled by 8: scores about N(0, 8^2), as at
    gemma2's head shapes in the card checks, where the (1 - t^2) factor of
    cap 50 is 0.8 at three sigma."""
    q, k, v, dout = _inputs(2, b=2, h=4, hkv=2, sq=64, skv=64, dh=16,
                            q_scale=8.0)
    kw = dict(causal=True, window=window, logit_cap=50.0)
    _, *got = _port_grads(q, k, v, dout, kv_block=16, **kw)
    _close(got, _kernel_grads(q, k, v, dout, bq=16, bk=16, **kw))
    _close(got, _model_grads(q, k, v, dout, kv_block=16, **kw))


def _witness_grads(q, k, v, dout, *, window, logit_cap, cap_factor=True):
    """(dq, dk, dv) of dense causal attention in float64 by autograd, the
    witness both float32 sides are held against; ``cap_factor=False``
    plants the fault of a backward without the cap's (1 - t^2) factor."""
    qt, kt, vt = (torch.from_numpy(a).double().requires_grad_()
                  for a in (q, k, v))
    sq, dh, skv = q.shape[2], q.shape[3], k.shape[2]
    g = q.shape[1] // k.shape[1]
    s = qt @ kt.repeat_interleave(g, 1).transpose(-1, -2) * dh ** -0.5
    capped = logit_cap * torch.tanh(s / logit_cap)
    s = capped if cap_factor else s + (capped - s).detach()
    i, j = torch.arange(sq)[:, None], torch.arange(skv)[None]
    live = (j <= i) & ((i - j < window) if window else True)
    p = torch.softmax(s.masked_fill(~live, float("-inf")), -1)
    out = p @ vt.repeat_interleave(g, 1)
    (out * torch.from_numpy(dout).double()).sum().backward()
    return [t.grad.numpy() for t in (qt, kt, vt)]


def _err_over_max(got, want):
    return max(float(np.abs(gt - w).max() / np.abs(w).max())
               for gt, w in zip(got, want))


@pytest.mark.parametrize("window", [None, 16])
def test_flash_bwd_saturated_cap_against_float64_witness(window):
    """GQA 4:2 with queries scaled by 32: scores about N(0, 32^2), where
    cap 50 saturates. dk reaches 60, and two float32 summation orders then
    differ by up to 1.2e-4 in elements near 0, beyond the elementwise
    2e-5 of the other cases. A float64 dense witness shows that this is
    float32 rounding on both sides: the port, the reference's Pallas
    backward and its custom VJP each lie within 2e-5 of each gradient's
    largest magnitude of the witness (read on seeds 2, 6 and 7: port
    2.9e-6, reference 3.0e-6 at most), and the fault of a backward
    without the (1 - t^2) factor lies at about 1 (read 0.95-1.49)."""
    q, k, v, dout = _inputs(2, b=2, h=4, hkv=2, sq=64, skv=64, dh=16,
                            q_scale=32.0)
    kw = dict(causal=True, window=window, logit_cap=50.0)
    _, *got = _port_grads(q, k, v, dout, kv_block=16, **kw)
    wit = _witness_grads(q, k, v, dout, window=window, logit_cap=50.0)
    assert _err_over_max(got, wit) <= TOL
    assert _err_over_max(_kernel_grads(q, k, v, dout, bq=16, bk=16, **kw),
                         wit) <= TOL
    assert _err_over_max(_model_grads(q, k, v, dout, kv_block=16, **kw),
                         wit) <= TOL
    fault = _witness_grads(q, k, v, dout, window=window, logit_cap=50.0,
                           cap_factor=False)
    assert _err_over_max(fault, wit) > 100 * TOL


def test_flash_bwd_q_offset_matches_reference_model():
    """A chunk of 32 queries at positions 32..63 over 64 keys."""
    q, k, v, dout = _inputs(3, h=4, hkv=2, sq=32, skv=64)
    kw = dict(causal=True, window=24, logit_cap=50.0, kv_block=16,
              q_offset=32)
    _, *got = _port_grads(q, k, v, dout, **kw)
    _close(got, _model_grads(q, k, v, dout, **kw))


def test_bwd_twin_equals_reference_bwd_scan():
    """``flash_attention_bwd`` on CPU tensors (the twin) from the
    reference forward's own (out, lse) equals the reference's
    ``_bwd_impl`` through the custom VJP's vjp."""
    q, k, v, dout = _inputs(4, h=4, hkv=2, sq=32, skv=32, q_scale=8.0)
    kw = dict(causal=True, window=8, logit_cap=50.0)
    out, lse = ta.flash_attention_plain(*(torch.from_numpy(a)
                                          for a in (q, k, v)),
                                        kv_block=16, return_lse=True, **kw)
    got = tfa.flash_attention_bwd(*(torch.from_numpy(a) for a in (q, k, v)),
                                  out, lse, torch.from_numpy(dout),
                                  kv_block=16, **kw)
    _, vjp = jax.vjp(lambda q, k, v: ja.flash_attention(
        q, k, v, kv_block=16, **kw), *(jnp.asarray(a) for a in (q, k, v)))
    _close([t.numpy() for t in got], [np.asarray(t)
                                      for t in vjp(jnp.asarray(dout))])


def test_function_forward_equals_plain_forward_and_lse():
    q, k, v, dout = _inputs(5, h=4, hkv=2)
    kw = dict(causal=True, window=8, logit_cap=50.0, kv_block=16)
    out, *_ = _port_grads(q, k, v, dout, **kw)
    want = tfa.flash_attention_bhsd(*(torch.from_numpy(a)
                                      for a in (q, k, v)), **kw)
    np.testing.assert_array_equal(out, want.numpy())
    _, lse = ta.flash_attention_plain(*(torch.from_numpy(a)
                                        for a in (q, k, v)),
                                      return_lse=True, **kw)
    assert lse.shape == (1, 4, 32) and lse.dtype == torch.float32


def test_cpu_path_launches_no_kernel_and_keeps_no_graph_of_the_scan():
    """On CPU tensors the Function runs the twins: no kernel counter moves,
    and the output's autograd node is the Function itself, not a record
    of the blocked scan."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(6))
    before = launch_counts()
    q.requires_grad_()
    out = tfa.flash_attention_bhsd(q, k, v, kv_block=16)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.sum().backward()
    assert launch_counts() == before


def test_bwd_refuses_mismatched_shapes():
    q, k, v, dout = (torch.from_numpy(a) for a in _inputs(7))
    out, lse = ta.flash_attention_plain(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="lse"):
        tfa.flash_attention_bwd(q, k, v, out, lse[..., :8], dout)
    with pytest.raises(ValueError, match="dout"):
        tfa.flash_attention_bwd(q, k, v, out, lse, dout[:, :, :8])
