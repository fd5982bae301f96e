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
Inputs are numpy arrays from a seed, handed to both.
In bf16 at gemma2's heads, the gradients of ``FlashAttention`` (whose
residual is the float32 out, as the reference's) and an emulation of the
backward kernels' rounding lie within the card checks' tolerance of the
reference's."""
import functools

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


# the card checks' bf16 backward tolerance (tests/test_torch_gpu.py and
# chip_smoke.py BWD_RTOL / BWD_ATOL): one bf16 ulp of the value plus 1e-3
# of the gradient's largest magnitude
BWD_RTOL, BWD_ATOL = 2 ** -7, 1e-3


def _emulated_bf16_bwd(q, k, v, dout, delta, lse, *, window, cap, split_p,
                       split_ds):
    """(dq, dk, dv) of the bf16 tensor-core backward kernels' rounding,
    emulated over whole rows: float32 scores of the bf16 q and k (exact
    products; the kernels' Kahan-summed k-steps), scaled and capped;
    p = exp(s - lse), dp = dout v^T, ds = p (dp - delta) (1 - t^2) in
    float32; P (for dV) and dS (for dQ and dK) rounded to bf16 as
    hi = bf16(x) and, when split, lo = bf16(x - hi), each half multiplied
    by a bf16 operand (exact products, sums in float64); each gradient
    rounded once to bf16. q, dout [B,H,S,dh], k, v [B,Hkv,S,dh] bf16;
    delta, lse [B,H,S] float32."""
    b, h, sq, dh = q.shape
    hkv = k.shape[1]
    g = h // hkv
    scale = dh ** -0.5
    kf, vf = (t.double().repeat_interleave(g, dim=1) for t in (k, v))
    s = (q.double() @ kf.transpose(-1, -2)).float() * scale
    s = cap * torch.tanh(s / cap)
    i = torch.arange(sq)
    live = i[:, None] >= i[None, :]
    if window is not None:
        live &= (i[:, None] - i[None, :]) < window
    p = torch.where(live, torch.exp(s - lse[..., None]), 0.0)
    dp = (dout.double() @ vf.transpose(-1, -2)).float()
    t = s / cap
    ds = torch.where(live, p * (dp - delta[..., None]) * (1.0 - t * t), 0.0)

    def rounded(x, split):
        hi = x.bfloat16().float()
        lo = (x - hi).bfloat16().double() if split else 0.0
        return hi.double() + lo

    pr, dsr = rounded(p, split_p), rounded(ds, split_ds)
    dq = (dsr @ kf).float() * scale
    dk = ((dsr.transpose(-1, -2) @ q.double()).float() * scale).reshape(
        b, hkv, g, sq, dh).sum(2)
    dv = (pr.transpose(-1, -2) @ dout.double()).float().reshape(
        b, hkv, g, sq, dh).sum(2)
    return [t.bfloat16().float().numpy() for t in (dq, dk, dv)]


def _share_of_bwd_tol(got, want):
    return max(float((np.abs(gt - w) / (BWD_ATOL * np.abs(w).max()
                                         + BWD_RTOL * np.abs(w))).max())
               for gt, w in zip(got, want))


def _bf16_case(q_scale):
    """gemma2's heads at 512 tokens: numpy inputs and their bf16 tensors."""
    q, k, v, dout = _inputs(9, h=16, hkv=8, sq=512, skv=512, dh=256,
                            q_scale=q_scale)
    return (q, k, v), [torch.from_numpy(a).bfloat16()
                       for a in (q, k, v, dout)]


@functools.lru_cache(maxsize=None)
def _reference_bf16_grads(window, q_scale):
    """jax.grad of the reference model's flash_attention (its custom VJP)
    on the bf16 inputs of ``_bf16_case``, as float32 numpy arrays."""
    (q, k, v), (*_, tdo) = _bf16_case(q_scale)
    kw = dict(causal=True, window=window, logit_cap=50.0)

    def loss(q, k, v):
        out = ja.flash_attention(q, k, v, **kw).astype(jnp.float32)
        return jnp.sum(out * jnp.asarray(tdo.float().numpy()))
    return [np.asarray(t.astype(jnp.float32)) for t in jax.grad(
        loss, argnums=(0, 1, 2))(*(jnp.asarray(a).astype(jnp.bfloat16)
                                   for a in (q, k, v)))]


@pytest.mark.parametrize("q_scale", [8.0, 32.0])
@pytest.mark.parametrize("window", [None, 64])
def test_bf16_function_gradients_hold_the_card_tolerance(window, q_scale):
    """``FlashAttention`` on bf16 q, k, v through the twins (gemma2's heads
    at 512 tokens, as in the test below): its gradients lie within the
    card's backward tolerance of the reference model's custom-VJP
    gradients, because its residual is the forward's float32 out, as in
    the reference, and delta = sum(dout * out) is taken from it. Read:
    0.48-0.71 of the tolerance (the largest of dq, dk, dv in a case:
    0.64, 0.61, 0.66, 0.71). With the residual in bf16, as the port kept
    it before (commit e31c949), the same gradients read 3.1-6.8 on dq and
    dk (dq 3.1-4.4, dk 3.9-6.8; dv, which takes no delta, as now)."""
    _, (tq, tk, tv, tdo) = _bf16_case(q_scale)
    q, k, v = (t.clone().requires_grad_() for t in (tq, tk, tv))
    out = tfa.FlashAttention.apply(q, k, v, True, window, 50.0, 0, 512)
    assert out.dtype == torch.bfloat16
    (out.float() * tdo.float()).sum().backward()
    got = [t.grad.float().numpy() for t in (q, k, v)]
    assert _share_of_bwd_tol(got, _reference_bf16_grads(window, q_scale)
                             ) <= 1.0


def test_function_keeps_the_float32_output_and_returns_its_rounding():
    """The residual ``FlashAttention`` saves for the backward is the
    forward's float32 out (as the reference's ``fwd`` keeps it); the
    output it returns is that out rounded to q's dtype, bit for bit the
    output of the forward without a gradient, whose scan and single cast
    are those of the forward before the residual changed."""
    q, k, v, _ = _inputs(10, h=4, hkv=2, sq=64, skv=64, dh=32, q_scale=8.0)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    kw = dict(causal=True, window=24, logit_cap=50.0, kv_block=16)
    qg = tq.clone().requires_grad_()
    out = tfa.flash_attention_bhsd(qg, tk, tv, **kw)
    _, _, _, saved_out, saved_lse = out.grad_fn.saved_tensors
    assert saved_out.dtype == torch.float32 and saved_out.shape == q.shape
    assert saved_lse.dtype == torch.float32
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, saved_out.to(torch.bfloat16))
    with torch.no_grad():
        assert torch.equal(out, tfa.flash_attention_bhsd(tq, tk, tv, **kw))
    want = ta.flash_attention_plain(tq, tk, tv, out_dtype=torch.float32,
                                    **kw)
    assert torch.equal(saved_out, want)
    with pytest.raises(ValueError, match="float32 out"):
        tfa.flash_attention_bwd(tq, tk, tv, out, saved_lse, out)


@pytest.mark.parametrize("q_scale", [8.0, 32.0])
@pytest.mark.parametrize("window", [None, 64])
def test_bf16_bwd_split_holds_the_card_tolerance(window, q_scale):
    """gemma2's heads (16 over 8, dh 256, cap 50) at 512 tokens, bf16,
    q x 8 (the cap acts) and q x 32 (it saturates): the backward kernels'
    design, P and dS each split into bf16 hi and lo halves, stays within
    the card's tolerance (one bf16 ulp + 1e-3 of the largest value) of
    the reference model's custom-VJP gradients (read: 0.60-0.79 of it,
    the largest of dq, dk, dv in each case).
    A single bf16 rounding of dS does not hold it (1.2-2.0); a single
    rounding of P reads 0.88-1.13 on dV, above the half of the tolerance
    under which the design would drop P's split. The emulation takes
    delta = sum(dout * out) of the float32 out, as the reference's
    backward and the port's ``FlashAttention`` do (their residual is the
    float32 out), so that only the kernels' rounding of P and dS is
    compared. Delta taken from the bf16 out instead is a planted fault
    here: the same design then reads 3.9-6.9 of the tolerance on dq and
    dk."""
    _, (tq, tk, tv, tdo) = _bf16_case(q_scale)
    kw = dict(causal=True, window=window, logit_cap=50.0)
    want = _reference_bf16_grads(window, q_scale)
    out, lse = ta.flash_attention_plain(tq.float(), tk.float(), tv.float(),
                                        return_lse=True, **kw)
    delta = (tdo.float() * out).sum(-1)
    emu = dict(window=window, cap=50.0)
    split = _emulated_bf16_bwd(tq, tk, tv, tdo, delta, lse, split_p=True,
                               split_ds=True, **emu)
    assert _share_of_bwd_tol(split, want) <= 1.0
    single_ds = _emulated_bf16_bwd(tq, tk, tv, tdo, delta, lse,
                                   split_p=True, split_ds=False, **emu)
    assert _share_of_bwd_tol(single_ds[:2], want[:2]) > 1.0
    single_p = _emulated_bf16_bwd(tq, tk, tv, tdo, delta, lse,
                                  split_p=False, split_ds=True, **emu)
    assert _share_of_bwd_tol(single_p[2:], want[2:]) > 0.5
    out_bf16 = ta.flash_attention_plain(tq, tk, tv, **kw)
    port_delta = (tdo.float() * out_bf16.float()).sum(-1)
    port = _emulated_bf16_bwd(tq, tk, tv, tdo, port_delta, lse,
                              split_p=True, split_ds=True, **emu)
    assert _share_of_bwd_tol(port[:2], want[:2]) > 1.0
