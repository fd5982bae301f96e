"""repro_torch ``models.moe`` against the JAX reference
(``repro/models/moe.py``): ``moe_apply`` on the same inputs and weights
(numpy seeds), with and without dropped pairs (capacity factors 0.5,
1.25 and 8), on tied router logits (two experts given equal router
columns), in float32 and in bf16. The routing is compared as integers:
the top-k experts a token (largest first, the lower expert first on a
tie), each pair's rank in its expert's bucket, the kept / dropped mask and
the slot; the reference's are its own lines (``moe.py:49-75``) run in
jnp beside its ``moe_apply``. ``y`` and the aux loss within the stated
tolerances; the layer reads nothing on the host (what a captured decode
step needs); ``moe_init``'s shapes and scales.

Tolerances: float32 ``y`` within 1e-5 (matmuls and the combine's k-term
sum in another order; measured at most 4.8e-7 on a CPU), the aux loss 1e-6
relative. bf16: the reference rounds the combine's products and sums them
in bf16 (its ``segment_sum``), the port sums them in float32 and rounds
once, and XLA fuses the SiLU product in float32. Every rounding of an
expert's output row (a d_ff-term bf16 product) and of the combine (k
products, k - 1 bf16 additions) is at most 2^-8 of S = Σ weight ·
(|h| @ |w_out|) over the token's kept pairs (h the expert's GLU of the
token): within 2^-6 relative plus (k + 1) · 2^-8 · S (measured at most
0.37 of that on a CPU)."""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.set_partition import prefix_sum as j_prefix_sum  # noqa: E402
from repro.models import moe as jm  # noqa: E402
from repro_torch.models import moe as tm  # noqa: E402

# (tokens, d, d_ff, experts, top_k)
SHAPES = [(16, 32, 24, 8, 2), (40, 48, 32, 32, 8), (8, 64, 32, 4, 2),
          (1, 16, 8, 8, 4)]
FACTORS = [0.5, 1.25, 8.0]


def _weights(d, f, e, seed, tie=False):
    rng = np.random.default_rng(seed)
    w = {name: (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)
         for name, shape, fan_in in (
             ("router", (d, e), d), ("w_gate", (e, d, f), d),
             ("w_in", (e, d, f), d), ("w_out", (e, f, d), f))}
    if tie:  # experts 1 and 2 route alike: equal probabilities everywhere
        w["router"][:, 2] = w["router"][:, 1]
        w["router"][:, 5 % e] = w["router"][:, 3 % e]
    return w


def _x(t, d, seed):
    return np.random.default_rng(seed + 100).normal(size=(t, d)).astype(
        np.float32)


def _j_route(router, x, top_k, cap):
    """The reference's dispatch, its own lines (moe.py:51-75)."""
    e = router.shape[1]
    probs = jax.nn.softmax(x.astype(jnp.float32) @ router, axis=-1)
    top_p, top_e = jax.lax.top_k(probs, top_k)
    top_p = top_p / jnp.sum(top_p, axis=-1, keepdims=True)
    flat_e = top_e.reshape(-1)
    onehot = (flat_e[:, None] == jnp.arange(e)[None, :]).astype(jnp.int32)
    within = j_prefix_sum(onehot, axis=0, exclusive=True)
    rank = jnp.sum(onehot * within, axis=1)
    keep = rank < cap
    slot = jnp.where(keep, flat_e * cap + rank, e * cap)
    return dict(top_e=top_e, top_p=top_p, rank=rank, keep=keep, slot=slot)


def _both(w, x, top_k, factor, dtype):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jw = {k: jnp.asarray(v) if k == "router" else jnp.asarray(v).astype(jdt)
          for k, v in w.items()}
    tw = {k: torch.from_numpy(v) if k == "router"
          else torch.from_numpy(v).to(dtype) for k, v in w.items()}
    jy, jaux = jm.moe_apply(jw, jnp.asarray(x).astype(jdt), top_k=top_k,
                            capacity_factor=factor)
    ty, taux = tm.moe_apply(SimpleNamespace(**tw),
                            torch.from_numpy(x).to(dtype), top_k=top_k,
                            capacity_factor=factor)
    return (jw, jy, jaux), (tw, ty, taux)


def _assert_routing_equal(jw, tw, x, top_k, cap, dtype):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = _j_route(jw["router"], jnp.asarray(x).astype(jdt), top_k, cap)
    got = tm.moe_route(tw["router"], torch.from_numpy(x).to(dtype),
                       top_k=top_k, cap=cap)
    for name in ("top_e", "rank", "keep", "slot"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    np.testing.assert_allclose(got["top_p"].numpy(), np.asarray(want["top_p"]),
                               rtol=1e-6, atol=1e-7)
    return got


@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_moe_apply_matches_the_reference_float32(shape, factor):
    t, d, f, e, k = shape
    w, x = _weights(d, f, e, seed=t + e), _x(t, d, seed=t + e)
    cap = tm.capacity(t, k, e, factor)
    assert cap == max(int(factor * k * t / e + 0.5), 1)
    (jw, jy, jaux), (tw, ty, taux) = _both(w, x, k, factor, torch.float32)
    got = _assert_routing_equal(jw, tw, x, k, cap, torch.float32)
    if factor == 0.5 and t > 1:
        assert not bool(got["keep"].all()), "no pair was dropped"
    if factor == 8.0:
        assert bool(got["keep"].all())
    assert ty.dtype == torch.float32 and taux.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("factor", [0.5, 1.25])
def test_tied_router_logits_route_to_the_lower_expert_first(factor):
    """Experts 1 and 2 (and 3 and 5) have equal router columns: every
    token's probabilities for them are equal, and both sides order the
    tie by expert id; with top-1 the lower expert of a tied pair wins."""
    t, d, f, e = 24, 16, 8, 8
    w, x = _weights(d, f, e, seed=7, tie=True), _x(t, d, seed=7)
    for k in (1, 2, 3):
        cap = tm.capacity(t, k, e, factor)
        (jw, jy, jaux), (tw, ty, taux) = _both(w, x, k, factor,
                                               torch.float32)
        got = _assert_routing_equal(jw, tw, x, k, cap, torch.float32)
        assert not bool((got["top_e"] == 2).all(dim=1).any())
        if k == 1:
            assert not bool((got["top_e"] == 2).any())  # 1 always wins
            assert not bool((got["top_e"] == 5).any())  # 3 always wins
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(
        w["router"]), -1)
    assert torch.equal(probs[:, 1], probs[:, 2])


def _combine_magnitude(tw, x, top_k, factor):
    """[T, d]: Σ over a token's kept pairs of its weight times |h| @
    |w_out| (h the expert's SiLU GLU of the token), in float32 from the
    bf16 values: what every rounding of the expert's output row and of
    the combine's partial sums is relative to."""
    f32 = {n: v.float() for n, v in tw.items()}
    xf = torch.from_numpy(x).to(torch.bfloat16).float()
    t, e = xf.shape[0], f32["w_in"].shape[0]
    r = tm.moe_route(f32["router"], xf, top_k=top_k,
                     cap=tm.capacity(t, top_k, e, factor))
    ex = r["top_e"].reshape(-1)
    xr = xf.repeat_interleave(top_k, 0)
    h = torch.nn.functional.silu(torch.einsum(
        "td,tdf->tf", xr, f32["w_gate"][ex])) * torch.einsum(
        "td,tdf->tf", xr, f32["w_in"][ex])
    rows = torch.einsum("tf,tfd->td", h.abs(), f32["w_out"][ex].abs())
    rows = rows * r["keep"][:, None] * r["top_p"].reshape(-1, 1)
    return rows.reshape(t, top_k, -1).sum(1).numpy()


@pytest.mark.parametrize("factor", [0.5, 1.25])
@pytest.mark.parametrize("shape", SHAPES[:3],
                         ids=lambda s: "x".join(map(str, s)))
def test_moe_apply_matches_the_reference_bf16(shape, factor):
    t, d, f, e, k = shape
    w, x = _weights(d, f, e, seed=t + e + 1), _x(t, d, seed=t + e + 1)
    cap = tm.capacity(t, k, e, factor)
    (jw, jy, jaux), (tw, ty, taux) = _both(w, x, k, factor, torch.bfloat16)
    _assert_routing_equal(jw, tw, x, k, cap, torch.bfloat16)
    assert ty.dtype == torch.bfloat16
    want = np.asarray(jy.astype(jnp.float32))
    got = ty.float().numpy()
    tol = 2 ** -6 * np.abs(want) + (k + 1) * 2 ** -8 * _combine_magnitude(
        tw, x, k, factor)
    diff = np.abs(got - want)
    share = np.where(diff == 0, 0.0, diff / np.maximum(tol, 1e-30)).max()
    assert share <= 1.0, share
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def test_dropped_pairs_contribute_nothing():
    """With a capacity of one slot an expert, a token whose every pair was
    dropped gets a zero row, and each kept pair's row is its expert's
    GLU of the token, weighted."""
    t, d, f, e, k = 12, 16, 8, 4, 2
    w, x = _weights(d, f, e, seed=3), _x(t, d, seed=3)
    tw = {n: torch.from_numpy(v) for n, v in w.items()}
    xt = torch.from_numpy(x)
    factor = 1 / 6  # cap = int(12 * 2 / 4 / 6 + 0.5) = 1
    y, _ = tm.moe_apply(SimpleNamespace(**tw), xt, top_k=k,
                        capacity_factor=factor)
    r = tm.moe_route(tw["router"], xt, top_k=k, cap=1)
    keep = r["keep"].reshape(t, k)
    want = torch.zeros_like(y)
    for i in range(t):
        for j in range(k):
            if keep[i, j]:
                ex = int(r["top_e"][i, j])
                h = torch.nn.functional.silu(xt[i] @ tw["w_gate"][ex]) * (
                    xt[i] @ tw["w_in"][ex])
                want[i] += r["top_p"][i, j] * (h @ tw["w_out"][ex])
    assert int(keep.sum()) <= e  # one slot an expert
    assert bool((y[~keep.any(dim=1)] == 0).all())
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-6)


def test_moe_apply_reads_nothing_on_the_host(monkeypatch):
    """No tensor value reaches the host and no tensor is built from host
    data: the layer can run inside a captured CUDA graph."""
    t, d, f, e, k = 8, 16, 8, 8, 4
    w, x = _weights(d, f, e, seed=9), _x(t, d, seed=9)
    tw = SimpleNamespace(**{n: torch.from_numpy(v) for n, v in w.items()})
    xt = torch.from_numpy(x)
    want = tm.moe_apply(tw, xt, top_k=k)

    def refuse(*a, **kw):
        raise AssertionError("host read inside moe_apply")
    for name in ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
                 "__float__", "__index__", "nonzero"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "nonzero", refuse)
    got = tm.moe_apply(tw, xt, top_k=k)
    monkeypatch.undo()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_moe_init_shapes_and_scales():
    g = torch.Generator().manual_seed(0)
    p = tm.moe_init(g, 256, 128, 8, dtype=torch.bfloat16)
    assert {n: (tuple(v.shape), v.dtype) for n, v in p.items()} == {
        "router": ((256, 8), torch.float32),
        "w_gate": ((8, 256, 128), torch.bfloat16),
        "w_in": ((8, 256, 128), torch.bfloat16),
        "w_out": ((8, 128, 256), torch.bfloat16)}
    for name, fan_in in (("router", 256), ("w_gate", 256), ("w_out", 128)):
        std = float(p[name].float().std())
        assert abs(std - fan_in ** -0.5) < 0.03 * fan_in ** -0.5, name
    jp = jm.moe_init(jax.random.PRNGKey(0), 256, 128, 8, jnp.bfloat16)
    assert {n: tuple(v.shape) for n, v in jp.items()} == {
        n: tuple(v.shape) for n, v in p.items()}
