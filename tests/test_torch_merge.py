"""repro_torch chunked_merge Ordering against the JAX reference: the chunk
sort's plain twin (pairs and keys only, radix_bits 2/4/8) against the
reference's radix_sort_chunks kernels in Pallas interpret mode, the
fused-merge twin against the reference's fused_merge_rounds (fan-in 2 and
4, keys only and pairs, fully fused, partly fused and with no rung that
fits), the plain merges against merge_sorted / merge_sorted_k, and
stable_sort_by_key / edge_ordering under chunked_merge, packed and
two-pass across the 32767/32768 boundary, with kernel routing on and off,
against the reference and against the xla_sort strategy. Integer outputs
must be bit-identical."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import COO, random_coo  # noqa: E402
from repro.core import ordering as jo  # noqa: E402
from repro.kernels.merge import fused_merge_rounds as j_fused  # noqa: E402
from repro.kernels.radix_sort import (radix_sort_chunks,  # noqa: E402
                                      radix_sort_chunks_keys)
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core import ordering as to  # noqa: E402
from repro_torch.kernels import merge as tm  # noqa: E402
from repro_torch.kernels import radix_sort as trs  # noqa: E402

SEN = 0x7FFFFFFF
N, CHUNK, KEY_BITS = 512, 128, 12


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _chunk_input():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1 << KEY_BITS, N).astype(np.int32)
    keys[rng.random(N) < 0.3] = 7  # many ties: stability shows
    return keys, (np.arange(N, dtype=np.int32) * 5 + 3)


@pytest.fixture(scope="module")
def j_chunk_sorts():
    """The reference's chunk-sort kernels, once per (radix_bits, pairs)."""
    keys, vals = _chunk_input()
    out = {}
    for rb in (2, 4, 8):
        out[rb, True] = radix_sort_chunks(jnp.asarray(keys), jnp.asarray(vals),
                                          chunk=CHUNK, key_bits=KEY_BITS,
                                          radix_bits=rb)
        out[rb, False] = (radix_sort_chunks_keys(
            jnp.asarray(keys), chunk=CHUNK, key_bits=KEY_BITS, radix_bits=rb),
            None)
    return out


@pytest.mark.parametrize("rb", [2, 4, 8])
@pytest.mark.parametrize("pairs", [True, False])
def test_chunk_sort_twin_matches_reference_kernel(j_chunk_sorts, rb, pairs):
    keys, vals = _chunk_input()
    jk, jv = j_chunk_sorts[rb, pairs]
    if pairs:
        tk, tv = trs.radix_sort_chunks(_t(keys), _t(vals), CHUNK, KEY_BITS, rb)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    else:
        tk = trs.radix_sort_chunks_keys(_t(keys), CHUNK, KEY_BITS, rb)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    fn_k, fn_v = trs.make_chunk_sort_fn(rb)(_t(keys), _t(vals) if pairs
                                            else None, CHUNK, KEY_BITS)
    np.testing.assert_array_equal(fn_k.numpy(), np.asarray(jk))
    assert (fn_v is None) == (not pairs)


def _runs(n, run, seed):
    """``n`` keys in sorted runs of ``run``, with ties inside and across
    runs, and a SENTINEL-clipped tail value."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 40, n).astype(np.int32)
    keys[-n // 8:] = 1000  # the clipped sentinel bound, as the sorter sees it
    keys = np.sort(keys.reshape(-1, run), axis=1).reshape(-1)
    return keys, np.arange(n, dtype=np.int32)


# (n, run, max_block): fully fused, partly fused (plain rungs continue),
# and no rung that fits (a no-op)
MERGE_CASES = [(1024, 64, 65536), (1024, 64, 256), (512, 128, 128)]


@pytest.fixture(scope="module")
def j_merges():
    out = {}
    for n, run, mb in MERGE_CASES:
        keys, vals = _runs(n, run, seed=n + run + mb)
        for fan in (2, 4):
            for pairs in (True, False):
                out[n, run, mb, fan, pairs] = j_fused(
                    jnp.asarray(keys), jnp.asarray(vals) if pairs else None,
                    run, max_block=mb, fan_in=fan)
    return out


@pytest.mark.parametrize("n,run,mb", MERGE_CASES)
@pytest.mark.parametrize("fan", [2, 4])
@pytest.mark.parametrize("pairs", [True, False])
def test_fused_merge_twin_matches_reference_kernel(j_merges, n, run, mb, fan,
                                                   pairs):
    keys, vals = _runs(n, run, seed=n + run + mb)
    jk, jv, jrun = j_merges[n, run, mb, fan, pairs]
    tk, tv, trun = tm.fused_merge_rounds(_t(keys), _t(vals) if pairs else None,
                                         run, max_block=mb, fan_in=fan)
    assert trun == jrun == run * int(np.prod(
        tm._round_fan_ins(n, run, mb, fan)))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    if pairs:
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    else:
        assert tv is None and jv is None
    # the plain ladder continues from new_run to the whole ladder's result,
    # the stable sort of the array
    lk, lv = to.merge_rounds(_t(keys), _t(vals) if pairs else None, run,
                             merge_fn=tm.make_merge_fn(fan), fan_in=fan)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(lk.numpy(), keys[order])
    if pairs:
        np.testing.assert_array_equal(lv.numpy(), vals[order])


@pytest.mark.parametrize("la,lb", [(37, 21), (64, 64), (1, 9)])
def test_merge_sorted_matches_reference(la, lb):
    rng = np.random.default_rng(la * lb)
    a = np.sort(rng.integers(0, 12, la)).astype(np.int32)
    b = np.sort(rng.integers(0, 12, lb)).astype(np.int32)
    av = np.arange(la, dtype=np.int32)
    bv = 100 + np.arange(lb, dtype=np.int32)
    jk, jv = jo.merge_sorted(*map(jnp.asarray, (a, av, b, bv)))
    tk, tv = to.merge_sorted(*map(_t, (a, av, b, bv)))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("k", [2, 3, 4])
def test_merge_sorted_k_matches_reference(k):
    keys, vals = _runs(k * 32, 32, seed=k)
    jk, jv = jax.jit(jo.merge_sorted_k)(jnp.asarray(keys).reshape(k, 32),
                                        jnp.asarray(vals).reshape(k, 32))
    tk, tv = to.merge_sorted_k(_t(keys).reshape(k, 32),
                               _t(vals).reshape(k, 32))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    tk2, tv2 = to.merge_sorted_k(_t(keys).reshape(k, 32), None)
    np.testing.assert_array_equal(tk2.numpy(), np.asarray(jk))
    assert tv2 is None


def _sort_input():
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 5000, 2048).astype(np.int32)
    keys[rng.random(2048) < 0.4] = SEN
    return keys, np.arange(2048, dtype=np.int32)


@pytest.fixture(scope="module")
def j_sorts():
    """The reference's chunked_merge sort, once per (fan_in, pairs)."""
    keys, vals = _sort_input()
    out = {}
    for fan in (2, 4):
        fn = jax.jit(lambda k, v, fan=fan: jo.stable_sort_by_key(
            k, v, 5000, chunk=128, radix_bits=4, fan_in=fan,
            strategy="chunked_merge"))
        out[fan, True] = fn(jnp.asarray(keys), jnp.asarray(vals))
        out[fan, False] = fn(jnp.asarray(keys), None)
    return out


@pytest.mark.parametrize("fan", [2, 4])
@pytest.mark.parametrize("routed", [False, True])
@pytest.mark.parametrize("pairs", [True, False])
def test_stable_sort_chunked_merge_matches_reference(j_sorts, fan, routed,
                                                     pairs):
    keys, vals = _sort_input()
    kw = dict(chunk=128, radix_bits=4, fan_in=fan)
    jk, jv = j_sorts[fan, pairs]
    hooks = dict(chunk_sort_fn=trs.make_chunk_sort_fn(4),
                 merge_fn=tm.make_merge_fn(fan)) if routed else {}
    tk, tv = to.stable_sort_by_key(_t(keys), _t(vals) if pairs else None,
                                   5000, strategy="chunked_merge", **kw,
                                   **hooks)
    xk, xv = to.stable_sort_by_key(_t(keys), _t(vals) if pairs else None,
                                   5000, strategy="xla_sort")
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tk.numpy(), xk.numpy())
    if pairs:
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tv.numpy(), xv.numpy())


GRAPHS = [(120, 900, 1024), (32767, 1500, 2048), (32768, 1500, 2048)]


@pytest.fixture(scope="module")
def j_orderings():
    """The reference's chunked_merge edge ordering, once per graph."""
    out = {}
    for n, e, cap in GRAPHS:
        dst, src = random_coo(np.random.default_rng(n), n, e)
        fn = jax.jit(lambda c: jo.edge_ordering(c, chunk=256,
                                                strategy="chunked_merge"))
        out[n] = fn(COO.from_arrays(dst, src, n, capacity=cap))
    return out


@pytest.mark.parametrize("n,e,cap", GRAPHS)
@pytest.mark.parametrize("routed", [False, True])
def test_edge_ordering_chunked_merge_matches_reference(j_orderings, n, e, cap,
                                                       routed):
    """32767 nodes is the widest packed VID space, 32768 the first
    two-pass one."""
    dst, src = random_coo(np.random.default_rng(n), n, e)
    tc = tg.COO.from_arrays(dst, src, n, capacity=cap, device="cpu")
    ref = j_orderings[n]
    hooks = dict(chunk_sort_fn=trs.make_chunk_sort_fn(4),
                 merge_fn=tm.make_merge_fn(2)) if routed else {}
    got = to.edge_ordering(tc, chunk=256, strategy="chunked_merge", **hooks)
    xla = to.edge_ordering(tc, strategy="xla_sort")
    for col in ("dst", "src"):
        g = getattr(got, col).numpy()
        np.testing.assert_array_equal(g, np.asarray(getattr(ref, col)))
        np.testing.assert_array_equal(g, getattr(xla, col).numpy())


# ------------------------------------------------ the merge-rung hook
def _ladder_input(n, run, kind, seed):
    """``n`` keys in sorted runs of ``run``: many ties (``ties``), one
    repeated key (``equal``), or a SENTINEL-clipped tail (``sentinel``:
    the clipped bound, 5000, on half the slots, as the sorter sees it)."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        keys = rng.integers(0, 40, n)
    elif kind == "equal":
        keys = np.full(n, 7)
    else:
        keys = rng.integers(0, 1000, n)
        keys[rng.random(n) < 0.5] = 5000
    keys = np.sort(keys.reshape(-1, run), axis=1).reshape(-1)
    return keys.astype(np.int32), np.arange(n, dtype=np.int32) * 3 + 1


# (n, run, max_block): run counts that are no power of two. 3 x 4096 and
# 5 x 1024 fit no fused rung (one rung of 3 or 5 runs, all through the
# hook); 12 x 1024 fuses the rungs up to 4096 and hooks the rest
LADDER_CASES = [(3 * 4096, 4096, 4096), (5 * 1024, 1024, 2048),
                (12 * 1024, 1024, 4096)]
LADDER_KINDS = ["ties", "equal", "sentinel"]


@pytest.fixture(scope="module")
def j_ladders():
    """The reference's ladder with its fused kernel (Pallas interpret
    mode) taking the rungs that fit ``max_block`` and jnp rungs the rest,
    one jit per (case, fan-in, pairs), run on each kind of input."""
    out = {}
    for n, run, mb in LADDER_CASES:
        for fan in (2, 3, 4):
            for pairs in (True, False):
                fn = jax.jit(lambda k, v, run=run, mb=mb, fan=fan:
                             jo.merge_rounds(k, v, run, fan_in=fan,
                                             merge_fn=lambda k, v, r: j_fused(
                                                 k, v, r, max_block=mb,
                                                 fan_in=fan)))
                for kind in LADDER_KINDS:
                    keys, vals = _ladder_input(n, run, kind, seed=n + run)
                    out[n, run, fan, kind, pairs] = fn(
                        jnp.asarray(keys),
                        jnp.asarray(vals) if pairs else None)
    return out


@pytest.mark.parametrize("n,run,mb", LADDER_CASES)
@pytest.mark.parametrize("fan", [2, 3, 4])
@pytest.mark.parametrize("kind", LADDER_KINDS)
@pytest.mark.parametrize("pairs", [True, False])
def test_merge_rounds_rung_hook_matches_reference(j_ladders, n, run, mb, fan,
                                                  kind, pairs):
    """``merge_rounds`` with the fused merge taking the rungs that fit and
    ``merge_rung`` (its CPU route, the plain rung) every rung above them
    equals the reference's ladder (its fused kernel, then jnp rungs) and
    the stable sort."""
    keys, vals = _ladder_input(n, run, kind, seed=n + run)
    tk, tv = to.merge_rounds(
        _t(keys), _t(vals) if pairs else None, run, fan_in=fan,
        merge_fn=lambda k, v, r: tm.fused_merge_rounds(k, v, r, max_block=mb,
                                                       fan_in=fan),
        rung_fn=tm.merge_rung)
    jk, jv = j_ladders[n, run, fan, kind, pairs]
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    if pairs:
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(tk.numpy(), keys[order])
    if pairs:
        np.testing.assert_array_equal(tv.numpy(), vals[order])
    else:
        assert tv is None


def _passes_emulated(keys, vals, run, fan_ins):
    """The kernel's schedule (``merge_passes``) run with the plain pairwise
    merge: each pass merges consecutive pairs of sub-runs inside every
    group and copies a last sub-run with no partner."""
    for group, r in tm.merge_passes(run, fan_ins):
        ok, ov = [], []
        for g0 in range(0, keys.shape[0], group):
            for p0 in range(g0, g0 + group, 2 * r):
                mid, end = min(p0 + r, g0 + group), min(p0 + 2 * r, g0 + group)
                k, v = to.merge_sorted(keys[p0:mid], None if vals is None
                                       else vals[p0:mid], keys[mid:end],
                                       None if vals is None else vals[mid:end])
                ok.append(k)
                ov.append(v)
        keys = torch.cat(ok)
        vals = None if vals is None else torch.cat(ov)
    return keys, vals


@pytest.mark.parametrize("k", [2, 3, 4, 5, 8])
@pytest.mark.parametrize("kind", LADDER_KINDS)
@pytest.mark.parametrize("pairs", [True, False])
def test_kernel_pass_schedule_is_the_reference_rung(k, kind, pairs):
    """A fan-in-k rung run as the kernel runs it, ceil(log2 k) passes of
    pairwise merges (a rung of 3: runs 0 and 1, then run 2), equals the
    reference's k-way rung ``merge_sorted_k``, bit for bit."""
    run, groups = 96, 3
    keys, vals = _ladder_input(groups * k * run, run, kind, seed=k)
    assert len(tm.merge_passes(run, [k])) == (k - 1).bit_length()
    tk, tv = _passes_emulated(_t(keys), _t(vals) if pairs else None, run, [k])
    jk, jv = jax.jit(jax.vmap(jo.merge_sorted_k))(
        jnp.asarray(keys).reshape(groups, k, run),
        jnp.asarray(vals).reshape(groups, k, run))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).reshape(-1))
    if pairs:
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv).reshape(-1))
    pk, pv = tm.merge_rung(_t(keys), _t(vals) if pairs else None, run, k)
    np.testing.assert_array_equal(pk.numpy(), tk.numpy())
    assert (pv is None) if not pairs else torch.equal(pv, tv)


@pytest.mark.parametrize("fan", [2, 3, 4])
@pytest.mark.parametrize("n,chunk", [(3 * 1024, 256), (5 * 1024, 1024)])
@pytest.mark.parametrize("pairs", [True, False])
def test_stable_sort_rung_hook_matches_reference(fan, n, chunk, pairs):
    """``stable_sort_by_key`` under chunked_merge with the chunk-sort and
    merge-rung hooks and no fused merge (every rung through ``rung_fn``),
    at run counts of 12 and 5, equals the reference's jitted sort and the
    xla_sort strategy."""
    rng = np.random.default_rng(n + fan)
    keys = rng.integers(0, 3000, n).astype(np.int32)
    keys[rng.random(n) < 0.3] = SEN
    vals = np.arange(n, dtype=np.int32)
    kw = dict(chunk=chunk, radix_bits=4, fan_in=fan, strategy="chunked_merge")
    jk, jv = jax.jit(lambda k, v: jo.stable_sort_by_key(k, v, 3000, **kw))(
        jnp.asarray(keys), jnp.asarray(vals) if pairs else None)
    tk, tv = to.stable_sort_by_key(
        _t(keys), _t(vals) if pairs else None, 3000, **kw,
        chunk_sort_fn=trs.make_chunk_sort_fn(4), rung_fn=tm.merge_rung)
    xk, xv = to.stable_sort_by_key(_t(keys), _t(vals) if pairs else None,
                                   3000, strategy="xla_sort")
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tk.numpy(), xk.numpy())
    if pairs:
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tv.numpy(), xv.numpy())
    else:
        assert tv is None
