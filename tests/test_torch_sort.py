"""repro_torch Ordering + Reshaping against the JAX reference: the plain
twins of the digit-pass kernels (partition + histogram, rank-gather)
against the reference's global_digit_pass run in Pallas interpret mode and
its in-kernel math, `convert` bit-identical under global_radix and
xla_sort with kernel routing on and off (across the 32767/32768
packed/two-pass boundary), and the cost model resolving the same
strategies. Integer outputs must be bit-identical."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import COO, EngineConfig, convert, random_coo  # noqa: E402
from repro.core import costmodel as jcm  # noqa: E402
from repro.core.set_partition import (digit_relocation_sources,  # noqa: E402
                                      rank_gather_sources)
from repro.kernels import common as jcommon  # noqa: E402
from repro.kernels.radix_sort import global_digit_pass  # noqa: E402
from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core import pipeline as tp  # noqa: E402
from repro_torch.core.ordering import stable_sort_by_key  # noqa: E402
from repro_torch.kernels import common as tcommon  # noqa: E402
from repro_torch.kernels import radix_sort as trs  # noqa: E402

SEN = 0x7FFFFFFF


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _keys(kind, n, rb, seed):
    rng = np.random.default_rng(seed)
    if kind == "single":
        return np.array([rng.integers(0, 1 << 12)], np.int32)
    k = rng.integers(0, 1 << (3 * rb), n).astype(np.int32)
    if kind == "sentinel_heavy":
        k[rng.random(n) < 0.6] = SEN
    return k


CASES = [(kind, rb, vals) for kind in ("random", "sentinel_heavy", "single")
         for rb in (2, 4, 8) for vals in (False, True)]


@pytest.mark.parametrize("kind,rb,with_vals", CASES)
def test_global_digit_pass_twin_matches_reference_kernel(kind, rb, with_vals):
    """The port's digit pass (both kernel twins + the table scan + the
    gather) equals the reference's Pallas pair in interpret mode, for both
    key variants, radix_bits 2/4/8, SENTINEL-heavy and single-element
    inputs."""
    n, tile = (1, 1) if kind == "single" else (512, 128)
    keys = _keys(kind, n, rb, seed=rb)
    vals = np.arange(n, dtype=np.int32) * 3 + 1
    shift = rb  # the second digit: a non-zero shift
    jk, jv = global_digit_pass(jnp.asarray(keys),
                               jnp.asarray(vals) if with_vals else None,
                               shift, tile=tile, radix_bits=rb)
    tk, tv = trs.global_digit_pass(_t(keys), _t(vals) if with_vals else None,
                                   shift, tile=tile, radix_bits=rb)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    if with_vals:
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    else:
        assert tv is None and jv is None


@pytest.mark.parametrize("rb", [2, 4, 8])
def test_partition_twin_matches_in_kernel_math(rb):
    """Kernel 1's twin: per tile, the reference kernel body's router
    (digit_relocation_sources) gives the partitioned tile and the in-tile
    bases; the histogram is their difference."""
    nb, tile, n = 1 << rb, 64, 128
    keys = _keys("sentinel_heavy", n, rb, seed=10 + rb)
    router = jax.jit(digit_relocation_sources, static_argnums=1)
    vals = np.arange(n, dtype=np.int32)
    pk, pv, lbase, hist = trs.digit_partition_hist(_t(keys), _t(vals), 0,
                                                  tile, rb)
    for t in range(n // tile):
        kt = jnp.asarray(keys[t * tile:(t + 1) * tile])
        src, base = router(kt & (nb - 1), nb)
        sl = slice(t * tile, (t + 1) * tile)
        np.testing.assert_array_equal(pk[sl].numpy(), np.asarray(kt[src]))
        np.testing.assert_array_equal(pv[sl].numpy(), vals[sl][np.asarray(src)])
        np.testing.assert_array_equal(lbase[t].numpy(), np.asarray(base))
        np.testing.assert_array_equal(
            hist[t].numpy(), np.diff(np.append(np.asarray(base), tile)))


@pytest.mark.parametrize("rb", [2, 4, 8])
def test_rank_gather_twin_matches_reference(rb):
    nb, tile, n = 1 << rb, 32, 512
    keys = _keys("random", n, rb, seed=20 + rb)
    _, _, lbase, hist = trs.digit_partition_hist(_t(keys), None, 0, tile, rb)
    incl = torch.cumsum(hist, 0, dtype=torch.int32)
    excl = incl - hist
    gbase = torch.cumsum(incl[-1], 0, dtype=torch.int32) - incl[-1]
    got = trs.digit_rank_gather(gbase, incl, excl, lbase, tile)
    want = rank_gather_sources(*(jnp.asarray(x.numpy()) for x in
                                 (gbase, incl, excl, lbase)), tile)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [1, 5, 64, 1000])
def test_common_helpers_match_reference(n):
    """prefix_sum_tree (both axes, inclusive and exclusive) and
    pad_pow2_1d equal the reference's kernels/common.py helpers."""
    x = np.random.default_rng(n).integers(-50, 50, (n, 3)).astype(np.int32)
    for axis in (0, 1):
        for exclusive in (False, True):
            np.testing.assert_array_equal(
                tcommon.prefix_sum_tree(_t(x), axis, exclusive).numpy(),
                np.asarray(jcommon.prefix_sum_tree(jnp.asarray(x), axis,
                                                   exclusive)))
    np.testing.assert_array_equal(
        tcommon.pad_pow2_1d(_t(x[:, 0]), 8, SEN).numpy(),
        np.asarray(jcommon.pad_pow2_1d(jnp.asarray(x[:, 0]), 8, SEN)))


def test_sort_strategies_agree_including_chunked_merge():
    """global_radix, xla_sort and chunked_merge give the same pairs."""
    rng = np.random.default_rng(3)
    keys = _t(rng.integers(0, 5000, 1024).astype(np.int32))
    vals = _t(np.arange(1024, dtype=np.int32))
    a = stable_sort_by_key(keys, vals, 5000, chunk=128,
                           strategy="global_radix")
    b = stable_sort_by_key(keys, vals, 5000, strategy="xla_sort")
    c = stable_sort_by_key(keys, vals, 5000, chunk=128,
                           strategy="chunked_merge")
    for x, y, z in zip(a, b, c):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
        np.testing.assert_array_equal(z.numpy(), y.numpy())


def _graph(n, e, cap, seed):
    dst, src = random_coo(np.random.default_rng(seed), n, e)
    return (COO.from_arrays(dst, src, n, capacity=cap),
            tg.COO.from_arrays(dst, src, n, capacity=cap, device="cpu"))


GRAPHS = [(120, 900, 1024), (32767, 1500, 2048), (32768, 1500, 2048)]


@pytest.mark.parametrize("n,e,cap", GRAPHS)
def test_convert_bit_identical_across_strategies_and_routing(n, e, cap):
    """Every (strategy × kernel routing) of the port equals the
    reference's CSC (the reference's own strategies agree with each
    other, tests/test_sort_stack.py); 32767 nodes is the widest packed
    VID space, 32768 the first two-pass one."""
    jc, tc = _graph(n, e, cap, seed=n)
    ref = convert(jc, EngineConfig(w_upe=256, sort_strategy="xla_sort"))
    for strategy in ("global_radix", "xla_sort"):
        for use_pallas in (False, True):
            cfg = tcm.EngineConfig(w_upe=256, sort_strategy=strategy,
                                   use_pallas=use_pallas,
                                   reindex_strategy="fused")
            csc = tp.convert(tc, cfg, device="cpu")
            tag = (strategy, use_pallas)
            np.testing.assert_array_equal(csc.ptr.numpy(),
                                          np.asarray(ref.ptr), tag)
            np.testing.assert_array_equal(csc.idx.numpy(),
                                          np.asarray(ref.idx), tag)
            assert int(csc.n_edges) == e


def test_convert_two_pass_matches_reference_kernel_path():
    """The slice configuration on both sides: the reference's Pallas
    digit-pass and rank kernels (interpret mode) against the port's kernel
    routing, two-pass Ordering, unfused-resolving auto epilogue pinned
    fused."""
    jc, tc = _graph(32768, 1500, 2048, seed=1)
    kw = dict(w_upe=256, sort_strategy="global_radix", use_pallas=True,
              reindex_strategy="fused")
    ref = convert(jc, EngineConfig(**kw))
    csc = tp.convert(tc, tcm.EngineConfig(**kw), device="cpu")
    np.testing.assert_array_equal(csc.ptr.numpy(), np.asarray(ref.ptr))
    np.testing.assert_array_equal(csc.idx.numpy(), np.asarray(ref.idx))


def test_convert_entry_point_refuses_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    _, tc = _graph(50, 100, 128, seed=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.convert(tc)  # default device="cuda"


WORKLOADS = [(300, 1000), (300, 4096), (300, 16384), (5000, 131072),
             (70000, 50000), (70000, 1 << 20), (232965, 1 << 27)]


@pytest.mark.parametrize("n,e", WORKLOADS)
def test_costmodel_resolves_like_reference(n, e):
    """Same strategy strings as the reference for every bitstream-library
    config (plus the sort_mode / radix_bits / fan-in variants)."""
    lib_j, lib_t = jcm.bitstream_library(), tcm.bitstream_library()
    extra = [dict(sort_mode="two_pass"), dict(radix_bits=8),
             dict(merge_fan_in=4), dict(sort_mode="packed", radix_bits=2)]
    for kw in extra:
        lib_j.append(jcm.EngineConfig(**kw))
        lib_t.append(tcm.EngineConfig(**kw))
    for cj, ct in zip(lib_j, lib_t):
        assert cj.key == ct.key
        wj, wt = jcm.Workload(n=n, e=e), tcm.Workload(n=n, e=e)
        assert (tcm.resolve_sort_strategy(ct, wt)
                == jcm.resolve_sort_strategy(cj, wj)), ct.key
        assert (tcm.pointer_reindex_strategy(ct, wt)
                == jcm.pointer_reindex_strategy(cj, wj)), ct.key
        q = tcm.reindex_query_count(e, e // 2)
        assert q == jcm.reindex_query_count(e, e // 2)
        assert (tcm.resolve_reindex_strategy(ct, q, e)
                == jcm.resolve_reindex_strategy(cj, q, e))
        assert tcm.digit_pass_count(ct, wt) == jcm.digit_pass_count(cj, wj)
