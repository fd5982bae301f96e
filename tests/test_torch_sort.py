"""repro_torch Ordering + Reshaping against the JAX reference: both
designs of the digit pass on their plain twins (the reference's partition
+ histogram and rank-gather; the card's bucket-major histogram and
scatter, on the reference's tile and on card tiles) against the
reference's global_digit_pass run in Pallas interpret mode and its
in-kernel math, `convert` bit-identical under global_radix and
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
from repro.kernels.radix_sort import (global_digit_pass,  # noqa: E402
                                      radix_sort_chunks,
                                      radix_sort_chunks_keys)
from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core import pipeline as tp  # noqa: E402
from repro_torch.core.ordering import stable_sort_by_key  # noqa: E402
from repro_torch.core.set_partition import partition_tiles  # noqa: E402
from repro_torch.kernels import common as tcommon  # noqa: E402
from repro_torch.kernels import radix_sort as trs  # noqa: E402

SEN = 0x7FFFFFFF


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _keys(kind, n, rb, seed):
    rng = np.random.default_rng(seed)
    if kind == "single":
        return np.array([rng.integers(0, 1 << 12)], np.int32)
    if kind == "all_equal":  # one digit everywhere: only stability orders
        return np.full(n, 0x5A5, np.int32)
    k = rng.integers(0, 1 << (3 * rb), n).astype(np.int32)
    if kind == "sentinel_heavy":
        k[rng.random(n) < 0.6] = SEN
    return k


CASES = [(kind, rb, vals)
         for kind in ("random", "sentinel_heavy", "all_equal", "single")
         for rb in (2, 4, 8) for vals in (False, True)]
# card tiles of the new design: one that leaves a ragged last tile, one
# that divides the size, and the card's own (one ragged tile here)
CARD_TILES = (96, 512, trs.SCATTER_TILE)


@pytest.mark.parametrize("kind,rb,with_vals", CASES)
def test_global_digit_pass_twin_matches_reference_kernel(kind, rb, with_vals):
    """The port's digit pass equals the reference's Pallas pair in
    interpret mode, for both key variants, radix_bits 2/4/8, random,
    SENTINEL-heavy, all-equal and single-element inputs, in both designs:
    the reference's on its one-to-one kernels' twins (partition +
    histogram, the [T, B] table scan, the rank-gather, the gathers:
    ``reference_digit_pass``), and the card's (bucket-major histogram, one
    cumsum, scatter) as ``global_digit_pass`` runs it and on every card
    tile (``digit_pass``)."""
    n, tile = (1, 1) if kind == "single" else (512, 128)
    keys = _keys(kind, n, rb, seed=rb)
    vals = np.arange(n, dtype=np.int32) * 3 + 1
    shift = rb  # the second digit: a non-zero shift
    jk, jv = global_digit_pass(jnp.asarray(keys),
                               jnp.asarray(vals) if with_vals else None,
                               shift, tile=tile, radix_bits=rb)
    tv = _t(vals) if with_vals else None
    runs = {"reference_design": trs.reference_digit_pass(
                _t(keys), tv, shift, tile=tile, radix_bits=rb),
            "global_digit_pass": trs.global_digit_pass(
                _t(keys), tv, shift, tile=tile, radix_bits=rb)}
    runs.update((f"card tile {c}", trs.digit_pass(_t(keys), tv, shift, rb, c))
                for c in CARD_TILES)
    for route, (gk, gv) in runs.items():
        np.testing.assert_array_equal(gk.numpy(), np.asarray(jk), route)
        if with_vals:
            np.testing.assert_array_equal(gv.numpy(), np.asarray(jv), route)
        else:
            assert gv is None and jv is None, route


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


def _sort_by_schedule(keys, vals, chunk, schedule):
    """Stable LSD sort of every chunk in the given (shift, width) digit
    passes: the twin's building block (``partition_tiles`` and one gather
    a pass) on the card kernel's schedule."""
    k = keys.reshape(-1, chunk)
    v = None if vals is None else vals.reshape(-1, chunk)
    for shift, width in schedule:
        digit = (k >> shift) & ((1 << width) - 1)
        src = partition_tiles(digit, 1 << width)[0].to(torch.int64)
        k = k.gather(1, src)
        v = None if v is None else v.gather(1, src)
    return k.reshape(-1), None if v is None else v.reshape(-1)


def _chunk_keys(kind, n, key_bits, seed):
    rng = np.random.default_rng(seed)
    if kind == "equal":
        return np.full(n, 77, np.int32)  # one digit everywhere: stability
    if kind == "negative":
        return rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    k = rng.integers(0, 1 << key_bits, n).astype(np.int32)
    k[rng.random(n) < 0.3] = 5  # ties inside every chunk
    if kind == "high_bits":  # bits above key_bits that the sort ignores
        k |= (rng.integers(0, 1 << (31 - key_bits), n) << key_bits).astype(
            np.int32)
    return k


SCHEDULE_CASES = [(kind, rb, pairs) for kind in
                  ("uniform", "high_bits", "negative", "equal")
                  for rb in (2, 4, 8) for pairs in (True, False)]


@pytest.mark.parametrize("kind,rb,pairs", SCHEDULE_CASES)
def test_chunk_sort_in_kernel_schedule_matches_reference_kernel(kind, rb,
                                                                pairs):
    """The card's chunk sort orders by key bits [0, B), B = min(32,
    ceil(key_bits / rb) * rb), in its own passes (7, 7, 6 bits over B =
    20; 8, 8, 8 over 24): the twin's partition run on that schedule equals
    the reference's radix_sort_chunks / radix_sort_chunks_keys (interpret
    mode, rb-bit passes) and the twin, bit for bit, on keys with bits above
    key_bits, negative keys and all-equal keys."""
    n, chunk, key_bits = 384, 128, 19
    keys = _chunk_keys(kind, n, key_bits, seed=rb + len(kind))
    vals = np.arange(n, dtype=np.int32) * 7 + 1
    n_bits = trs.chunk_sort_bits(key_bits, rb)
    schedule = trs.chunk_digit_schedule(n_bits)
    assert n_bits == (20 if rb < 8 else 24) and len(schedule) == 3
    assert max(w for _, w in schedule) <= 8
    got = _sort_by_schedule(_t(keys), _t(vals) if pairs else None, chunk,
                            schedule)
    twin = trs.chunk_sort(_t(keys), _t(vals) if pairs else None, chunk,
                          key_bits, rb)
    if pairs:
        jk, jv = radix_sort_chunks(jnp.asarray(keys), jnp.asarray(vals),
                                   chunk=chunk, key_bits=key_bits,
                                   radix_bits=rb)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(jv))
        np.testing.assert_array_equal(got[1].numpy(), twin[1].numpy())
    else:
        jk = radix_sort_chunks_keys(jnp.asarray(keys), chunk=chunk,
                                    key_bits=key_bits, radix_bits=rb)
        assert got[1] is None and twin[1] is None
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(got[0].numpy(), twin[0].numpy())


@pytest.mark.parametrize("key_bits,rb", [(1, 4), (7, 7), (12, 4), (19, 4),
                                         (18, 2), (19, 8), (32, 3), (32, 8),
                                         (40, 4)])
def test_chunk_digit_schedule_covers_the_reference_bits(key_bits, rb):
    """B is the span of the reference's passes (at most 32 bits); the
    kernel's passes tile [0, B) exactly in at most 8-bit digits, widths
    within one bit of each other, the wider first."""
    n_bits = trs.chunk_sort_bits(key_bits, rb)
    assert n_bits == min(32, -(-key_bits // rb) * rb)
    sched = trs.chunk_digit_schedule(n_bits)
    assert len(sched) == max(1, -(-n_bits // 8))
    assert [s for s, _ in sched] == list(np.cumsum([0] + [w for _, w in
                                                          sched])[:-1])
    widths = [w for _, w in sched]
    assert sum(widths) == n_bits and max(widths) <= 8
    assert widths == sorted(widths, reverse=True)
    assert widths[0] - widths[-1] <= 1


def test_chunk_sort_shapes_mirror_the_kernel_source():
    """The Python mirrors of the chunk sort's instantiations are the ones
    csrc/digit_pass.cu launches, each fits one CTA's shared memory, and
    the chunks the path and the tests use pick the expected one."""
    import pathlib
    import re
    src = (pathlib.Path(trs.__file__).parents[1] / "csrc" / "digit_pass.cu"
           ).read_text()
    table = re.search(r"kSortShapes\[\]\[2\] = \{(.*?)\};", src, re.S).group(1)
    shapes = tuple(tuple(map(int, m)) for m in
                   re.findall(r"\{(\d+),\s*(\d+)\}", table))
    assert shapes == trs.CHUNK_SORT_SHAPES
    for i, (w, it) in enumerate(shapes):
        assert f"CHUNK_SORT_CASE({i}, {w}, {it})" in src or i == len(
            shapes) - 1
    assert "kMaxPairChunk = 32 * 32 * 16" in src
    assert trs.MAX_PAIR_CHUNK == 32 * 32 * 16
    assert trs.chunk_sort_shape(4096, True) == (16, 8)
    assert trs.chunk_sort_shape(3000, False) == (16, 8)
    assert trs.chunk_sort_shape(64, True) == (1, 4)
    assert trs.chunk_sort_shape(1 << 15, True) is None
    assert trs.chunk_sort_shape(1 << 15, False) == (32, 32)
    assert trs.chunk_sort_shape((1 << 15) + 1, False) is None
    for w, it in shapes:
        for pairs in (True, False):
            chunk = 32 * w * it
            smem = trs.chunk_sort_smem_bytes(chunk, 32, pairs)
            assert smem <= trs.MAX_SMEM_BYTES
            assert (smem == 0) == (pairs and chunk > trs.MAX_PAIR_CHUNK)
    # 4096 pairs over 20 bits: 16 warps x (128 counters + 2) + 2 x 4096
    assert trs.chunk_sort_smem_bytes(4096, 20, True) == 4 * (16 * 130 + 8192)


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
