"""repro_torch set-count against the JAX reference: the set_count_less twin
(count_less_than) against the reference's set_count_less kernel in Pallas
interpret mode on unsorted, ragged and INT32_MAX-padded input, the
count_fn adapter against pallas_count_fn, and convert under the merge
configuration (chunked_merge sorts through the chunk-sort and fused-merge
kernels, the unfused set-count pointer build) bit-identical to the
reference's convert under the same configuration and to the xla_sort
strategy, packed and two-pass. A test-local emulation of the card
kernel's schedule (sorted tiles, the per-CTA min/max skip, lower-bound
bisection, the INT32_MAX-padded ragged tile) is held bit for bit against
the reference kernel under hypothesis; the wrapper's scratch is sized for
the card kernel's tile."""
import pathlib
import re

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import COO, EngineConfig, convert, random_coo  # noqa: E402
from repro.core.set_count import count_less_than as j_count  # noqa: E402
from repro.kernels.set_count import pallas_count_fn  # noqa: E402
from repro.kernels.set_count import set_count_less as j_set_count  # noqa: E402
from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core import pipeline as tp  # noqa: E402
from repro_torch.core.set_count import count_less_than  # noqa: E402
from repro_torch.kernels import merge as tm  # noqa: E402
from repro_torch.kernels import set_count as tsc  # noqa: E402
from repro_torch.launch.serve import MERGE_CFG  # noqa: E402

SEN = 0x7FFFFFFF
I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _elems_targets(e, t, seed, pad=0):
    """Unsorted elements (with an INT32_MAX-padded tail of ``pad``) and
    unsorted targets, both with values on either side of each other."""
    rng = np.random.default_rng(seed)
    elems = rng.integers(-50, 5000, e).astype(np.int32)
    if pad:
        elems[-pad:] = SEN
    tgts = rng.integers(-60, 5100, t).astype(np.int32)
    tgts[:3] = np.array([SEN, -2**31, 0], np.int32)[:t]
    return elems, tgts


# (E, T, e_block, t_block, INT32_MAX tail)
KERNEL_CASES = [(2048, 256, 2048, 256, 0), (4096, 512, 1024, 128, 700),
                (1024, 128, 256, 128, 1024)]


@pytest.mark.parametrize("e,t,eb,tb,pad", KERNEL_CASES)
def test_set_count_twin_matches_reference_kernel(e, t, eb, tb, pad):
    elems, tgts = _elems_targets(e, t, seed=e + t, pad=pad)
    want = j_set_count(jnp.asarray(elems), jnp.asarray(tgts), t_block=tb,
                       e_block=eb)
    got = tsc.set_count_less(_t(elems), _t(tgts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), (elems[None, :] < tgts[:, None]).sum(1))


@pytest.mark.parametrize("e,t", [(1000, 300), (7, 1), (2049, 257)])
def test_count_fn_matches_reference_adapter_on_ragged_input(e, t):
    """Ragged sizes go through the adapters' padding on both sides."""
    elems, tgts = _elems_targets(e, t, seed=e)
    want = pallas_count_fn(jnp.asarray(elems), jnp.asarray(tgts))
    np.testing.assert_array_equal(tsc.count_fn(_t(elems), _t(tgts)).numpy(),
                                  np.asarray(want))
    for block in (64, 2048):  # the plain compare-reduce at any block
        np.testing.assert_array_equal(
            count_less_than(_t(elems), _t(tgts), block=block).numpy(),
            np.asarray(j_count(jnp.asarray(elems), jnp.asarray(tgts),
                               block=block)))


GRAPHS = [(120, 900, 1024), (32768, 1500, 2048)]
MERGE_KW = dict(w_upe=256, use_pallas=True, sort_strategy="chunked_merge",
                reindex_strategy="unfused")


@pytest.fixture(scope="module")
def j_converts():
    """The reference's convert under the merge configuration (its Pallas
    chunk-sort, merge and set-count kernels in interpret mode)."""
    out = {}
    for n, e, cap in GRAPHS:
        dst, src = random_coo(np.random.default_rng(n), n, e)
        out[n] = convert(COO.from_arrays(dst, src, n, capacity=cap),
                         EngineConfig(**MERGE_KW))
    return out


@pytest.mark.parametrize("n,e,cap", GRAPHS)
def test_convert_merge_cfg_matches_reference(j_converts, n, e, cap):
    dst, src = random_coo(np.random.default_rng(n), n, e)
    tc = tg.COO.from_arrays(dst, src, n, capacity=cap, device="cpu")
    ref = j_converts[n]
    csc = tp.convert(tc, tcm.EngineConfig(**MERGE_KW), device="cpu")
    xla = tp.convert(tc, tcm.EngineConfig(sort_strategy="xla_sort"),
                     device="cpu")
    for got, want in ((csc.ptr, ref.ptr), (csc.idx, ref.idx)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(csc.ptr.numpy(), xla.ptr.numpy())
    np.testing.assert_array_equal(csc.idx.numpy(), xla.idx.numpy())


def test_merge_cfg_routes_all_six_kernel_fns():
    """MERGE_CFG resolves to the path it names, and ``kernel_fns`` gives
    the reference's six routes under use_pallas (none without), the
    reference's per-pass digit route taken by the whole global_radix sort
    on the card's own digit schedule, and the port's seventh: the
    merge-rung kernel for the rungs the reference runs in jnp."""
    kf = tp.kernel_fns(MERGE_CFG)
    assert len(kf) == 7 and all(fn is not None for fn in kf)
    assert kf.count_fn is tsc.count_fn
    assert kf.rung_fn is tm.merge_rung
    assert tp.kernel_fns(tcm.EngineConfig()) == (None,) * 7
    w = tcm.Workload(n=282_624, e=1 << 19)
    assert tcm.resolve_sort_strategy(MERGE_CFG, w) == "chunked_merge"
    assert tcm.pointer_reindex_strategy(MERGE_CFG, w) == "unfused"


def test_explicit_count_fn_overrides_routing():
    """``convert(count_fn=...)`` takes precedence over the config's
    routing (the reference's override), with the same CSC."""
    dst, src = random_coo(np.random.default_rng(5), 100, 1500)
    tc = tg.COO.from_arrays(dst, src, 100, capacity=2048, device="cpu")
    calls = []

    def spy(sorted_dst, targets):
        calls.append(targets.shape[0])
        return tsc.count_fn(sorted_dst, targets)

    cfg = tcm.EngineConfig(w_upe=256, reindex_strategy="unfused")
    got = tp.convert(tc, cfg, device="cpu", count_fn=spy)
    want = tp.convert(tc, cfg, device="cpu")
    assert calls == [101]
    np.testing.assert_array_equal(got.ptr.numpy(), want.ptr.numpy())
    np.testing.assert_array_equal(got.idx.numpy(), want.idx.numpy())


def _lower_bound_lifting(tile, t):
    """The kernel's bisection, vectorised over targets: binary lifting over
    a sorted power-of-two tile, valid for min < t <= max."""
    pos = np.zeros(t.shape, np.int64)
    step = tile.shape[0] // 2
    while step:
        pos += np.where(tile[pos + step - 1] < t, step, 0)
        step //= 2
    return pos


def _emulated_tile_bisect_count(elems, tgts, sort_tile, per_cta):
    """csrc/set_count.cu in numpy: the sort pass (tiles of ``sort_tile``,
    the ragged one padded with INT32_MAX, each tile's min and max), then
    the count pass per CTA of ``per_cta`` targets: tiles wholly below the
    CTA's smallest target add their live count, tiles at or above its
    largest add nothing, and for the rest each target adds the live count
    (t > max), nothing (t <= min) or its lower bound in the tile."""
    n = elems.shape[0]
    n_tiles = -(-n // sort_tile)
    padded = np.full(n_tiles * sort_tile, I32_MAX, np.int64)
    padded[:n] = elems
    tiles = np.sort(padded.reshape(n_tiles, sort_tile), axis=1)
    mins, maxs = tiles[:, 0], tiles[:, -1]
    live = np.minimum(sort_tile, n - np.arange(n_tiles) * sort_tile)
    out = np.zeros(tgts.shape[0], np.int64)
    for c0 in range(0, tgts.shape[0], per_cta):
        t = tgts[c0:c0 + per_cta].astype(np.int64)
        tmin, tmax = t.min(), t.max()
        c = np.full(t.shape, live[maxs < tmin].sum(), np.int64)
        for i in np.nonzero((maxs >= tmin) & (mins < tmax))[0]:
            inside = (t > mins[i]) & (t <= maxs[i])
            c += np.where(t > maxs[i], live[i], 0)
            c[inside] += _lower_bound_lifting(tiles[i], t[inside])
        out[c0:c0 + per_cta] = c
    return out


def _int32_draw(rng, n, spread):
    """int32 values in [-spread, spread) with repeats and the extremes."""
    x = rng.integers(max(-spread, I32_MIN), min(spread, I32_MAX), n,
                     dtype=np.int64)
    x[rng.random(n) < 0.2] = x[0]  # ties
    pick = rng.random(n) < 0.05
    x[pick] = rng.choice([I32_MIN, I32_MIN + 1, I32_MAX - 1, I32_MAX],
                         pick.sum())
    return x.astype(np.int32)


@settings(max_examples=25, deadline=None)
@given(e=st.integers(1, 5000), t=st.integers(1, 700),
       seed=st.integers(0, 2**32 - 1),
       spread=st.sampled_from([8, 1000, 1 << 31]),
       sort_tile=st.sampled_from([16, tsc.SORT_TILE]),
       per_cta=st.sampled_from([8, 512]))
def test_tile_bisect_schedule_matches_reference_kernel(e, t, seed, spread,
                                                       sort_tile, per_cta):
    """The card kernel's schedule, emulated, equals the reference's
    all-pairs set_count_less (Pallas interpret mode; elements padded with
    INT32_MAX to its element block, targets with 0 to its target block)
    bit for bit, at the kernel's tile and at a small one that makes many
    tiles, for ties, negatives, INT32_MIN / INT32_MAX and ragged sizes."""
    rng = np.random.default_rng(seed)
    elems, tgts = _int32_draw(rng, e, spread), _int32_draw(rng, t, spread)
    e_pad, t_pad = -e % 2048, -t % 256
    want = np.asarray(j_set_count(
        jnp.asarray(np.concatenate([elems, np.full(e_pad, SEN, np.int32)])),
        jnp.asarray(np.concatenate([tgts, np.zeros(t_pad, np.int32)]))))[:t]
    got = _emulated_tile_bisect_count(elems, tgts, sort_tile, per_cta)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tsc.set_count_less(_t(elems), _t(tgts)).numpy(), want)


@pytest.mark.parametrize("n", [0, 1, tsc.SORT_TILE, tsc.SORT_TILE + 1,
                               5 * tsc.SORT_TILE - 3])
def test_set_count_scratch_fits_the_kernel_tile(n):
    """The wrapper's SORT_TILE is csrc/set_count.cu's kSortTile, and its
    scratch holds every tile of n elements and each tile's (min, max)."""
    src = (pathlib.Path(tsc.__file__).parent.parent / "csrc"
           / "set_count.cu").read_text()
    log2 = int(re.search(r"constexpr int kSortLog2 = (\d+);", src).group(1))
    assert "constexpr int kSortTile = 1 << kSortLog2;" in src
    assert tsc.SORT_TILE == 1 << log2
    tiles, bounds = tsc.set_count_scratch(n, "cpu")
    n_tiles = -(-n // tsc.SORT_TILE)
    assert tiles.dtype == bounds.dtype == torch.int32
    assert tiles.shape == (n_tiles * tsc.SORT_TILE,)
    assert bounds.shape == (2 * n_tiles,)
    assert tiles.numel() >= n
