"""repro_torch's card design of the global_radix sort against the JAX
reference (its single digit pass is held against the reference's
``global_digit_pass`` in ``test_torch_sort.py``): the whole-sort hook ``radix_sort_fn`` (its CPU route, the reference's loop) and
the card's own digit schedule run pass by pass on the twins equal the
reference's ``global_radix_sort_by_key`` at key bounds 2^k - 1, 2^k and
Reddit's 232,965; the SLICE_CFG ``convert`` and ``sample_subgraph`` of a
small graph are bit-identical to the reference's, on either route; and a
Python emulation of the scatter kernel's in-tile rank order (the tile in
registers as the chunk sort holds it, ballot peers, per-warp counters)
places every element where the twin does, at digit widths 1 to 8. Integer
outputs must be bit-identical."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import COO, EngineConfig, convert, random_coo  # noqa: E402
from repro.core import pipeline as jp  # noqa: E402
from repro.core.ordering import (  # noqa: E402
    global_radix_sort_by_key as j_global_radix)
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core import ordering as tord  # noqa: E402
from repro_torch.core import pipeline as tp  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels import radix_sort as trs  # noqa: E402
from repro_torch.launch.serve import SLICE_CFG  # noqa: E402

SEN = 0x7FFFFFFF


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _card_schedule_fn(radix_bits, card_tile):
    """The card route of ``make_radix_sort_fn``, on the twins: its own
    digit schedule, one hist -> scan -> scatter pass a digit."""

    def radix_sort_fn(keys, vals, key_bits):
        for shift, width in trs.global_radix_schedule(key_bits, radix_bits):
            keys, vals = trs.digit_pass(keys, vals, shift, width, card_tile)
        return keys, vals

    return radix_sort_fn


@pytest.mark.parametrize("route", ["radix_sort_fn", "card_schedule"])
@pytest.mark.parametrize("with_vals", [False, True])
@pytest.mark.parametrize("rb", [3, 4, 8])
@pytest.mark.parametrize("key_bound", [(1 << 12) - 1, 1 << 12, 232_965])
def test_own_schedule_sort_matches_reference(key_bound, rb, with_vals,
                                             route):
    """The whole global_radix sort: the hook's CPU route (the reference's
    loop of ``rb``-bit passes on the twins) and the card's own schedule
    (ceil(B / 8) passes over the same B key bits) pass by pass, against
    the reference's ``global_radix_sort_by_key``; SENTINEL and keys at the
    bound itself are in the stream."""
    n, tile = 2048, 256
    rng = np.random.default_rng(key_bound + rb)
    keys = rng.integers(0, key_bound + 1, n).astype(np.int32)
    keys[rng.random(n) < 0.2] = SEN
    keys[:5] = key_bound
    vals = np.arange(n, dtype=np.int32) * 3
    jk, jv = j_global_radix(jnp.asarray(keys),
                            jnp.asarray(vals) if with_vals else None,
                            key_bound, tile=tile, radix_bits=rb)
    fn = (trs.make_radix_sort_fn(rb, tile) if route == "radix_sort_fn"
          else _card_schedule_fn(rb, card_tile=300))
    tk, tv = tord.global_radix_sort_by_key(
        _t(keys), _t(vals) if with_vals else None, key_bound, tile=tile,
        radix_bits=rb, radix_sort_fn=fn)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    if with_vals:
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    else:
        assert tv is None and jv is None


@pytest.mark.parametrize("key_bits,rb,want", [
    (18, 4, [(0, 7), (7, 7), (14, 6)]),  # the Reddit convert: 20 bits
    (12, 4, [(0, 6), (6, 6)]),
    (12, 3, [(0, 6), (6, 6)]),
    (13, 8, [(0, 8), (8, 8)]),
    (31, 4, [(0, 8), (8, 8), (16, 8), (24, 8)]),
    (1, 4, [(0, 4)])])
def test_global_radix_schedule(key_bits, rb, want):
    """ceil(B / 8) passes whose widths differ by at most one bit, over
    exactly the bits [0, B) the reference's passes cover."""
    got = trs.global_radix_schedule(key_bits, rb)
    assert got == want
    assert sum(w for _, w in got) == trs.chunk_sort_bits(key_bits, rb)


def _graph(n, e, cap, seed):
    dst, src = random_coo(np.random.default_rng(seed), n, e)
    return (COO.from_arrays(dst, src, n, capacity=cap),
            tg.COO.from_arrays(dst, src, n, capacity=cap, device="cpu"))


@pytest.mark.parametrize("route", ["cpu", "card_schedule"])
@pytest.mark.parametrize("n,e,cap", [(3000, 3000, 4096),
                                     (40_000, 3000, 4096)])
def test_slice_cfg_convert_and_sample_match_reference(n, e, cap, route,
                                                      monkeypatch):
    """``convert`` and ``sample_subgraph`` under SLICE_CFG (packed and
    two-pass Ordering) give the reference's CSC and subgraph bit for bit;
    ``card_schedule`` swaps the card's own digit schedule (run on the
    twins) into the routing."""
    if route == "card_schedule":
        monkeypatch.setattr(trs, "make_radix_sort_fn",
                            lambda rb, tile: _card_schedule_fn(rb, 1000))
        # the routing is built once a config: build it afresh on the swap
        monkeypatch.setattr(tp, "_KERNEL_FNS", {})
    jc, tc = _graph(n, e, cap, seed=n)
    jcfg = EngineConfig(sort_strategy="xla_sort")
    ref = convert(jc, jcfg)
    csc = tp.convert(tc, SLICE_CFG, device="cpu")
    np.testing.assert_array_equal(csc.ptr.numpy(), np.asarray(ref.ptr))
    np.testing.assert_array_equal(csc.idx.numpy(), np.asarray(ref.idx))
    seeds = np.array([5, 17, 3, 250, 2999, SEN, SEN, SEN], np.int32)
    key = prng.fold_in(prng.PRNGKey(3), 7)
    jkey = jnp.asarray(np.array(key, np.uint32))
    want = jax.jit(lambda c, s, k: jp.sample_subgraph(c, s, (5, 3), k, jcfg))(
        ref, jnp.asarray(seeds), jkey)
    sub = tp.sample_subgraph(csc, _t(seeds), (5, 3), key, SLICE_CFG)
    for got, w in ((sub.csc.ptr, want.csc.ptr), (sub.csc.idx, want.csc.idx),
                   (sub.order, want.order)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    assert int(sub.n_sub_nodes) == int(want.n_sub_nodes)


def _emulated_scatter(keys, vals, offsets, shift, tile, rb):
    """``digit_scatter_kernel`` written out per CTA, warp, item round and
    lane: the tile in the instantiation's registers (item j of lane l of
    warp w at w * 32 * items + j * 32 + l; items past the tile take the
    last digit), each item's rank ``cnt[warp][d] + popc(peers &
    lanes_below)`` with its ballot peers of the round, the group's lowest
    lane advancing the counter, the (bucket, warp) scan, the staged tile,
    then staged slot s of bucket b written to ``offsets[b * T + t] -
    base[b] + s``."""
    nb, n = 1 << rb, len(keys)
    warps, items = trs.digit_pass_shape(tile)
    cap = 32 * warps * items
    n_tiles = -(-n // tile)
    out_k = np.empty_like(keys)
    out_v = None if vals is None else np.empty_like(vals)
    for t in range(n_tiles):
        k = keys[t * tile:(t + 1) * tile]
        ln = len(k)
        d = np.full(cap, nb - 1, np.int64)
        d[:ln] = (k >> shift) & (nb - 1)
        cnt = np.zeros((warps, nb), np.int64)
        rank = np.empty(cap, np.int64)
        for w in range(warps):
            for j in range(items):
                lanes = w * 32 * items + j * 32 + np.arange(32)
                dl = d[lanes]
                for lane in range(32):  # peers of the round below the lane
                    rank[lanes[lane]] = (cnt[w, dl[lane]]
                                         + np.sum(dl[:lane] == dl[lane]))
                for b in set(dl.tolist()):  # each group's leader advances
                    cnt[w, b] += np.sum(dl == b)
        flat = cnt.T.reshape(-1)  # (bucket, warp) order
        start = (np.cumsum(flat) - flat).reshape(nb, warps).T
        base = start[0]
        staged = np.empty(ln, np.int64)
        for i in range(ln):
            staged[start[i // (32 * items), d[i]] + rank[i]] = i
        for s_ in range(ln):
            i = staged[s_]
            dst = offsets[d[i] * n_tiles + t] - base[d[i]] + s_
            out_k[dst] = k[i]
            if vals is not None:
                out_v[dst] = vals[t * tile + i]
    return out_k, out_v


@pytest.mark.parametrize("rb", range(1, 9))
@pytest.mark.parametrize("with_vals", [False, True])
def test_scatter_kernel_rank_order_emulated_matches_twin(rb, with_vals):
    """The kernel's in-tile rank order, emulated, against the twin: 1500
    keys (a fifth SENTINEL, a run of equal keys) on tiles of 640, held by
    the (8 warps, 8 items) instantiation: the last tile is ragged and
    rounds end mid-warp."""
    n, tile, shift = 1500, 640, 3
    rng = np.random.default_rng(rb)
    keys = rng.integers(0, 1 << 12, n).astype(np.int32)
    keys[rng.random(n) < 0.2] = SEN
    keys[200:500] = 77
    vals = np.arange(n, dtype=np.int32) if with_vals else None
    counts = trs.digit_hist(_t(keys), shift, tile, rb)
    offsets = trs.digit_offsets(counts)
    want_k, want_v = trs.digit_scatter(
        _t(keys), None if vals is None else _t(vals), offsets, shift, tile,
        rb)
    got_k, got_v = _emulated_scatter(keys, vals, offsets.numpy(), shift,
                                     tile, rb)
    np.testing.assert_array_equal(got_k, want_k.numpy())
    if with_vals:
        np.testing.assert_array_equal(got_v, want_v.numpy())
    # the histogram's layout: bucket-major, counts[b * T + t]
    d = (keys >> shift) & ((1 << rb) - 1)
    t_of = np.arange(n) // tile
    np.testing.assert_array_equal(
        counts.numpy().reshape(1 << rb, -1),
        np.array([[np.sum((d == b) & (t_of == t)) for t in range(3)]
                  for b in range(1 << rb)]))


def test_wrappers_refuse_what_the_kernels_cannot_take():
    """Digit widths outside 1..8 and offsets of the wrong length raise on
    any device."""
    k = torch.zeros(100, dtype=torch.int32)
    with pytest.raises(ValueError, match="radix_bits"):
        trs.digit_hist(k, 0, 64, 9)
    with pytest.raises(ValueError, match="radix_bits"):
        trs.digit_hist(k, 0, 64, 0)
    with pytest.raises(ValueError, match="offsets"):
        trs.digit_scatter(k, None, torch.zeros(5, dtype=torch.int32), 0, 64,
                          4)
    with pytest.raises(ValueError, match="multiple of tile"):
        trs.global_digit_pass(k, None, 0, tile=64)
    assert trs.digit_pass_shape(1) == (4, 4)
    assert trs.digit_pass_shape(trs.SCATTER_TILE) == (16, 8)
    assert trs.digit_pass_shape(trs.MAX_DIGIT_TILE + 1) is None
