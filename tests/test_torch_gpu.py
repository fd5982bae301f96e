"""Card-only checks of the hand-written kernels (marker ``gpu``): each
integer CUDA kernel equals its plain-torch twin element for element, the
segment sum is within rtol = 1e-5, atol = 1e-4 of its float64 twin and
gives the same bits on every launch, the flash kernel is within 2e-5 of
its twin in float32 and within one bf16 ulp in bf16, the flash backward
kernels are within 1e-5 of the twin's largest value in float32 and one
bf16 ulp plus 1e-3 of it in bf16 and give the same bits on every launch,
the segment sum is also within its derived tolerance of the twin on one
2^17-edge span, every edge live, every edge SENTINEL, and through a
gather index with the mean, and gives the pointer segment sum's bits on
the same spans, the set count equals its twin and searchsorted up to the
convert's shape
and gives the same bits twice, as does the bf16 flash forward, the
wrappers refuse what the kernels cannot take, both serve paths on
the card give the integers the CPU path gives, and the gemma2 smoke
prefill and train step on the card give the CPU's results. The column
scan is within its derived tolerance of its twin; the serve engine's
captured step, replayed for new waves, equals the eager step bit for bit
and advances the launch counters by its captured launches; so do the
GAT, GatedGCN and MeshGraphNet steps, also under keysort selection, and
their logits on the card are within 1e-4 of the CPU's; keysort and
reservoir sampling on the card give the CPU's subgraphs; a streamed
update is copied into the captured step's graph. The decode attention
kernel is within its derived tolerance (``twin_tolerance``) of its twin
at every cache dtype, q dtype, cap, window and length tried, gives the
same bits twice and a slot's bits alone and beside other slots, its
narrower copies of an unaligned cache give the bits of its 16-byte ones,
and its tolerance rejects four planted faults; the LM ServeEngine served through
its captured step gives the CPU's tokens (bf16 and int8 caches), counts
two decode launches a layer a replay, and its replayed step equals the
eager step bit for bit. At the other LM configs' heads: the bf16 flash
forward at 16 over 8, dh 64 and 32 over 32, dh 128 (no cap, no window,
ragged lengths) within one bf16 ulp; the decode kernel on a bf16 cache
at those heads and an int8 one at 40 over 40 and 48 over 8, dh 128,
within ``twin_tolerance``; granite-moe's smoke engine captured once (its
MoE dispatch reads nothing on the host), its tokens the CPU engine's.
Every test skips with a reason on a host without a card or nvcc.

Run them on a machine with an H100:
  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import ctypes
import dataclasses
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core import pipeline as tp  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.ordering import merge_round_fan_ins  # noqa: E402
from repro_torch.core.set_count import filter_lookup  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import prefix_partition as tpp  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels import merge as tm  # noqa: E402
from repro_torch.kernels import radix_sort as trs  # noqa: E402
from repro_torch.kernels import reindex_epilogue as tre  # noqa: E402
from repro_torch.kernels import segment_agg as tsa  # noqa: E402
from repro_torch.kernels import set_count as tsc  # noqa: E402

pytestmark = pytest.mark.gpu

SEN = 0x7FFFFFFF
SLICE_CFG = tcm.EngineConfig(use_pallas=True, sort_strategy="global_radix",
                             reindex_strategy="fused")
MERGE_CFG = tcm.EngineConfig(use_pallas=True, sort_strategy="chunked_merge",
                             reindex_strategy="unfused")
SLICE_KERNELS = ("digit_hist", "digit_scatter", "rank_search", "rename")
NEW_KERNELS = ("chunk_sort", "fused_merge", "merge_rung", "set_count_less",
               "segment_sum_sorted")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    try:
        _build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda")


def _keys(n, rb, seed, sentinel_frac):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 1 << (3 * rb), n).astype(np.int32)
    k[rng.random(n) < sentinel_frac] = SEN
    return torch.from_numpy(k)


@pytest.mark.parametrize("rb", [2, 4, 8])
@pytest.mark.parametrize("with_vals", [False, True])
@pytest.mark.parametrize("n,tile", [(1, 1), (4096, 4096), (1 << 16, 4096),
                                    (3000, 1000)])
def test_digit_pass_kernels_equal_twins(cuda, rb, with_vals, n, tile):
    keys = _keys(n, rb, seed=rb + n, sentinel_frac=0.3)
    vals = torch.arange(n, dtype=torch.int32) if with_vals else None
    for shift in (0, rb):
        want = trs.digit_partition_hist(keys, vals, shift, tile, rb)
        got = trs.digit_partition_hist(
            keys.to(cuda), None if vals is None else vals.to(cuda), shift,
            tile, rb)
        torch.cuda.synchronize()
        for w, g in zip(want, got):
            if w is None:
                assert g is None
            else:
                assert torch.equal(g.cpu(), w)
        _, _, lbase, hist = want
        incl = torch.cumsum(hist, 0, dtype=torch.int32)
        excl = incl - hist
        gbase = torch.cumsum(incl[-1], 0, dtype=torch.int32) - incl[-1]
        src = trs.digit_rank_gather(gbase, incl, excl, lbase, tile)
        src_k = trs.digit_rank_gather(*(x.to(cuda) for x in
                                        (gbase, incl, excl, lbase)), tile)
        assert torch.equal(src_k.cpu(), src)


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("queries", ["shuffled", "sorted", "sorted_but_one"])
@pytest.mark.parametrize("runs", [False, True])
@pytest.mark.parametrize("n,nq", [(1, 4), (600, 300), (282_624, 563_200),
                                  (400_000, 300_000), (1 << 20, 100_000)])
def test_rank_and_rename_kernels_equal_twins(cuda, side, queries, runs, n,
                                             nq):
    """rank_search and rename on the card equal their twins bit for bit on
    non-decreasing streams with a SENTINEL tail, up to a request's VID
    stream (282,624) and past it, with shuffled, sorted and almost sorted
    queries; ``runs`` puts duplicate runs of a fifth and a tenth of the
    stream in it."""
    rng = np.random.default_rng(n + nq)
    arr = np.sort(rng.integers(0, max(2, n // 3), n)).astype(np.int32)
    if runs:
        arr[:n // 5] = 7
        arr[n // 5:n // 5 + n // 10] = n // 6
        arr = np.sort(arr)
    arr[n // 2 + 1:] = SEN
    q = rng.integers(-5, n // 3 + 5, nq).astype(np.int32)
    q[rng.random(nq) < 0.2] = SEN
    if queries != "shuffled":
        q = np.sort(q)
    if queries == "sorted_but_one":
        q[nq // 2] = -9
    table = np.arange(n, dtype=np.int32) * 3
    a, qq, tb = map(torch.from_numpy, (arr, q, table))
    assert torch.equal(tre.rank_search(a.to(cuda), qq.to(cuda), side).cpu(),
                       tre.rank_search(a, qq, side))
    assert torch.equal(
        tre.rename(a.to(cuda), tb.to(cuda), qq.to(cuda)).cpu(),
        tre.rename(a, tb, qq))


def test_rank_kernels_on_an_unaligned_stream_and_no_queries(cuda):
    """A stream that starts 4 bytes past a 16-byte boundary (a view from
    element 1), and zero queries, which launch nothing."""
    rng = np.random.default_rng(3)
    arr = np.sort(rng.integers(0, 50_000, 200_001)).astype(np.int32)
    arr[150_000:] = SEN
    q = rng.integers(-3, 50_003, 250_000).astype(np.int32)
    a, qq = torch.from_numpy(arr), torch.from_numpy(q)
    view = a.to(cuda)[1:]
    tb = torch.arange(view.numel(), dtype=torch.int32, device=cuda)
    assert view.data_ptr() % 16 == 4
    assert torch.equal(tre.rank_search(view, qq.to(cuda)).cpu(),
                       tre.rank_search(a[1:], qq))
    assert torch.equal(tre.rename(view, tb, qq.to(cuda)).cpu(),
                       tre.rename(a[1:], tb.cpu(), qq))
    before = launch_counts()
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    assert tre.rank_search(view, empty).numel() == 0
    assert tre.rename(view, tb, empty).numel() == 0
    assert launch_counts() == before


def test_rank_kernels_count_each_launch(cuda):
    """A call is one launch, counted once."""
    for n in (1000, 400_000):
        a = torch.arange(n, dtype=torch.int32, device=cuda)
        q = torch.arange(0, n, 7, dtype=torch.int32, device=cuda)
        before = launch_counts()
        tre.rank_search(a, q)
        tre.rename(a, a, q)
        after = launch_counts()
        assert after["rank_search"] - before["rank_search"] == 1
        assert after["rename"] - before["rename"] == 1


def test_wrappers_refuse_what_the_kernels_cannot_take(cuda):
    k = torch.zeros(1 << 16, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        trs.digit_partition_hist(k, k, 0, 1 << 16, 4)
    with pytest.raises(ValueError, match="256 buckets"):
        trs.digit_partition_hist(k, None, 0, 4096, 9)
    with pytest.raises(ValueError, match="int32"):
        tre.rank_search(k.to(torch.int64), k)


def test_serve_path_on_card_equals_cpu(cuda):
    """Convert + sample on the card (kernels) give the CPU twins' integers,
    and every kernel of the path launched."""
    dst, src = tg.random_coo(np.random.default_rng(0), 70000, 200_000)
    coo = tg.COO.from_arrays(dst, src, 70000, capacity=1 << 18, device="cpu")
    reset_launch_counts()
    ref = tp.convert(coo, SLICE_CFG, device="cpu")
    csc = tp.convert(coo, SLICE_CFG, device=cuda)
    assert torch.equal(csc.ptr.cpu(), ref.ptr)
    assert torch.equal(csc.idx.cpu(), ref.idx)
    seeds = torch.tensor([5, 17, 3, 250, 69999, SEN, SEN, SEN],
                         dtype=torch.int32)
    key = prng.fold_in(prng.PRNGKey(0), 3)
    want = tp.sample_subgraph(ref, seeds, (25, 10), key, SLICE_CFG)
    got = tp.sample_subgraph(csc, seeds.to(cuda), (25, 10), key, SLICE_CFG)
    for a, b in ((got.csc.ptr, want.csc.ptr), (got.csc.idx, want.csc.idx),
                 (got.order, want.order)):
        assert torch.equal(a.cpu(), b)
    counts = launch_counts()
    assert all(counts[k] > 0 for k in SLICE_KERNELS), counts
    # the reference's one-to-one pair is held off the path
    assert counts["digit_partition_hist"] == counts["digit_rank_gather"] == 0


@pytest.mark.parametrize("rb", range(1, 9))
@pytest.mark.parametrize("with_vals", [False, True])
@pytest.mark.parametrize("n,tile", [(1, 8192), (3000, 1000), (3000, 8192),
                                    (1 << 16, 8192), (100_003, 4096),
                                    (1 << 18, 16384)])
def test_digit_hist_and_scatter_equal_twins(cuda, rb, with_vals, n, tile):
    """The card's digit pass, kernel by kernel, against the twins at every
    digit width: bucket-major counts, then the scatter by the same
    offsets, on ragged last tiles and a SENTINEL tail."""
    keys = _keys(n, rb, seed=rb + n, sentinel_frac=0.3)
    keys[-(n // 3):] = SEN
    vals = torch.arange(n, dtype=torch.int32) if with_vals else None
    for shift in (0, rb, 31 - rb):
        want_c = trs.digit_hist(keys, shift, tile, rb)
        got_c = trs.digit_hist(keys.to(cuda), shift, tile, rb)
        torch.cuda.synchronize()
        assert torch.equal(got_c.cpu(), want_c)
        offsets = trs.digit_offsets(want_c)
        want = trs.digit_scatter(keys, vals, offsets, shift, tile, rb)
        got = trs.digit_scatter(keys.to(cuda), None if vals is None
                                else vals.to(cuda), offsets.to(cuda), shift,
                                tile, rb)
        torch.cuda.synchronize()
        for w, g in zip(want, got):
            if w is None:
                assert g is None
            else:
                assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("with_vals", [False, True])
@pytest.mark.parametrize("n", [1 << 20, 1 << 24])
def test_card_global_radix_sort_equals_torch_sort(cuda, n, with_vals):
    """The card's global_radix sort (``radix_sort_fn``: 3 passes of 7, 7
    and 6 bits for Reddit's 232,965 key bound) against one stable
    ``torch.sort``, and one launch of each kernel a pass."""
    from repro_torch.core.ordering import (global_radix_sort_by_key,
                                           xla_stable_sort_by_key)
    bound = 232_965
    g = torch.Generator(device=cuda).manual_seed(n)
    keys = torch.randint(0, bound + 1, (n,), generator=g, device=cuda,
                         dtype=torch.int32)
    keys[n // 2:n // 2 + n // 8] = SEN
    vals = (torch.arange(n, dtype=torch.int32, device=cuda) if with_vals
            else None)
    reset_launch_counts()
    got = global_radix_sort_by_key(keys, vals, bound, radix_bits=4,
                                   radix_sort_fn=trs.make_radix_sort_fn(4))
    counts = launch_counts()
    want = xla_stable_sort_by_key(keys, vals, bound)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    if with_vals:
        assert torch.equal(got[1], want[1])
    else:
        assert got[1] is None
    assert counts["digit_hist"] == counts["digit_scatter"] == 3, counts
    assert counts["digit_rank_gather"] == 0, counts


def test_digit_scatter_refuses_a_tile_past_shared_memory(cuda):
    k = torch.zeros(1 << 16, dtype=torch.int32, device=cuda)
    off = torch.zeros(16, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        trs.digit_scatter(k, k, off, 0, 1 << 16, 4)


def _chunk_sort_keys(kind, n, key_bits, seed):
    rng = np.random.default_rng(seed)
    if kind == "equal":  # one digit everywhere: only stability orders
        return torch.full((n,), 77, dtype=torch.int32)
    if kind == "negative":
        return torch.from_numpy(rng.integers(-2**31, 2**31, n,
                                             dtype=np.int64).astype(np.int32))
    keys = rng.integers(0, 1 << key_bits, n).astype(np.int32)
    if kind == "high_bits":  # bits above key_bits, which the sort ignores
        keys |= (rng.integers(0, 1 << (31 - key_bits), n) << key_bits
                 ).astype(np.int32)
    return torch.from_numpy(keys)


@pytest.mark.parametrize("rb", [2, 4, 8])
@pytest.mark.parametrize("with_vals", [False, True])
@pytest.mark.parametrize("n,chunk,key_bits", [(512, 128, 12), (4096, 64, 7),
                                              (1 << 19, 4096, 19),
                                              (9000, 3000, 19),
                                              (300, 100, 12)])
@pytest.mark.parametrize("kind", ["uniform", "high_bits", "negative",
                                  "equal"])
def test_chunk_sort_kernel_equals_twin(cuda, rb, with_vals, n, chunk,
                                       key_bits, kind):
    """Every chunk's kernel sort equals the twin's, keys with bits above
    key_bits, negative keys, all-equal keys and chunks that are no multiple
    of the kernel's 32 x warps x items (3000, 100) included."""
    keys = _chunk_sort_keys(kind, n, key_bits, seed=n + rb)
    vals = torch.arange(n, dtype=torch.int32) if with_vals else None
    want = trs.chunk_sort(keys, vals, chunk, key_bits, rb)
    got = trs.chunk_sort(keys.to(cuda), None if vals is None
                         else vals.to(cuda), chunk, key_bits, rb)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0])
    assert (got[1] is None) if vals is None else torch.equal(got[1].cpu(),
                                                             want[1])


def _merge_input(n, run, kind, seed):
    """Sorted runs of ``run``: many ties, one repeated key (stability),
    a SENTINEL tail on half the slots, or an array already sorted."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        keys = rng.integers(0, max(2, n // 8), n)
    elif kind == "equal":
        keys = np.full(n, 7)
    elif kind == "sentinel":
        keys = rng.integers(0, 1000, n)
        keys[rng.random(n) < 0.5] = SEN
    else:
        keys = np.arange(n)
    keys = np.sort(keys.reshape(-1, run), 1).reshape(-1).astype(np.int32)
    return torch.from_numpy(keys)


MERGE_KINDS = ["ties", "equal", "sentinel", "sorted"]


@pytest.mark.parametrize("kind", MERGE_KINDS)
@pytest.mark.parametrize("fan", [2, 4])
@pytest.mark.parametrize("with_vals", [False, True])
@pytest.mark.parametrize("n,run,mb", [(1024, 64, 65536), (1024, 64, 256),
                                      (512, 128, 128), (1 << 19, 4096, 65536),
                                      (3 * 4096, 4096, 65536),
                                      (5 * 1024, 1024, 65536),
                                      (12 * 1024, 1024, 65536),
                                      (3 * 1000, 1000, 4000)])
def test_fused_merge_kernel_equals_twin(cuda, kind, fan, with_vals, n, run,
                                        mb):
    """Fully fused, partly fused and no rung that fits; run counts of 3, 5
    and 12 (rungs of 3 and 5 runs: passes of unequal runs), runs that are
    no multiple of a tile; many ties, one repeated key, a SENTINEL tail
    and sorted input: the kernel equals the twin."""
    keys = _merge_input(n, run, kind, seed=n + run)
    vals = torch.arange(n, dtype=torch.int32) if with_vals else None
    want = tm.fused_merge_rounds(keys, vals, run, max_block=mb, fan_in=fan)
    got = tm.fused_merge_rounds(keys.to(cuda), None if vals is None
                                else vals.to(cuda), run, max_block=mb,
                                fan_in=fan)
    torch.cuda.synchronize()
    assert got[2] == want[2]
    assert torch.equal(got[0].cpu(), want[0])
    assert (got[1] is None) if vals is None else torch.equal(got[1].cpu(),
                                                             want[1])


@pytest.mark.parametrize("kind", MERGE_KINDS)
@pytest.mark.parametrize("with_vals", [False, True])
@pytest.mark.parametrize("n,run,k", [(1 << 19, 65536, 2), (1 << 19, 1 << 18, 2),
                                     (1 << 17, 64, 2), (3 * 4096, 4096, 3),
                                     (5 * 1024, 1024, 5), (12 * 1024, 1024, 4),
                                     (3000, 1000, 3), (1 << 16, 8192, 8)])
def test_merge_rung_kernel_equals_twin(cuda, kind, with_vals, n, run, k):
    """One rung on the card (ceil(log2 k) merge-path passes) equals the
    plain rung ``merge_sorted_k``, bit for bit, and leaves its input as it
    was; one launch a call."""
    keys = _merge_input(n, run, kind, seed=n + run + k)
    vals = torch.arange(n, dtype=torch.int32) * 3 if with_vals else None
    want = tm.merge_rung(keys, vals, run, k)
    kc = keys.to(cuda)
    vc = None if vals is None else vals.to(cuda)
    before = tm.merge_rung.launches
    got = tm.merge_rung(kc, vc, run, k)
    torch.cuda.synchronize()
    assert tm.merge_rung.launches == before + 1
    assert torch.equal(got[0].cpu(), want[0])
    assert (got[1] is None) if vals is None else torch.equal(got[1].cpu(),
                                                             want[1])
    assert torch.equal(kc.cpu(), keys)


@pytest.mark.parametrize("e,t,shuffle", [(2048, 256, True), (1000, 300, True),
                                         (1 << 19, 282_625, False),
                                         (1 << 19, 282_625, True)])
def test_set_count_kernel_equals_twin(cuda, e, t, shuffle):
    """At serve scale: the sorted subgraph dst with its SENTINEL tail, and
    the same elements shuffled (the kernel must not rely on order)."""
    rng = np.random.default_rng(e + t)
    elems = np.full(e, SEN, np.int32)
    elems[:e // 2 + 3] = np.sort(rng.integers(0, t, e // 2 + 3))
    if shuffle:
        rng.shuffle(elems)
    el = torch.from_numpy(elems).to(cuda)
    tg_ = torch.arange(t, dtype=torch.int32, device=cuda)
    got = tsc.set_count_less(el, tg_)
    want = tsc.count_fn(el.cpu(), tg_.cpu()) if e * t < 1 << 26 else \
        torch.searchsorted(torch.sort(el).values, tg_, out_int32=True)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want.cpu())
    assert torch.equal(tsc.count_fn(el, tg_), got)


@pytest.mark.parametrize("shuffle", [False, True])
def test_set_count_kernel_at_convert_shape(cuda, shuffle):
    """Reddit's pointer build: 232,966 targets over 2^24 elements (a
    power-law sorted dst with a SENTINEL tail), then the same shuffled;
    equal to the all-pairs twin and to searchsorted."""
    n_nodes, e = 232_965, 1 << 24
    g = torch.Generator(device=cuda).manual_seed(5)
    w = torch.arange(1, n_nodes + 1, device=cuda, dtype=torch.float64) ** -1.5
    el = torch.full((e,), SEN, dtype=torch.int32, device=cuda)
    live = e - e // 8
    el[:live] = torch.sort(torch.multinomial(
        w, live, replacement=True, generator=g).to(torch.int32)).values
    want = torch.searchsorted(el, torch.arange(
        n_nodes + 1, dtype=torch.int32, device=cuda), out_int32=True)
    if shuffle:
        el = el[torch.randperm(e, generator=g, device=cuda)]
    tg_ = torch.arange(n_nodes + 1, dtype=torch.int32, device=cuda)
    got = tsc.set_count_less(el, tg_)
    twin = tsc.count_less_than(el, tg_)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, twin)



def test_set_count_counts_both_launches_and_its_work(cuda):
    """One call launches the tile sort and the count and counts both; the
    C entries refuse a scratch one tile short; the work the kernels count
    is the sort network's and one bisection per (target, tile) pair whose
    (min, max] holds the target, and counting it changes no count."""
    rng = np.random.default_rng(3)
    n, t = 3 * tsc.SORT_TILE + 5, 3000
    el = torch.from_numpy(rng.integers(-5000, 5000, n).astype(np.int32)
                          ).to(cuda)
    tg_ = torch.from_numpy(rng.integers(-6000, 6000, t).astype(np.int32)
                           ).to(cuda)
    reset_launch_counts()
    want = tsc.set_count_less(el, tg_)
    assert launch_counts()["set_count_less"] == 2
    tsc.set_count_less(el[:0], tg_)
    assert launch_counts()["set_count_less"] == 3  # no tile to sort
    lib = _build.load("set_count", tsc._SIGNATURES)
    tiles, bounds = tsc.set_count_scratch(n, cuda)
    out = torch.zeros_like(tg_)
    assert tsc.tile_sort_c(lib, el, tiles[:-1], bounds) != 0
    assert tsc.count_c(lib, n, tg_, out, tiles, bounds[:-1]) != 0
    work = torch.zeros(4, dtype=torch.int64, device=cuda)
    assert tsc.tile_sort_c(lib, el, tiles, bounds, work) == 0
    assert tsc.count_c(lib, n, tg_, out, tiles, bounds, work) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    lg = tsc.SORT_TILE.bit_length() - 1
    n_tiles = -(-n // tsc.SORT_TILE)
    sort_cmp, _, bisections, copies = work.tolist()
    assert sort_cmp == n_tiles * tsc.SORT_TILE // 2 * lg * (lg + 1) // 2
    tv = tiles.view(n_tiles, tsc.SORT_TILE)
    assert torch.equal(bounds.view(n_tiles, 2),
                       torch.stack([tv[:, 0], tv[:, -1]], 1))
    straddle = ((tg_[:, None] > tv[None, :, 0])
                & (tg_[:, None] <= tv[None, :, -1]))
    assert bisections == int(straddle.sum())
    assert 0 < copies <= n_tiles * -(-t // 512)

MMA_RULE_CU = r"""
#include <cuda_bf16.h>
#include <stdint.h>
// d = c + sum_i a[i] * 1 over one row of one mma.sync.m16n8k16 (bf16 in,
// float32 accumulate); every other row and column is zero
__global__ void k(const __nv_bfloat16* a, float c, float* d) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const __nv_bfloat16 z = __float2bfloat16(0.f), one = __float2bfloat16(1.f);
  auto pk = [](__nv_bfloat16 lo, __nv_bfloat16 hi) {
    __nv_bfloat162 v; v.x = lo; v.y = hi;
    return *reinterpret_cast<uint32_t*>(&v); };
  const uint32_t a0 = g ? 0u : pk(a[2 * t], a[2 * t + 1]);
  const uint32_t a2 = g ? 0u : pk(a[2 * t + 8], a[2 * t + 9]);
  const uint32_t b = g ? pk(z, z) : pk(one, one);
  float d0 = (g == 0 && t == 0) ? c : 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
               : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
               : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b), "r"(b));
  if (lane == 0) *d = d0;
}
extern "C" int run(const void* a, float c, void* d) {
  k<<<1, 32>>>((const __nv_bfloat16*)a, c, (float*)d);
  return (int)cudaDeviceSynchronize();
}
"""


def test_tensor_core_accumulation_rule(cuda, tmp_path):
    """The rule the bf16 flash kernel's precision design rests on
    (csrc/flash_attention.cu): mma.sync bf16 -> float32 aligns the
    products and C to the largest addend with 25 fraction bits, drops the
    rest toward zero, and truncates the sum to float32. So a float32 sum
    must not ride an MMA chain where its low bits matter."""
    src, lib = tmp_path / "mma_rule.cu", tmp_path / "libmma_rule.so"
    src.write_text(MMA_RULE_CU)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    run = ctypes.CDLL(str(lib)).run
    run.argtypes = [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]

    def mma(row, c=0.0):
        a = torch.zeros(16, dtype=torch.float64)
        a[:len(row)] = torch.tensor(row, dtype=torch.float64)
        a = a.bfloat16().to(cuda)
        d = torch.zeros(1, device=cuda)
        assert run(a.data_ptr(), c, d.data_ptr()) == 0
        return float(d)

    assert mma([1.0] + [2 ** -25] * 15) == 1 + 3 * 2 ** -23  # exact: 3.75
    assert mma([1.0, 2 ** -24]) == 1.0                  # rounded: 1 + 2^-23
    assert mma([1.0, -2 ** -27]) == 1.0                 # toward zero
    assert mma([-1.0, 2 ** -30], 1.0) == 0.0            # exact: 2^-30
    assert mma([1.5 * 2 ** -24] * 16, 1.0) == 1 + 12 * 2 ** -23  # exact


def test_redesigned_kernels_are_bit_deterministic(cuda):
    """Two launches of the tile-sort set count (sorted and shuffled
    elements), of the bf16 tensor-core flash forward (out and lse) and of
    the bf16 tensor-core backward kernels (dq, dk, dv; at dh 256 the dk/dv
    kernel's warp pairs swap their sums through shared memory) give the
    same bits."""
    rng = np.random.default_rng(11)
    el = torch.from_numpy(rng.integers(-1000, 1000, 300_000).astype(
        np.int32)).to(cuda)
    tg_ = torch.from_numpy(rng.integers(-1100, 1100, 70_000).astype(
        np.int32)).to(cuda)
    for elems in (el, torch.sort(el).values):
        assert torch.equal(tsc.set_count_less(elems, tg_),
                           tsc.set_count_less(elems, tg_))
    mask = dict(causal=True, window=100, logit_cap=50.0, q_offset=0)
    for dh in (64, 256):
        q, k, v = (t.to(cuda) for t in _qkv(dh, 1, 4, 2, 512, 512, dh,
                                            torch.bfloat16))
        a = tfa._fwd_kernel(q * 8, k, v, lse=True, **mask)
        b = tfa._fwd_kernel(q * 8, k, v, lse=True, **mask)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        _, lse, out = a  # the float32 out, the backward's residual
        dout = torch.randn(out.shape, generator=torch.Generator(
            device=cuda).manual_seed(dh), device=cuda).bfloat16()
        a = tfa.flash_attention_bwd(q * 8, k, v, out, lse, dout, **mask)
        b = tfa.flash_attention_bwd(q * 8, k, v, out, lse, dout, **mask)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("e,n,d", [(512, 256, 1), (300, 77, 5),
                                   (512, 256, 130), (1 << 19, 282_624, 602),
                                   (1 << 19, 282_624, 1)])
def test_segment_sum_kernel_equals_twin_and_is_deterministic(cuda, e, n, d):
    rng = np.random.default_rng(e + d)
    dst = np.full(e, SEN, np.int32)
    dst[:e // 2 + 1] = np.sort(rng.integers(0, n, e // 2 + 1))
    dst_c = torch.from_numpy(dst).to(cuda)
    msgs = torch.randn((e, d), generator=torch.Generator(device=cuda
                                                         ).manual_seed(d),
                       device=cuda)
    got = tsa.segment_sum_sorted(dst_c, msgs, n)
    want = tsa.segment_sum_sorted(dst_c.cpu(), msgs.cpu(), n)
    again = tsa.segment_sum_sorted(dst_c, msgs, n)
    torch.cuda.synchronize()
    assert torch.allclose(got.cpu(), want, rtol=1e-5, atol=1e-4)
    assert torch.equal(got, again)


def _segment_case(kind, e, n, d, n_x, seed):
    """(dst, x, rows) for the segment sum: ``long`` one node of 2^17 edges
    among short ones and a SENTINEL tail, ``live`` every edge into [0, n),
    ``sentinel`` every edge SENTINEL, ``ragged`` empty nodes and a tail,
    ``gaps`` edges into every 97th node only (runs of 96 empty nodes, a
    CTA's to write) and a tail;
    with ``n_x``, x is [n_x, d] read through rows (every 50th out of
    range: clamped), N(0, 1) + 3 so that the sums drift."""
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, n, e)).astype(np.int32)
    if kind == "long":
        dst[:1 << 17] = n // 2
        dst = np.sort(dst)
    if kind == "long":
        dst[e - e // 16:] = SEN
    if kind == "gaps":
        dst = np.sort(rng.choice(np.arange(0, n, 97), e)).astype(np.int32)
    if kind in ("ragged", "gaps"):
        dst[e - e // 3:] = SEN
    if kind == "ragged":
        dst[:e - e // 3] = np.sort(rng.choice(np.arange(0, n, 3),
                                              e - e // 3))
    if kind == "sentinel":
        dst[:] = SEN
    x = (rng.normal(size=(n_x or e, d)) + 3).astype(np.float32)
    rows = None
    if n_x:
        rows = rng.integers(0, n_x, e).astype(np.int32)
        rows[::50] = SEN
        rows = torch.from_numpy(rows)
    return torch.from_numpy(dst), torch.from_numpy(x), rows


@pytest.mark.parametrize("kind,e,n,d,n_x,mean", [
    ("long", 1 << 18, 4096, 1, 0, False),
    ("long", 1 << 18, 4096, 602, 0, True),
    ("long", 300_000, 5000, 70, 5000, True),
    ("live", 1 << 19, 282_624, 602, 0, False),
    ("live", 262_144, 169_984, 1, 0, False),
    ("sentinel", 262_144, 169_984, 70, 0, False),
    ("sentinel", 4096, 300, 1, 300, True),
    ("ragged", 262_144, 169_984, 70, 0, False),
    ("ragged", 262_144, 169_984, 128, 0, True),
    ("ragged", 524_288, 282_624, 602, 282_624, True),
    ("ragged", 524_288, 282_624, 128, 282_624, True),
    ("ragged", 200_000, 50_000, 8, 30_000, False),
    ("ragged", 100_003, 20_000, 37, 0, False),
    ("ragged", 5000, 1, 1, 0, True),
    ("gaps", 262_144, 169_984, 70, 0, False),
    ("gaps", 100_000, 2_000_000, 1, 30_000, True)])
def test_segment_sum_kernel_on_spans_gather_and_mean(cuda, kind, e, n, d,
                                                     n_x, mean):
    """The segment sum within ``twin_tolerance`` (derived from float32
    rounding) of its twin at D 1, 8, 37, 70, 128 and 602: one span of 2^17
    edges, every edge live, every edge SENTINEL, empty nodes and a
    SENTINEL tail, long runs of empty nodes, through a gather index and
    with the mean, n = 1; two
    launches give the same bits, one call counts one launch, and the
    bits are the pointer segment sum's on the same spans (one body)."""
    from repro_torch.kernels import ptr_scan
    dst, x, rows = _segment_case(kind, e, n, d, n_x, seed=e + d + n)
    want = tsa.segment_sum_sorted(dst, x, n, rows, mean)
    tol = tsa.twin_tolerance(dst, x, n, rows, mean)
    args = (dst.to(cuda), x.to(cuda), n,
            None if rows is None else rows.to(cuda), mean)
    before = tsa.segment_sum_sorted.launches
    got = tsa.segment_sum_sorted(*args)
    again = tsa.segment_sum_sorted(*args)
    ptr = torch.searchsorted(args[0], torch.arange(
        n + 1, dtype=torch.int32, device=cuda), out_int32=True)
    spans = ptr_scan.ptr_seg_sum(ptr, args[1], args[3], mean)
    torch.cuda.synchronize()
    assert tsa.segment_sum_sorted.launches == before + 2
    assert torch.equal(got, again) and torch.equal(got, spans)
    err = (got.cpu().double() - want.double()).abs()
    assert bool((err <= tol).all()), float((err / tol.clamp_min(1e-30)).max())


def test_new_wrappers_refuse_what_the_kernels_cannot_take(cuda):
    k = torch.zeros(1 << 15, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        trs.chunk_sort(k, k, 1 << 15, 16, 4)
    with pytest.raises(ValueError, match="int32"):
        trs.chunk_sort(k.to(torch.int64), None, 4096, 16, 4)
    with pytest.raises(ValueError, match="int32"):
        tm.fused_merge_rounds(k, k.cpu(), 64)
    with pytest.raises(ValueError, match="int32"):
        tm.fused_merge_rounds(k.float(), None, 64)
    with pytest.raises(ValueError, match="int32"):
        tm.fused_merge_rounds(k.view(-1, 2).t()[0], None, 64)
    with pytest.raises(ValueError, match="int32"):
        tm.merge_rung(k.float(), None, 64, 2)
    with pytest.raises(ValueError, match="int32"):
        tm.merge_rung(k[::2], None, 64, 2)
    with pytest.raises(ValueError, match="int32"):
        tm.merge_rung(k, k.cpu(), 64, 2)
    with pytest.raises(ValueError, match="does not tile"):
        tm.merge_rung(k, None, 3000, 2)
    with pytest.raises(ValueError, match="int32"):
        tsc.set_count_less(k, k.cpu())
    with pytest.raises(ValueError, match="int32"):
        tsc.set_count_less(k.to(torch.int64), k)
    with pytest.raises(ValueError, match="float32"):
        tsa.segment_sum_sorted(k, torch.zeros((1 << 15, 2), device=cuda,
                                              dtype=torch.float64), 8)


def test_merge_serve_path_on_card_equals_cpu(cuda):
    """Convert, sample and the use_pallas_agg forward under the merge
    configuration on the card give the CPU twins' integers (logits within
    1e-4), and each new kernel launched."""
    from repro_torch.configs.graphsage_reddit import smoke_config
    from repro_torch.models.gnn import GraphSAGE, subgraph_batch
    dst, src = tg.random_coo(np.random.default_rng(0), 70000, 200_000)
    coo = tg.COO.from_arrays(dst, src, 70000, capacity=1 << 18, device="cpu")
    reset_launch_counts()
    ref = tp.convert(coo, MERGE_CFG, device="cpu")
    csc = tp.convert(coo, MERGE_CFG, device=cuda)
    # two sorts (two-pass keys), each: runs of 4096 fused to 65,536, then
    # one rung launch a rung up to the capacity
    rungs = len(merge_round_fan_ins(1 << 18, tm.DEFAULT_MAX_BLOCK, 2))
    assert launch_counts()["merge_rung"] == 2 * rungs == 4
    assert launch_counts()["fused_merge"] == 2
    assert torch.equal(csc.ptr.cpu(), ref.ptr)
    assert torch.equal(csc.idx.cpu(), ref.idx)
    seeds = torch.tensor([5, 17, 3, 250, 69999, SEN, SEN, SEN],
                         dtype=torch.int32)
    key = prng.fold_in(prng.PRNGKey(0), 3)
    want = tp.sample_subgraph(ref, seeds, (25, 10), key, MERGE_CFG)
    got = tp.sample_subgraph(csc, seeds.to(cuda), (25, 10), key, MERGE_CFG)
    for a, b in ((got.csc.ptr, want.csc.ptr), (got.csc.idx, want.csc.idx),
                 (got.order, want.order)):
        assert torch.equal(a.cpu(), b)
    gcfg = dataclasses.replace(smoke_config(), use_pallas_agg=True)
    model = GraphSAGE(gcfg, d_in=12, n_classes=5,
                      generator=torch.Generator().manual_seed(0), device="cpu")
    feats = torch.randn((70000, 12), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        lc = model(subgraph_batch(want, feats))
        lg = model.to(cuda)(subgraph_batch(got, feats.to(cuda)))
    assert torch.allclose(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    counts = launch_counts()
    assert all(counts[k] > 0 for k in NEW_KERNELS), counts


# --------------------------------------------------- LM prefill slice
# (rtol, atol): float32 at the reference's 2e-5; in bf16 the kernel and the
# twin both work in float32 and round once, so they may differ by one bf16
# ulp of the output (2^-7 of it at most) plus float32 sums that cancel
# near zero (1e-5)
FLASH_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2 ** -7, 1e-5)}


def _qkv(seed, b, h, hkv, sq, skv, dh, dtype):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(shape, generator=g).to(dtype)
                 for shape in ((b, h, sq, dh), (b, hkv, skv, dh),
                               (b, hkv, skv, dh)))


def _flash_both(cuda, q, k, v, **kw):
    want = tfa.flash_attention_bhsd(q, k, v, **kw)
    got = tfa.flash_attention_bhsd(q.to(cuda), k.to(cuda), v.to(cuda), **kw)
    torch.cuda.synchronize()
    return got.cpu(), want


@pytest.mark.parametrize("causal,window,cap", [
    (True, None, None), (False, None, None), (True, 16, None),
    (True, None, 50.0), (True, 40, 50.0), (False, 24, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 32, 64, 128, 256])
def test_flash_kernel_equals_twin(cuda, causal, window, cap, dtype, dh):
    q, k, v = _qkv(dh, 2, 4, 2, 128, 128, dh, dtype)
    got, want = _flash_both(cuda, q, k, v, causal=causal, window=window,
                            logit_cap=cap, kv_block=64)
    assert got.dtype == dtype
    rtol, atol = FLASH_TOL[dtype]
    assert torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("window", [None, 48])
def test_flash_kernel_q_offset_and_longer_kv(cuda, window):
    """A chunk of 64 queries at positions 128..191 over 256 keys."""
    q, k, v = _qkv(7, 1, 4, 1, 64, 256, 64, torch.float32)
    got, want = _flash_both(cuda, q, k, v, causal=True, window=window,
                            logit_cap=50.0, q_offset=128, kv_block=64)
    assert torch.allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dh", [64, 128, 256])
@pytest.mark.parametrize("window", [None, 48])
def test_flash_kernel_q_offset_and_longer_kv_bf16(cuda, window, dh):
    """The same chunked-prefill layout through the bf16 tensor-core
    kernel (whose kv tile shrinks with dh): 64 queries at 128..191 over
    256 keys, q x 8 so that the cap acts, within one bf16 ulp."""
    q, k, v = _qkv(7, 1, 4, 1, 64, 256, dh, torch.float32)
    q, k, v = (q * 8).bfloat16(), k.bfloat16(), v.bfloat16()
    got, want = _flash_both(cuda, q, k, v, causal=True, window=window,
                            logit_cap=50.0, q_offset=128, kv_block=64)
    assert got.dtype == torch.bfloat16
    rtol, atol = FLASH_TOL[torch.bfloat16]
    assert torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("window", [None, 4096])
def test_flash_kernel_at_gemma2_head_shapes(cuda, window):
    """gemma2-9b's heads (16 over 8 kv heads, dh 256, cap 50) at 8192
    tokens in bf16: a global layer and a local (window 4096) one. The
    queries are scaled by 8, so that the scores (about N(0, 8^2)) reach
    the range where the cap of 50 acts."""
    q, k, v = _qkv(8, 1, 16, 8, 8192, 8192, 256, torch.float32)
    q, k, v = (q * 8).bfloat16(), k.bfloat16(), v.bfloat16()
    got, want = _flash_both(cuda, q, k, v, causal=True, window=window,
                            logit_cap=50.0)
    rtol, atol = FLASH_TOL[torch.bfloat16]
    assert torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol)
    assert bool(torch.isfinite(got.float()).all())


def test_flash_kernel_refuses_what_it_cannot_take(cuda):
    q, k, v = (t.to(cuda) for t in _qkv(0, 1, 2, 1, 64, 64, 64,
                                        torch.float32))
    with pytest.raises(ValueError, match="dh"):
        big = torch.zeros((1, 2, 64, 512), device=cuda)
        tfa.flash_attention_bhsd(big, big[:, :1], big[:, :1])
    with pytest.raises(ValueError, match="dh"):
        odd = torch.zeros((1, 2, 64, 48), device=cuda)
        tfa.flash_attention_bhsd(odd, odd[:, :1], odd[:, :1])
    # a length that is no multiple of the tile launches (ragged tiles)
    got = tfa.flash_attention_bhsd(q[:, :, :32].contiguous(), k, v)
    want = tfa.flash_attention_bhsd(q[:, :, :32].cpu(), k.cpu(), v.cpu())
    torch.cuda.synchronize()
    assert torch.allclose(got.cpu(), want, rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="bf16 or float32"):
        tfa.flash_attention_bhsd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_bhsd(q.transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="65535"):
        many = torch.zeros((1, 65536, 64, 16), device=cuda)
        tfa.flash_attention_bhsd(many, many[:, :1], many[:, :1])


@pytest.mark.parametrize("n,block,p", [(128, 128, 0.4), (512, 128, 0.4),
                                       (2048, 512, 0.4), (3000, 300, 0.5),
                                       (1 << 20, 1024, 0.3),
                                       (4096, 1024, 0.0), (4096, 1024, 1.0),
                                       (96 * 37, 96, 0.4),
                                       (1000 * 17, 1000, 0.4),
                                       (4100 * 9, 4100, 0.4),
                                       (4100 * 3, 4100, 1.0),
                                       (2049 * 5, 2049, 0.3),
                                       (7 * 1031, 7, 0.5)])
def test_prefix_partition_kernel_equals_twin(cuda, n, block, p):
    rng = np.random.default_rng(n + block)
    vals = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, n,
                                         dtype=np.int64).astype(np.int32))
    cond = torch.from_numpy(rng.random(n) < p)
    want = tpp.prefix_partition(vals, cond, block)
    got = tpp.prefix_partition(vals.to(cuda), cond.to(cuda), block)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("block", [96, 1000, 1024, 4100])
def test_prefix_partition_kernel_on_unaligned_views(cuda, block):
    """Values and flags that start one element past an aligned address
    (the kernel's scalar loads and stores) equal the twin."""
    rng = np.random.default_rng(block)
    n = block * 6
    vals = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, n + 1,
                                         dtype=np.int64).astype(np.int32))
    cond = torch.from_numpy(rng.random(n + 1) < 0.4)
    want = tpp.prefix_partition(vals[1:], cond[1:], block)
    got = tpp.prefix_partition(vals.to(cuda)[1:], cond.to(cuda)[1:], block)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def _filter_inputs(kind, e, t, seed):
    """(keys, payloads, targets): a quarter of the targets hit, the last is
    INT32_MIN (it hits the padding of a ragged key count)."""
    rng = np.random.default_rng(seed)
    if kind == "duplicates":
        keys = rng.integers(0, max(1, e // 4), e).astype(np.int32)
    elif kind == "collide":  # every key starts at group 0 of the table
        bits = tsc.filter_table_bits(e) - tsc.FILTER_GROUP_LOG2
        cand = torch.arange(1, 1 << (bits + 12), dtype=torch.int64)
        keys = cand[tsc.filter_hash(cand, bits) == 0][:e].numpy().astype(
            np.int32)
        keys = rng.permutation(keys)
    else:
        keys = rng.permutation(10 * e)[:e].astype(np.int32)
    if kind == "int32_min" and e:
        keys[rng.permutation(e)[:2]] = [-2**31, -1][:min(2, e)]
    pays = rng.integers(-5, 1 << 30, e).astype(np.int32)
    if kind == "payload_max" and e:
        pays[rng.integers(0, e, e // 4 + 1)] = 2**31 - 1  # wraps: a miss
        pays[rng.integers(0, e, e // 8 + 1)] = -5
    tgts = rng.integers(-10, 10 * e + 20, t).astype(np.int32)
    if e:
        tgts[: t // 4] = keys[rng.integers(0, e, t // 4)]
    tgts[-3:] = [2**31 - 1, -1, -2**31]
    return [torch.from_numpy(a) for a in (keys, pays, tgts)]


@pytest.mark.parametrize("kind,e,t", [
    ("unique", 2048, 256), ("unique", 4096, 128), ("unique", 3000, 300),
    ("unique", 65536, 4096), ("duplicates", 3000, 300),
    ("duplicates", 65536, 4096), ("collide", 256, 300),
    ("collide", 2048, 300), ("int32_min", 3000, 300),
    ("int32_min", 2048, 256), ("payload_max", 65536, 4096),
    ("unique", 0, 300), ("unique", 1, 5), ("unique", 282_624, 563_200)])
def test_filter_tree_lookup_kernel_equals_twin(cuda, kind, e, t):
    """The hash build and probe equal the twin bit for bit: duplicate keys
    (the largest payload), keys that all start at one slot, INT32_MIN and
    -1 keys, payloads INT32_MAX (a miss) and -5, E = 0 and 1, and a
    request's reindex shape (the twin runs on the card there); two launches
    a call."""
    args = _filter_inputs(kind, e, t, seed=e + t + len(kind))
    big = e * t > 1 << 28  # 1.6e11 compares: the twin runs on the card
    want = filter_lookup(*(a.to(cuda) if big else a for a in args))
    before = tsc.filter_tree_lookup.launches
    got = tsc.filter_tree_lookup(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    assert tsc.filter_tree_lookup.launches - before == (2 if e else 1)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())


def test_partition_and_filter_refuse_what_they_cannot_take(cuda):
    v = torch.zeros(1024, dtype=torch.int64, device=cuda)
    c = torch.zeros(1024, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        tpp.prefix_partition(v, c, 256)
    with pytest.raises(ValueError, match="bool"):
        tpp.prefix_partition(v.int(), c.int(), 256)
    with pytest.raises(ValueError, match="multiple of block"):
        tpp.prefix_partition(v.int(), c, 300)
    with pytest.raises(ValueError, match="int32"):
        tsc.filter_tree_lookup(v, v, v)


def test_gemma2_smoke_prefill_on_card_equals_cpu(cuda):
    """The smoke model (float32) at 64 tokens, a multiple of the flash
    tile: the card's logits within 1e-4 of the CPU's (cuBLAS and the
    kernel sum in another order), equal argmax, one flash launch per
    layer."""
    from repro_torch.launch.steps import lm_prefill_cell
    from repro_torch.models.transformer import lm_prefill
    cell = lm_prefill_cell("gemma2-9b", seq_len=64, batch=2, device="cpu",
                           seed=0, smoke=True)
    want = cell.step()
    model = cell.model.to(cuda)
    reset_launch_counts()
    got = lm_prefill(model, cell.tokens.to(cuda))
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention_fwd"] == model.cfg.n_layers
    assert torch.allclose(got.cpu(), want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got.argmax(-1).cpu(), want.argmax(-1))


def test_gemma2_smoke_prefill_at_a_ragged_length_on_card_equals_cpu(cuda):
    """The smoke model (float32) at 100 tokens, no multiple of any flash
    tile, which the reference model takes (its kv_block is min(512, S)):
    the card's logits within 1e-4 of the CPU's, equal argmax."""
    from repro_torch.launch.steps import lm_prefill_cell
    from repro_torch.models.transformer import lm_prefill
    cell = lm_prefill_cell("gemma2-9b", seq_len=100, batch=2, device="cpu",
                           seed=0, smoke=True)
    want = cell.step()
    model = cell.model.to(cuda)
    reset_launch_counts()
    got = lm_prefill(model, cell.tokens.to(cuda))
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention_fwd"] == model.cfg.n_layers
    assert torch.allclose(got.cpu(), want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got.argmax(-1).cpu(), want.argmax(-1))


# ------------------------------------------------- flash backward (training)
# dq, dk, dv of the kernels against the twin on the same (out, lse, dout):
# float32 within BWD_F32_TOL of the twin's largest value; bf16 within one
# bf16 ulp plus BWD_ATOL of the twin's largest value (both round a float32
# sum once, summed in another order; chip_smoke.py states the readings)
BWD_F32_TOL = 1e-5
BWD_RTOL, BWD_ATOL = 2 ** -7, 1e-3


def _bwd_inputs(seed, b, h, hkv, sq, skv, dh, dtype, q_scale=1.0, **mask):
    """(q, k, v, out, lse, dout) on the CPU: out and lse of the forward
    twin."""
    from repro_torch.models.attention import flash_attention_plain
    q, k, v = _qkv(seed, b, h, hkv, sq, skv, dh, torch.float32)
    dout = torch.randn((b, h, sq, dh),
                       generator=torch.Generator().manual_seed(seed + 1))
    q, k, v, dout = ((q * q_scale).to(dtype), k.to(dtype), v.to(dtype),
                     dout.to(dtype))
    out, lse = flash_attention_plain(q, k, v, return_lse=True,
                                     kv_block=64 if skv % 64 == 0 else skv,
                                     out_dtype=torch.float32, **mask)
    return q, k, v, out, lse, dout


def _assert_bwd_close(got, want):
    f32 = got[0].dtype == torch.float32
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        g, w = g.float().cpu(), w.float().cpu()
        assert bool(torch.isfinite(g).all()), name
        top, diff = float(w.abs().max()), (g - w).abs()
        if f32:
            assert float(diff.max()) <= BWD_F32_TOL * top, name
        else:
            assert bool((diff <= BWD_ATOL * top + BWD_RTOL * w.abs()).all()), \
                name


@pytest.mark.parametrize("causal,window,cap", [
    (True, None, None), (False, None, None), (True, 16, None),
    (True, None, 50.0), (True, 40, 50.0), (False, 24, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 32, 64, 128, 256])
def test_flash_bwd_kernels_equal_twin(cuda, causal, window, cap, dtype, dh):
    mask = dict(causal=causal, window=window, logit_cap=cap)
    args = _bwd_inputs(dh, 2, 4, 2, 128, 128, dh, dtype, **mask)
    want = tfa.flash_attention_bwd(*args, kv_block=64, **mask)
    got = tfa.flash_attention_bwd(*(t.to(cuda) for t in args), **mask)
    torch.cuda.synchronize()
    assert all(g.dtype == dtype for g in got)
    _assert_bwd_close(got, want)


@pytest.mark.parametrize("window", [None, 48])
def test_flash_bwd_kernels_q_offset_and_longer_kv(cuda, window):
    """A chunk of 64 queries at positions 128..191 over 256 keys."""
    mask = dict(causal=True, window=window, logit_cap=50.0, q_offset=128)
    args = _bwd_inputs(7, 1, 4, 1, 64, 256, 64, torch.float32, **mask)
    want = tfa.flash_attention_bwd(*args, kv_block=64, **mask)
    got = tfa.flash_attention_bwd(*(t.to(cuda) for t in args), **mask)
    torch.cuda.synchronize()
    _assert_bwd_close(got, want)


# (Sq, Skv, q_offset): square lengths that are no multiple of any tile,
# and a chunk of 100 queries at positions 128..227 over 228 keys
RAGGED = [(1, 1, 0), (100, 100, 0), (500, 500, 0), (100, 228, 128)]


@pytest.mark.parametrize("sq,skv,q_offset", RAGGED)
@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [64, 256])
def test_flash_kernels_take_ragged_lengths(cuda, sq, skv, q_offset, window,
                                           dtype, dh):
    """The forward and both backward kernels at lengths that leave the last
    query tile and kv tile ragged (zero-filled rows, dead keys, rows not
    stored) against the twins, at the tolerances of the other cases; q x 8
    so that the cap acts."""
    mask = dict(causal=True, window=window, logit_cap=50.0,
                q_offset=q_offset)
    q, k, v = _qkv(sq + dh, 1, 4, 2, sq, skv, dh, torch.float32)
    q, k, v = (q * 8).to(dtype), k.to(dtype), v.to(dtype)
    got, want = _flash_both(cuda, q, k, v, **mask)
    rtol, atol = FLASH_TOL[dtype]
    assert got.shape == want.shape
    assert torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol)
    args = _bwd_inputs(sq + dh, 1, 4, 2, sq, skv, dh, dtype, q_scale=8.0,
                       **mask)
    want = tfa.flash_attention_bwd(*args, **mask)
    got = tfa.flash_attention_bwd(*(t.to(cuda) for t in args), **mask)
    torch.cuda.synchronize()
    assert [g.shape for g in got] == [w.shape for w in want]
    if skv > 1:
        _assert_bwd_close(got, want)
        return
    # one key: p = 1, so dS = dP - delta and dq = dk = 0 but for float32
    # rounding on both sides, which no tolerance relative to their own
    # largest value holds; they are held to the atol term against dv's
    _assert_bwd_close(got[2:], want[2:])
    atol = (BWD_F32_TOL if dtype == torch.float32 else BWD_ATOL) * float(
        want[2].float().abs().max())
    for g, w in zip(got[:2], want[:2]):
        assert float((g.float().cpu() - w.float()).abs().max()) <= atol


@pytest.mark.parametrize("seq,window", [(4096, None), (8192, 4096)])
def test_flash_bwd_kernels_at_gemma2_head_shapes(cuda, seq, window):
    """gemma2-9b's heads (16 over 8 kv heads, dh 256, cap 50) in bf16 with
    queries scaled by 8 (so that the cap acts): a global layer at the
    train path's 4096 tokens and a local one at 8192, where the window
    masks. The twin runs on the card on the forward kernel's own out and
    lse."""
    from repro_torch.models.attention import flash_attention_bwd_plain
    mask = dict(causal=True, window=window, logit_cap=50.0)
    g = torch.Generator(device=cuda).manual_seed(seq)
    q, k, v, dout = (torch.randn(s, generator=g, device=cuda)
                     for s in ((1, 16, seq, 256), (1, 8, seq, 256),
                               (1, 8, seq, 256), (1, 16, seq, 256)))
    q, k, v, dout = (t.bfloat16() for t in (q * 8, k, v, dout))
    _, lse, out = tfa._fwd_kernel(q, k, v, lse=True, q_offset=0, **mask)
    got = tfa.flash_attention_bwd(q, k, v, out, lse, dout, **mask)
    want = flash_attention_bwd_plain(q, k, v, out, lse, dout, **mask)
    torch.cuda.synchronize()
    _assert_bwd_close(got, want)


def test_flash_bwd_kernels_are_bit_deterministic(cuda):
    mask = dict(causal=True, window=40, logit_cap=50.0)
    args = [t.to(cuda) for t in _bwd_inputs(3, 2, 8, 2, 256, 256, 128,
                                            torch.bfloat16, q_scale=8.0,
                                            **mask)]
    a = tfa.flash_attention_bwd(*args, **mask)
    b = tfa.flash_attention_bwd(*args, **mask)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_forward_lse_equals_twin(cuda):
    from repro_torch.models.attention import flash_attention_plain
    mask = dict(causal=True, window=40, logit_cap=50.0, q_offset=0)
    q, k, v = _qkv(4, 2, 4, 2, 128, 128, 64, torch.float32)
    _, want = flash_attention_plain(q, k, v, return_lse=True, **mask)
    _, got, _ = tfa._fwd_kernel(q.to(cuda), k.to(cuda), v.to(cuda),
                                lse=True, **mask)
    torch.cuda.synchronize()
    assert torch.allclose(got.cpu(), want, rtol=2e-5, atol=2e-5)


def test_flash_bwd_refuses_what_it_cannot_take(cuda):
    args = [t.to(cuda) for t in _bwd_inputs(0, 1, 2, 1, 64, 64, 64,
                                            torch.float32)]
    q, k, v, out, lse, dout = args
    with pytest.raises(ValueError, match="lse in float32"):
        tfa.flash_attention_bwd(q, k, v, out, lse.bfloat16(), dout)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_bwd(q, k, v, out, lse,
                                dout.transpose(2, 3).contiguous()
                                .transpose(2, 3))
    # a length that is no multiple of the tile launches (ragged tiles)
    short = [t[:, :, :32].contiguous() for t in args]
    want = tfa.flash_attention_bwd(*(t.cpu() for t in short))
    _assert_bwd_close(tfa.flash_attention_bwd(*short), want)
    with pytest.raises(ValueError, match="dh"):
        big = torch.zeros((1, 2, 64, 512), device=cuda)
        tfa.flash_attention_bwd(big, big[:, :1], big[:, :1], big,
                                lse, big)
    with pytest.raises(ValueError, match="bf16 or float32"):
        h = [t.half() for t in (q, k, v)]
        tfa.flash_attention_bwd(*h, out, lse, dout.half())
    with pytest.raises(ValueError, match="float32 out"):
        tfa.flash_attention_bwd(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                out.bfloat16(), lse, dout.bfloat16())


def test_flash_function_keeps_the_float32_out_on_card(cuda):
    """On the card ``FlashAttention``'s residual is the forward kernel's
    float32 out (the reference's), its output the bf16 rounding of the
    same quotients, bit for bit a forward launch without lse."""
    mask = dict(causal=True, window=100, logit_cap=50.0)
    q, k, v = (t.to(cuda) for t in _qkv(12, 1, 4, 2, 300, 300, 256,
                                        torch.bfloat16))
    qg = (q * 8).requires_grad_()
    out = tfa.flash_attention_bhsd(qg, k, v, **mask)
    _, _, _, saved, lse = out.grad_fn.saved_tensors
    assert saved.dtype == torch.float32 and lse.dtype == torch.float32
    with torch.no_grad():
        plain = tfa.flash_attention_bhsd(q * 8, k, v, **mask)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)
    assert torch.equal(out, saved.to(torch.bfloat16))


def test_flash_function_on_card_equals_cpu(cuda):
    """``flash_attention_bhsd`` under autograd on the card: one forward
    (with lse), one dq and one dk/dv launch, gradients equal to the CPU
    Function's (the twins) within the float32 tolerance."""
    mask = dict(causal=True, window=24, logit_cap=50.0)
    q, k, v = _qkv(5, 2, 4, 2, 128, 128, 32, torch.float32)
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(9))
    grads = []
    for dev in ("cpu", cuda):
        leaves = [t.to(dev, copy=True).requires_grad_() for t in (q, k, v)]
        reset_launch_counts()
        out = tfa.flash_attention_bhsd(*leaves, kv_block=64, **mask)
        (out * dout.to(dev)).sum().backward()
        grads.append([t.grad.cpu() for t in leaves])
        counts = launch_counts()
    torch.cuda.synchronize()
    assert (counts["flash_attention_fwd"], counts["flash_attention_bwd_dq"],
            counts["flash_attention_bwd_dkv"]) == (1, 1, 1)
    _assert_bwd_close(grads[1], grads[0])


@pytest.mark.parametrize("seq", [64, 100])
def test_gemma2_smoke_train_step_on_card_equals_cpu(cuda, seq):
    """The smoke train cell (float32, 2 x ``seq`` tokens, no remat; 100 is
    no multiple of any flash tile): one
    forward, one dq and one dk/dv launch per layer; the loss within 1e-5
    of the CPU's; every parameter's gradient, and its first moment after
    one AdamW step (m = (1 - b1) · clip · g), within 1e-4 of the CPU's
    largest value, as ``chip_smoke.py`` holds them (read there: 2.1e-6);
    and the parameters after the step within 2 lr + 1e-6 (the first
    update is lr · g / (|g| + eps), so an element whose gradient is
    float32 noise may flip sign)."""
    import copy
    from repro_torch.launch.steps import lm_train_cell, lm_train_step
    from repro_torch.models.transformer import lm_loss
    cell = lm_train_cell("gemma2-9b", seq_len=seq, batch=2, device="cpu",
                         smoke=True)
    model = copy.deepcopy(cell.model).to(cuda)
    state = {"m": {n: t.to(cuda) for n, t in cell.opt_state["m"].items()},
             "v": {n: t.to(cuda) for n, t in cell.opt_state["v"].items()},
             "step": cell.opt_state["step"].clone()}
    tokens = cell.tokens.to(cuda)

    def close(got, want):
        return float((got.detach().cpu() - want).abs().max()) <= (
            1e-4 * float(want.abs().max().clamp(min=1e-30)))

    lm_loss(cell.model, cell.tokens).backward()
    reset_launch_counts()
    lm_loss(model, tokens).backward()
    torch.cuda.synchronize()
    n = model.cfg.n_layers
    counts = launch_counts()
    assert (counts["flash_attention_fwd"], counts["flash_attention_bwd_dq"],
            counts["flash_attention_bwd_dkv"]) == (n, n, n)
    for (name, p), q in zip(model.named_parameters(),
                            cell.model.parameters()):
        assert close(p.grad, q.grad), name

    want = cell.step()
    got = lm_train_step(model, cell.opt_cfg, state, tokens)
    torch.cuda.synchronize()
    assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-5
    assert got["lr"] == want["lr"]
    for (name, p), q in zip(model.named_parameters(),
                            cell.model.parameters()):
        assert close(state["m"][name], cell.opt_state["m"][name]), name
        assert float((p.detach().cpu() - q.detach()).abs().max()) <= (
            2 * want["lr"] + 1e-6), name


# ---------------------------------------- the span sum, the captured step
def _scan_case(e, d, n, seed, kind="ragged", n_x=0):
    """msgs [e, d] (N(0, 1) + 3, so that the prefix drifts) and sorted
    pointers [n + 1] in [0, e], with empty segments and, for ``ragged``, a
    first pointer past 0 and a last one short of e; ``full`` from 0 to e;
    ``long`` as ragged with one span of 2^17 rows in the middle. With
    ``n_x``, x is [n_x, d] and rows [e] int32 gathers from it (every 50th
    out of range: clamped)."""
    rng = np.random.default_rng(seed)
    span = 1 << 17 if kind == "long" else 0
    p = np.sort(rng.integers(0, e - span + 1, n + 1)).astype(np.int32)
    if n > 8:
        p[n // 4:n // 4 + 5] = p[n // 4]
    if kind == "full":
        p[0], p[-1] = 0, e
    if kind == "long":
        p[n // 2 + 1:] += span
    x = rng.normal(size=(n_x or e, d)) + 3
    rows = None
    if n_x:
        rows = rng.integers(0, n_x, e).astype(np.int32)
        rows[::50] = 0x7FFFFFFF
        rows = torch.from_numpy(rows)
    return (torch.from_numpy(p), torch.from_numpy(x.astype(np.float32)),
            rows)


@pytest.mark.parametrize("e,d,n,kind,n_x,mean", [
    (1, 1, 1, "full", 0, False), (3000, 7, 400, "ragged", 0, False),
    (100_003, 37, 20_000, "ragged", 0, False),
    (1 << 19, 1, 282_624, "full", 0, False),
    (1 << 19, 128, 282_624, "full", 0, False),
    (70_001, 602, 50_000, "ragged", 0, False),
    (262_144, 3, 169_984, "ragged", 0, True),
    (262_144, 8, 169_984, "ragged", 0, False),
    (262_144, 70, 169_984, "ragged", 0, False),
    (1 << 18, 1, 4096, "long", 0, False),
    (1 << 18, 602, 4096, "long", 0, True),
    (300_000, 70, 4096, "long", 5000, True),
    (524_288, 602, 282_624, "ragged", 282_624, True),
    (524_288, 128, 282_624, "full", 282_624, True),
    (200_000, 8, 50_000, "ragged", 30_000, False)])
def test_ptr_scan_kernel_within_its_tolerance_of_the_twin(cuda, e, d, n,
                                                          kind, n_x, mean):
    """The span-sum kernel against its twin within ``twin_tolerance``
    (derived from float32 rounding) at D 1, 3, 7, 8, 37, 70, 128 and 602,
    with empty segments, pointers that start past 0 or end short of E, a
    span of 2^17 rows, a gather index (clamped where out of range) and the
    mean; two launches give the same bits, and one launch counts one."""
    from repro_torch.kernels import ptr_scan
    ptr, x, rows = _scan_case(e, d, n, seed=e + d, kind=kind, n_x=n_x)
    want = ptr_scan.ptr_seg_sum(ptr, x, rows, mean)
    tol = ptr_scan.twin_tolerance(ptr, x, rows, mean)
    args = (ptr.to(cuda), x.to(cuda), None if rows is None else rows.to(cuda))
    before = ptr_scan.ptr_seg_sum.launches
    got = ptr_scan.ptr_seg_sum(*args, mean)
    again = ptr_scan.ptr_seg_sum(*args, mean)
    torch.cuda.synchronize()
    assert ptr_scan.ptr_seg_sum.launches == before + 2
    assert torch.equal(got, again)
    err = (got.cpu().double() - want.double()).abs()
    assert bool((err <= tol).all()), float((err / tol.clamp_min(1e-30)).max())


def test_ptr_scan_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    from repro_torch.kernels import ptr_scan
    ptr = torch.zeros(3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        ptr_scan.ptr_seg_sum(ptr.long(), torch.zeros((4, 2), device=cuda))
    with pytest.raises(ValueError, match="float32"):
        ptr_scan.ptr_seg_sum(ptr, torch.zeros((4, 2), device=cuda,
                                              dtype=torch.float64))
    with pytest.raises(ValueError, match="rows"):
        ptr_scan.ptr_seg_sum(ptr, torch.zeros((4, 2), device=cuda),
                             torch.zeros(4, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="rows"):
        ptr_scan.ptr_seg_sum(ptr, torch.zeros((4, 2), device=cuda),
                             torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="float32"):
        ptr_scan.ptr_seg_sum(ptr, torch.zeros((4, 2), device=cuda),
                             torch.zeros(8, dtype=torch.int32,
                                         device=cuda)[::2])


def _serve_engine(cuda, cfg, n_slots=2, arch="graphsage-reddit",
                  delta_cap=64):
    from repro_torch.configs import get_config
    from repro_torch.models.gnn import gnn_model
    from repro_torch.serve import GnnServeEngine
    dst, src = tg.random_coo(np.random.default_rng(0), 3000, 20_000)
    coo = tg.COO.from_arrays(dst, src, 3000, capacity=1 << 15, device=cuda)
    gcfg = dataclasses.replace(get_config(arch, smoke=True),
                               use_pallas_agg=cfg.sort_strategy
                               == "chunked_merge")
    model = gnn_model(gcfg, d_in=24, n_classes=5,
                      generator=torch.Generator().manual_seed(0), device=cuda)
    feats = torch.randn((3000, 24), generator=torch.Generator().manual_seed(1))
    return GnnServeEngine(model, tp.convert(coo, cfg, device=cuda), feats,
                          fanouts=(25, 10), n_slots=n_slots, seed_cap=64,
                          cfg=cfg, device=cuda, delta_cap=delta_cap)


def _wave(eng, rng, rid0):
    from repro_torch.serve.feeder import PreparedAdmission
    from repro_torch.serve.request import Request
    wave = []
    for slot in range(eng.n_slots):
        seeds = rng.choice(3000, int(rng.integers(1, eng.seed_cap + 1)),
                           replace=False).tolist()
        row = np.full((eng.seed_cap,), SEN, np.int32)
        row[:len(seeds)] = seeds
        wave.append((slot, PreparedAdmission(
            Request(rid=rid0 + slot, prompt=seeds), row)))
    return wave


@pytest.mark.parametrize("cfg", [SLICE_CFG, MERGE_CFG],
                         ids=["slice", "merge"])
def test_replayed_step_equals_the_eager_step(cuda, cfg):
    """The captured step, replayed for two new waves (new seeds and key
    schedules in the same state tensors), gives the eager step's emission
    bit for bit, and every served row equals the sequential slot_fn; the
    step is captured once."""
    eng = _serve_engine(cuda, cfg)
    rng = np.random.default_rng(5)
    eng._admit_many(_wave(eng, rng, 0))
    eng._step()  # warm-up, then the capture
    assert eng.step_cache_size() == 1
    for w in (1, 2):
        wave = _wave(eng, rng, 10 * w)
        eng._admit_many(wave)
        saved = {k: v.clone() for k, v in eng.state.items()}
        replayed = torch.from_numpy(eng._step())
        for k, v in saved.items():
            eng.state[k].copy_(v)
        eng.step_fn(eng.params, eng.state)
        assert torch.equal(replayed, eng.state["emission"].cpu()), w
        for slot, prep in wave:
            seeds = prep.request.prompt
            seq = eng.slot_fn(eng.params, torch.from_numpy(prep.row).to(cuda),
                              eng.request_key(prep.request.rid))
            assert replayed[slot, 0] == 1
            assert torch.equal(replayed[slot, 1:1 + len(seeds)],
                               seq[:len(seeds)].cpu()), (w, slot)
    assert eng.step_cache_size() == 1


@pytest.mark.parametrize("arch", ["gat-cora", "gatedgcn", "meshgraphnet"])
@pytest.mark.parametrize("cfg", [SLICE_CFG, MERGE_CFG,
                                 dataclasses.replace(SLICE_CFG,
                                                     selection="keysort")],
                         ids=["slice", "merge", "keysort"])
def test_families_replayed_step_equals_the_eager_step(cuda, arch, cfg):
    """GAT, GatedGCN and MeshGraphNet (smoke configs), also under keysort
    selection: the captured step replayed for a new wave equals the eager
    step bit for bit and every row the sequential slot_fn; one capture."""
    eng = _serve_engine(cuda, cfg, arch=arch)
    rng = np.random.default_rng(6)
    eng._admit_many(_wave(eng, rng, 0))
    eng._step()
    wave = _wave(eng, rng, 10)
    eng._admit_many(wave)
    saved = {k: v.clone() for k, v in eng.state.items()}
    replayed = torch.from_numpy(eng._step())
    for k, v in saved.items():
        eng.state[k].copy_(v)
    eng.step_fn(eng.params, eng.state)
    assert torch.equal(replayed, eng.state["emission"].cpu())
    for slot, prep in wave:
        seeds = prep.request.prompt
        seq = eng.slot_fn(eng.params, torch.from_numpy(prep.row).to(cuda),
                          eng.request_key(prep.request.rid))
        assert torch.equal(replayed[slot, 1:1 + len(seeds)],
                           seq[:len(seeds)].cpu()), slot
    assert eng.step_cache_size() == 1


@pytest.mark.parametrize("arch", ["gat-cora", "gatedgcn", "meshgraphnet"])
def test_family_logits_on_card_equal_cpu(cuda, arch):
    """One sampled subgraph through the family's forward on the card and
    on the CPU (the span sum against its twin, cuBLAS, the card's
    scatter_reduce maximum of GAT's softmax): within 1e-4 of the logits'
    largest magnitude (at least 1)."""
    from repro_torch.configs import get_config
    from repro_torch.models.gnn import gnn_model, subgraph_batch
    dst, src = tg.random_coo(np.random.default_rng(0), 3000, 20_000)
    coo = tg.COO.from_arrays(dst, src, 3000, capacity=1 << 15, device="cpu")
    feats = torch.randn((3000, 24), generator=torch.Generator().manual_seed(1))
    model = gnn_model(get_config(arch, smoke=True), d_in=24, n_classes=5,
                      generator=torch.Generator().manual_seed(0),
                      device="cpu")
    seeds = torch.arange(64, dtype=torch.int32)
    key = prng.fold_in(prng.PRNGKey(0), 3)
    sub = tp.sample_subgraph(tp.convert(coo, SLICE_CFG, device="cpu"), seeds,
                             (25, 10), key, SLICE_CFG)
    with torch.no_grad():
        want = model(subgraph_batch(sub, feats))
        got = model.to(cuda)(subgraph_batch(
            tp.sample_subgraph(tp.convert(coo, SLICE_CFG, device=cuda),
                               seeds.to(cuda), (25, 10), key, SLICE_CFG),
            feats.to(cuda))).cpu()
    assert (got - want).abs().max() <= 1e-4 * max(1.0, float(
        want.abs().max()))


@pytest.mark.parametrize("selection", ["keysort", "reservoir"])
def test_selection_on_card_equals_cpu(cuda, selection):
    """keysort and reservoir sampling of one request under SLICE_CFG on the
    card give the CPU's subgraph bit for bit."""
    cfg = dataclasses.replace(SLICE_CFG, selection=selection)
    dst, src = tg.random_coo(np.random.default_rng(2), 3000, 40_000)
    coo = tg.COO.from_arrays(dst, src, 3000, capacity=1 << 16, device="cpu")
    seeds = torch.from_numpy(np.random.default_rng(3).choice(
        3000, 128, replace=False).astype(np.int32))
    key = prng.fold_in(prng.PRNGKey(4), 1)
    want = tp.sample_subgraph(tp.convert(coo, cfg, device="cpu"), seeds,
                              (15, 10), key, cfg)
    got = tp.sample_subgraph(tp.convert(coo, cfg, device=cuda),
                             seeds.to(cuda), (15, 10), key, cfg)
    for a, b in ((got.csc.ptr, want.csc.ptr), (got.csc.idx, want.csc.idx),
                 (got.order, want.order)):
        assert torch.equal(a.cpu(), b)


def test_update_is_copied_into_the_captured_graph(cuda):
    """A streamed update after the capture: the step is not captured
    again, every bound tensor keeps its address, the engine's CSC equals
    ``apply_delta`` of the old one, and the replays serve the old graph to
    the query queued before the update and the new one to those after
    (each equal to the sequential slot_fn on its graph)."""
    from repro_torch.core.delta import EdgeDelta
    rng = np.random.default_rng(7)
    eng = _serve_engine(cuda, SLICE_CFG, delta_cap=256)
    eng.submit([1, 2, 3])
    eng.close_submissions()
    eng.run()
    bound = eng._bindings()
    eng.reopen()
    csc = eng.params["csc"]
    old = tg.CSC(csc.ptr.clone(), csc.idx.clone(), csc.n_edges.clone(),
                 csc.n_nodes)
    pos = rng.integers(0, int(old.n_edges), 200)
    ptr = old.ptr.cpu().numpy()
    idx = old.idx.cpu().numpy()
    dels = [(int(np.searchsorted(ptr, p, side="right") - 1), int(idx[p]))
            for p in pos]
    ins = [(int(a), int(b)) for a, b in rng.integers(0, 3000, (256, 2))]
    queries = [rng.choice(3000, 40, replace=False).tolist()
               for _ in range(3)]
    handles = [eng.submit(queries[0]), eng.submit_update(ins, dels),
               eng.submit(queries[1]), eng.submit(queries[2])]
    eng.close_submissions()
    eng.run()
    assert eng.step_cache_size() == 1 and eng._bindings() == bound
    new = tp.apply_delta(old, EdgeDelta.from_arrays(
        *zip(*ins), *zip(*dels), n_nodes=3000, capacity=256, device=cuda),
        SLICE_CFG, out_capacity=old.idx.shape[0])
    assert torch.equal(csc.ptr, new.ptr) and torch.equal(csc.idx, new.idx)
    assert int(csc.n_edges) == int(new.n_edges)
    assert handles[1].tokens_out == []
    for h, seeds, graph in ((handles[0], queries[0], old),
                            (handles[2], queries[1], new),
                            (handles[3], queries[2], new)):
        row = torch.full((eng.seed_cap,), SEN, dtype=torch.int32)
        row[:len(seeds)] = torch.tensor(seeds, dtype=torch.int32)
        seq = eng.slot_fn({**eng.params, "csc": graph}, row.to(cuda),
                          eng.request_key(h.rid))
        assert h.tokens_out == seq[:len(seeds)].tolist(), h.rid


# the hand-written kernels of the GNN serve step, by name in a trace
_SERVE_KERNEL_RE = (r"\b(?:digit_hist|digit_scatter|chunk_sort|rank|rename|"
                    r"span_sum|merge_partition|merge_tile|tile_sort|"
                    r"set_count|segment_sum|segment_bounds)_kernel\b")


def _traced_kernels(fn):
    """{kernel name: launches} of the serve step's hand-written kernels
    in a ``torch.profiler`` trace of ``fn()``."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {}
    for e in prof.key_averages():
        m = re.search(_SERVE_KERNEL_RE, e.key)
        if m and e.device_type == DeviceType.CUDA:
            counts[m.group(0)] = counts.get(m.group(0), 0) + e.count
    return counts


def test_replays_advance_the_launch_counters(cuda):
    """A replay adds the captured graph's launches to the counters: per
    lane, what one eager slot_fn counts (2 ptr_seg_sum launches: two
    layers, each a mean read through the edge sources); and a trace of
    one replay shows n_slots times the hand-written kernels a trace of one
    eager slot_fn shows, so the counted launches happened."""
    eng = _serve_engine(cuda, SLICE_CFG)
    rng = np.random.default_rng(6)
    eng._admit_many(_wave(eng, rng, 0))
    eng._step()
    per_step = eng.captured_launches()
    reset_launch_counts()
    lane = _traced_kernels(lambda: eng.slot_fn(
        eng.params, eng.state["seeds"][0], eng.request_key(0)))
    one = {k: v for k, v in launch_counts().items() if v}
    assert one["ptr_seg_sum"] == 2 == lane["span_sum_kernel"]
    assert one["digit_hist"] == lane["digit_hist_kernel"]
    assert per_step == {k: eng.n_slots * v for k, v in one.items()}
    eng._admit_many(_wave(eng, rng, 0))
    replay = _traced_kernels(eng._step)
    assert replay == {k: eng.n_slots * v for k, v in lane.items()}
    before = launch_counts()
    for _ in range(3):
        eng._admit_many(_wave(eng, rng, 0))
        eng._step()
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {k: 3 * v
                                          for k, v in per_step.items()}


def test_replay_refuses_a_rebound_state_tensor(cuda):
    """The captured step replays on the addresses it was captured on:
    new seeds written in place are served, a seed tensor rebound since
    makes the next step raise before any replay."""
    eng = _serve_engine(cuda, SLICE_CFG)
    rng = np.random.default_rng(7)
    eng._admit_many(_wave(eng, rng, 0))
    eng._step()
    eng._admit_many(_wave(eng, rng, 10))
    assert eng._step()[:, 0].tolist() == [1] * eng.n_slots
    eng.state["seeds"] = eng.state["seeds"].clone()
    with pytest.raises(RuntimeError, match=r"state\.seeds"):
        eng._step()
    assert eng.step_cache_size() == 1


# ------------------------------------------------------- the engine service
@pytest.mark.parametrize("w_upe", [32768, 65536])
@pytest.mark.parametrize("n_nodes", [40_000, 232_965])  # packed, two-pass
def test_wide_chunks_sort_as_sub_chunks_and_a_merge_rung(cuda, w_upe,
                                                         n_nodes):
    """Library entries wider than one chunk-sort CTA holds (16,384 pairs,
    32,768 keys): the chunk sorts as sub-chunks of the widest shape that
    fits and one merge rung, so a chunked_merge convert of 2^20 edges
    equals the torch.sort strategy's bit for bit, and the chunk-sort
    routing equals the twin at the chunk's width."""
    coo = tg.synthetic_coo(n_nodes, (1 << 20) - 1000, 1 << 20, seed=w_upe,
                           device=cuda)
    cfg = tcm.EngineConfig(w_upe=w_upe, use_pallas=True,
                           sort_strategy="chunked_merge",
                           reindex_strategy="fused")
    want = tp.convert(coo, tcm.EngineConfig(sort_strategy="xla_sort"),
                      device=cuda)
    reset_launch_counts()
    got = tp.convert(coo, cfg, device=cuda)
    torch.cuda.synchronize()
    assert torch.equal(got.ptr, want.ptr) and torch.equal(got.idx, want.idx)
    counts = launch_counts()
    assert counts["chunk_sort"] > 0 and counts["merge_rung"] > 0
    rng = np.random.default_rng(w_upe)
    keys = torch.from_numpy(rng.integers(0, 1 << 18, 1 << 20).astype(
        np.int32))
    vals = torch.arange(1 << 20, dtype=torch.int32)
    fn = trs.make_chunk_sort_fn(4)
    for v in (vals, None):
        wk, wv = fn(keys, v, w_upe, 18)
        gk, gv = fn(keys.to(cuda), None if v is None else v.to(cuda), w_upe,
                    18)
        assert torch.equal(gk.cpu(), wk)
        assert (gv is None) == (wv is None)
        if wv is not None:
            assert torch.equal(gv.cpu(), wv)


def test_every_kernel_library_entry_converts_on_the_card(cuda):
    """Every entry of the library with the kernels routed, under each
    pinned strategy, converts 2^20 pairs equal to the torch.sort
    strategy (none raises)."""
    coo = tg.synthetic_coo(232_965, 1 << 20, 1 << 20, seed=3, device=cuda)
    want = tp.convert(coo, tcm.EngineConfig(sort_strategy="xla_sort"),
                      device=cuda)
    for c in tcm.bitstream_library():
        for s in ("chunked_merge", "global_radix"):
            cfg = dataclasses.replace(c, use_pallas=True, sort_strategy=s)
            got = tp.convert(coo, cfg, device=cuda)
            assert torch.equal(got.ptr, want.ptr), cfg.key
            assert torch.equal(got.idx, want.idx), cfg.key


def test_service_on_the_kernel_library_equals_the_cpu_path(cuda):
    """PreprocService on the ``_pl`` library: DynPre's subgraphs, a batched
    sample and a delta on the card equal the CPU path's (the twins)."""
    from repro_torch.core.delta import EdgeDelta
    from repro_torch.engine import PreprocService
    lib = [dataclasses.replace(c, use_pallas=True)
           for c in tcm.bitstream_library()]
    rng = np.random.default_rng(11)
    dst, src = tg.random_coo(rng, 4096, 1 << 14)
    key = prng.PRNGKey(4)
    seeds = rng.choice(4096, 1000, replace=False).astype(np.int32)
    outs = {}
    for dev in (torch.device("cpu"), cuda):
        svc = PreprocService((25, 10), library=lib)
        coo = tg.COO.from_arrays(dst, src, 4096, device=dev)
        sub = svc.preprocess(coo, seeds, key)
        csc = tp.convert(coo, svc.active_cfg, device=dev)
        rows = torch.from_numpy(seeds[:600].reshape(2, 300)).to(dev)
        batched = svc.sample_batched(csc, rows, prng.split(key, 2))
        delta = EdgeDelta.from_arrays(dst[:50], src[:50][::-1].copy(),
                                      dst[100:160], src[100:160],
                                      n_nodes=4096, device=dev)
        spliced = svc.apply_delta(csc, delta, mode="merge")
        outs[dev.type] = [t.cpu() for t in (
            sub.csc.ptr, sub.csc.idx, sub.order, batched.csc.ptr,
            batched.csc.idx, batched.order, spliced.ptr, spliced.idx,
            spliced.n_edges)]
    for a, b in zip(outs["cpu"], outs["cuda"]):
        assert torch.equal(a, b)


def test_prefetcher_on_a_side_stream_equals_sync_batches(cuda):
    """Batches made on the producer's side stream (a convert, a sample
    and a gather on the card) equal SyncBatches's, with a consumer that
    frees each batch at once and allocates over it: the batch's
    record_stream keeps its memory from the producer's next batch until
    the consumer's stream is done with it."""
    from repro_torch.engine import Prefetcher, SyncBatches
    rng = np.random.default_rng(12)
    dst, src = tg.random_coo(rng, 8192, 1 << 16)
    coo = tg.COO.from_arrays(dst, src, 8192, device=cuda)
    feats = torch.randn(8192, 64, device=cuda)

    def batch_fn(step):
        sub = tp.preprocess(coo, np.arange(step, step + 512, dtype=np.int32),
                            (10, 5), prng.PRNGKey(step), SLICE_CFG,
                            device=cuda)
        return sub, tp.gather_features(sub, feats)

    def consume(it):
        out = []
        for step, (sub, x) in it:
            y = (x @ x.T).sum(1)  # on the consumer's stream
            del sub, x  # freed at once
            junk = torch.empty(1 << 22, device=cuda).fill_(float(step))
            out.append((y + junk[:1]).cpu())
        return out

    with SyncBatches(batch_fn, stop=8) as it:
        want = consume(it)
    with Prefetcher(batch_fn, stop=8) as pf:
        assert pf.stream is not None
        got = consume(pf)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_launch_counters_are_exact_under_two_threads(cuda):
    """Kernel launches from two threads at once (each on its own stream)
    count exactly."""
    import threading
    arr = torch.arange(1 << 16, dtype=torch.int32, device=cuda)
    q = torch.randint(0, 1 << 16, (1 << 12,), dtype=torch.int32,
                      device=cuda)
    reset_launch_counts()

    def run():
        with torch.cuda.stream(torch.cuda.Stream(cuda)):
            for _ in range(500):
                tre.rank_search(arr, q)
        torch.cuda.synchronize()

    threads = [threading.Thread(target=run) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert launch_counts()["rank_search"] == 1000


# ------------------------------------------------------------ GNN training
def _smoke_dataset(dev, seed=0, fanouts=(3, 2)):
    """``run_gnn``'s smoke graph (512 nodes, 4,096 edges, 32 features, 7
    classes, batch 32) in a ``SampledDataset`` on ``dev``."""
    from repro_torch.data.sampler import SampledDataset
    from repro_torch.launch.train import gnn_data
    dst, src, feats, labels = gnn_data(seed, True)
    return SampledDataset(
        coo=tg.COO.from_arrays(dst, src, 512, device=dev),
        features=torch.from_numpy(feats).to(dev),
        labels=torch.from_numpy(labels).to(dev), fanouts=fanouts,
        batch_size=32, seed=seed)


def _smoke_model(arch, dev, seed=0):
    from repro_torch.configs import get_config
    from repro_torch.models.gnn import gnn_model
    n_classes = 0 if arch == "meshgraphnet" else 7
    return gnn_model(get_config(arch, smoke=True), 32, d_edge=4,
                     n_classes=n_classes,
                     generator=torch.Generator().manual_seed(seed),
                     device=dev)


def _grads(model, batch):
    from repro_torch.models.gnn import gnn_loss
    for p in model.parameters():
        p.grad = None
    loss = gnn_loss(model, batch)
    loss.backward()
    return float(loss.detach()), {n: (p.grad if p.grad is not None
                             else torch.zeros_like(p)).detach().cpu()
                         for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch", ["graphsage-reddit", "gat-cora", "gatedgcn",
                                  "meshgraphnet"])
def test_gnn_gradients_on_card_match_float64_and_repeat(cuda, arch):
    """A sampler batch on the card (the kernel library's routing) has the
    CPU's integers; the smoke model's loss and every gradient through the
    span-sum kernel (forward and backward) lie within 1e-4 of a float64
    twin's on the CPU (the same batch without ptr: take, the masks and
    index_add_, the reference's composition), as a share of each
    gradient's largest value (at least 1e-4 of the largest of all: a
    gradient the math makes zero is rounding noise); a second backward
    gives the same bits; a GraphSAGE step launches the span sum twice
    forward and once backward. (The CPU's float32 twin is no oracle here:
    its prefix differences cancel, 1.7e-4 of a GatedGCN gradient.)"""
    import copy
    from repro_torch.kernels import ptr_scan
    fanouts = (3, 2) if arch == "graphsage-reddit" else (5, 3)
    cpu_b = _smoke_dataset("cpu", fanouts=fanouts).batch(3)
    card_b = _smoke_dataset(cuda, fanouts=fanouts).batch(3)
    for f in ("edge_dst", "edge_src", "ptr", "rev_perm", "rev_ptr",
              "labels", "label_mask"):
        assert torch.equal(getattr(card_b, f).cpu(), getattr(cpu_b, f)), f
    if arch == "meshgraphnet":
        from repro_torch.launch.train import regression_targets
        cpu_b = regression_targets(cpu_b, 3)
        card_b = regression_targets(card_b, 3)
    model = _smoke_model(arch, "cpu")
    twin = copy.deepcopy(model).double()
    twin.cfg = dataclasses.replace(model.cfg, dtype=torch.float64)
    want_loss, want = _grads(twin, dataclasses.replace(
        cpu_b, node_feat=cpu_b.node_feat.double(), ptr=None, rev_perm=None,
        rev_ptr=None))
    card = copy.deepcopy(model).to(cuda)
    before = ptr_scan.ptr_seg_sum.launches
    loss, got = _grads(card, card_b)
    torch.cuda.synchronize()
    if arch == "graphsage-reddit":
        assert ptr_scan.ptr_seg_sum.launches - before == 3
    _, again = _grads(card, card_b)
    assert abs(loss - want_loss) <= 1e-4 * max(1.0, abs(want_loss))
    top = max(float(w.abs().max()) for w in want.values())
    for n, w in want.items():
        assert torch.equal(got[n], again[n]), n
        scale = max(float(w.abs().max()), 1e-4 * top)
        assert float((got[n].double() - w).abs().max()) <= 1e-4 * scale, n


@pytest.mark.parametrize("fused,mean", [(True, True), (False, False),
                                        (False, True)])
def test_span_sum_backward_on_card_within_its_tolerance(cuda, fused, mean):
    """``SpanSum``'s backward on a sampler batch's transposed layout:
    through the kernel within ``twin_tolerance`` of the twin on the same
    scaled gradient, the same bits twice, one launch a backward when
    fused (none otherwise: a row gather)."""
    from repro_torch.kernels import ptr_scan
    b = _smoke_dataset(cuda).batch(0)
    n, e = b.n_nodes, b.edge_dst.shape[0]
    dst = torch.clamp(b.edge_dst, max=n - 1)
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((n if fused else e, 16), generator=g, device=cuda)
    gout = torch.randn((n, 16), generator=g, device=cuda)
    rows = b.edge_src if fused else None

    def backward():
        xa = x.clone().requires_grad_()
        ptr_scan.SpanSum.apply(xa, b.ptr, rows, mean, dst, b.rev_perm,
                               b.rev_ptr).backward(gout)
        return xa.grad
    before = ptr_scan.ptr_seg_sum.launches
    got = backward()
    again = backward()
    torch.cuda.synchronize()
    assert ptr_scan.ptr_seg_sum.launches - before == 2 * (2 if fused else 1)
    assert torch.equal(got, again)
    gs = ptr_scan._mean_scaled(gout, b.ptr) if mean else gout
    if fused:
        brows = dst.index_select(0, b.rev_perm.long())
        want = ptr_scan.ptr_seg_sum(b.rev_ptr.cpu(), gs.cpu(), brows.cpu())
        tol = ptr_scan.twin_tolerance(b.rev_ptr.cpu(), gs.cpu(), brows.cpu())
        assert bool(((got.cpu().double() - want.double()).abs()
                     <= tol).all())
    else:
        live = (torch.arange(e, device=cuda) < b.ptr[-1])[:, None]
        assert torch.equal(got, torch.where(live, gs.index_select(
            0, dst.long()), 0.0))


def test_kernels_refuse_silent_detachment_on_card(cuda):
    from repro_torch.kernels import ptr_scan
    ptr = torch.tensor([0, 2, 4], dtype=torch.int32, device=cuda)
    x = torch.randn((4, 3), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no autograd history"):
        ptr_scan.ptr_seg_sum(ptr, x)
    with pytest.raises(RuntimeError, match="no autograd history"):
        tsa.segment_sum_padded(torch.tensor([0, 0, 1, 1], dtype=torch.int32,
                                            device=cuda), x, 2)
    with torch.no_grad():
        assert torch.equal(ptr_scan.ptr_seg_sum(ptr, x),
                           ptr_scan.ptr_seg_sum(ptr, x.detach()))


def test_run_gnn_on_card_resumes_bit_for_bit(cuda, tmp_path):
    """The smoke trainer on the card: a run crashed at step 11 and resumed
    from its step-10 checkpoint ends with a clean run's parameters and
    losses, bit for bit; the loss falls over the 12 steps."""
    from repro_torch.launch.train import gnn_data, run_gnn
    kw = dict(arch="graphsage-reddit", steps=12, smoke=True, device=cuda,
              data=gnn_data(0, True), log_every=1)
    with pytest.raises(RuntimeError, match="injected failure"):
        run_gnn(ckpt_dir=str(tmp_path / "a"), fail_at=11, **kw)
    m1, _, h1 = run_gnn(ckpt_dir=str(tmp_path / "a"), fail_at=None, **kw)
    m2, _, h2 = run_gnn(ckpt_dir=str(tmp_path / "b"), fail_at=None, **kw)
    assert h1 == h2[10:]
    for (n, p), q in zip(m1.named_parameters(), m2.parameters()):
        assert torch.equal(p, q), n
    assert h2[-1]["loss"] < h2[0]["loss"]


# ----------------------------------------------------- the decode kernel
def _decode_inputs(dev, kv, b, h, hkv, s, dh, q_dtype, q_scale=1.0, seed=0):
    """(q, k, v, k_scale, v_scale) on ``dev``: q [b, h, 1, dh] in
    ``q_dtype``, a bf16 cache or an int8 one quantized from N(0, 1)."""
    from repro_torch.models.attention import quantize_kv
    g = torch.Generator().manual_seed(seed)
    q = (torch.randn((b, h, 1, dh), generator=g) * q_scale).to(q_dtype)
    k, v = (torch.randn((b, hkv, s, dh), generator=g) for _ in range(2))
    if kv == "int8":
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        return tuple(t.to(dev) for t in (q, k, v, ks, vs))
    return (q.to(dev), k.to(torch.bfloat16).to(dev),
            v.to(torch.bfloat16).to(dev), None, None)


def _decode_ratio(got, want, tol):
    diff = (got.double() - want.double()).abs()
    return float(torch.where(diff == 0, 0.0, diff / tol).max())


def _decode_edge_lens(s):
    """Cache lengths at the decode kernel's edges for a cache of ``s``
    positions: 1, a ring chunk and a split, each one less, equal and one
    more, half the cache, one less than it and all of it."""
    from repro_torch.kernels import decode_attention as tda
    c, sp = tda.CHUNK, tda.split_size(s)
    lens = (1, 7, c - 1, c, c + 1, sp - 1, sp, sp + 1, 2 * sp + 1,
            s // 2, s - 1, s)
    return sorted({n for n in lens if 1 <= n <= s})


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cap,window", [(None, None), (50.0, None),
                                        (50.0, 48)])
@pytest.mark.parametrize("b,h,hkv,s,dh", [(3, 4, 2, 40, 16),
                                          (8, 16, 8, 1024, 256),
                                          (2, 16, 8, 1000, 256),
                                          (2, 8, 1, 300, 64),
                                          (2, 4, 2, 200, 40),
                                          (2, 4, 4, 130, 37),
                                          (1, 16, 8, 16384, 256)])
def test_decode_kernel_within_its_tolerance_of_the_twin(cuda, kv, q_dtype,
                                                        cap, window, b, h,
                                                        hkv, s, dh):
    """The decode kernel against ``decode_attention_plain`` on the same
    card inputs, at every length of ``_decode_edge_lens`` (``b`` slots a
    launch), within ``twin_tolerance`` (derived from float32 rounding);
    two launches bit-equal. dh 40 and 37 take the narrower copies."""
    from repro_torch.kernels import decode_attention as tda
    from repro_torch.models.attention import decode_attention_plain
    q, k, v, ks, vs = _decode_inputs(cuda, kv, b, h, hkv, s, dh, q_dtype,
                                     q_scale=8.0 if cap else 1.0)
    kw = dict(window=window, logit_cap=cap, k_scale=ks, v_scale=vs)
    edges = _decode_edge_lens(s)
    for i in range(0, len(edges), b):
        lens = torch.tensor((edges[i:i + b] * b)[:b], dtype=torch.int32,
                            device=cuda)
        got = tda.decode_attention(q, k, v, lens, **kw)
        again = tda.decode_attention(q, k, v, lens, **kw)
        want = decode_attention_plain(q, k, v, lens, **kw)
        torch.cuda.synchronize()
        assert got.dtype == q.dtype and got.shape == q.shape
        assert torch.equal(got, again)
        assert _decode_ratio(got, want, tda.twin_tolerance(
            q, k, v, lens, **kw)) <= 1.0, lens.tolist()


@pytest.mark.parametrize("kv,dh", [("int8", 256), ("bf16", 256),
                                   ("bf16", 16)])
def test_decode_kernel_narrow_copies_give_the_aligned_bits(cuda, kv, dh):
    """The same cache copied 4 bytes and 1 element past a 16-byte
    boundary: the kernel takes 4-byte and 1-byte copies there
    (``load_width``) and gives the bits of the 16-byte copies."""
    from repro_torch.kernels import decode_attention as tda
    q, k, v, ks, vs = _decode_inputs(cuda, kv, 3, 16, 8, 300, dh,
                                     torch.bfloat16, seed=5)
    lens = torch.tensor([1, 129, 300], dtype=torch.int32, device=cuda)
    kw = dict(logit_cap=50.0, k_scale=ks, v_scale=vs)
    assert tda.load_width(k, v) == 16
    want = tda.decode_attention(q, k, v, lens, **kw)

    def shifted(t, offset):
        buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=cuda)
        pad = (-buf.data_ptr() % 16) // t.element_size()
        view = buf[pad + offset:pad + offset + t.numel()].view(t.shape)
        return view.copy_(t)
    for offset, width in ((4 // k.element_size(), 4), (1, 1)):
        kk, vv = shifted(k, offset), shifted(v, offset)
        assert tda.load_width(kk, vv) == width
        assert torch.equal(tda.decode_attention(q, kk, vv, lens, **kw),
                           want), width


def test_decode_kernel_slot_is_independent_of_its_neighbours(cuda):
    """A slot's output depends on its own cache rows and length only: the
    same slot alone (batch 1) and beside 7 others with other caches and
    lengths gives the same bits."""
    from repro_torch.kernels import decode_attention as tda
    q, k, v, ks, vs = _decode_inputs(cuda, "int8", 8, 16, 8, 1024, 256,
                                     torch.bfloat16, seed=3)
    lens = torch.tensor([700, 1, 1024, 33, 512, 256, 999, 2],
                        dtype=torch.int32, device=cuda)
    full = tda.decode_attention(q, k, v, lens, logit_cap=50.0, k_scale=ks,
                                v_scale=vs)
    for i in (0, 3, 7):
        sl = slice(i, i + 1)
        alone = tda.decode_attention(q[sl], k[sl], v[sl], lens[sl],
                                     logit_cap=50.0, k_scale=ks[sl],
                                     v_scale=vs[sl])
        assert torch.equal(alone, full[sl]), i


def test_decode_kernel_planted_faults_read_outside_the_tolerance(cuda):
    """At gemma2-9b's heads on an int8 cache of 1,024 positions: the cap
    left out and the dequantization widened without its bf16 rounding
    (q × 8: scores where the cap acts), one position more and the next kv
    head (q × 1) read outside ``twin_tolerance`` of the kernel."""
    from repro_torch.kernels import decode_attention as tda
    from repro_torch.models import attention as ta
    lens = torch.tensor([1, 300, 1023], dtype=torch.int32, device=cuda)
    for q_scale, faults in ((8.0, ("no_cap", "dequant_f32")),
                            (1.0, ("len_plus_1", "next_kv_head"))):
        q, k, v, ks, vs = _decode_inputs(cuda, "int8", 3, 16, 8, 1024, 256,
                                         torch.float32, q_scale=q_scale,
                                         seed=11)
        kw = dict(logit_cap=50.0, k_scale=ks, v_scale=vs)
        got = tda.decode_attention(q, k, v, lens, **kw)
        tol = tda.twin_tolerance(q, k, v, lens, **kw)
        for fault in faults:
            if fault == "no_cap":
                bad = ta.decode_attention_plain(q, k, v, lens,
                                                **{**kw, "logit_cap": None})
            elif fault == "len_plus_1":
                bad = ta.decode_attention_plain(q, k, v, lens + 1, **kw)
            elif fault == "next_kv_head":
                bad = ta.decode_attention_plain(
                    q, k.roll(1, 1), v.roll(1, 1), lens, logit_cap=50.0,
                    k_scale=ks.roll(1, 1), v_scale=vs.roll(1, 1))
            else:  # int8 × scale widened without the bf16 rounding
                bad = ta.decode_attention_plain(q, k.float() * ks,
                                                v.float() * vs, lens,
                                                logit_cap=50.0)
            assert _decode_ratio(got, bad, tol) > 2.0, fault


def test_decode_kernel_counts_two_launches_and_refuses(cuda):
    from repro_torch.kernels import decode_attention as tda
    q, k, v, ks, vs = _decode_inputs(cuda, "int8", 2, 4, 2, 40, 16,
                                     torch.float32)
    lens = torch.tensor([3, 40], dtype=torch.int32, device=cuda)
    before = tda.decode_attention.launches
    tda.decode_attention(q, k, v, lens, k_scale=ks, v_scale=vs)
    assert tda.decode_attention.launches == before + 2
    z = dict(device=cuda)
    wide_k = torch.zeros((2, 2, 40, 512), dtype=torch.int8, **z)
    wide_s = torch.zeros((2, 2, 40, 1), **z)
    cases = {
        "int8 without scales": (q, k, v, lens, {}),
        "int64 lengths": (q, k, v, lens.long(), dict(k_scale=ks,
                                                      v_scale=vs)),
        "a float16 q": (q.half(), k, v, lens, dict(k_scale=ks, v_scale=vs)),
        "a strided q": (torch.zeros((2, 4, 1, 32), **z)[..., :16], k, v,
                        lens, dict(k_scale=ks, v_scale=vs)),
        "9 query heads a kv head": (torch.zeros((2, 18, 1, 16), **z), k, v,
                                    lens, dict(k_scale=ks, v_scale=vs)),
        "dh 512": (torch.zeros((2, 2, 1, 512), **z), wide_k, wide_k, lens,
                   dict(k_scale=wide_s, v_scale=wide_s)),
    }
    for what, (qq, kk, vv, ll, kw) in cases.items():
        with pytest.raises(ValueError):
            tda.decode_attention(qq, kk, vv, ll, **kw)
            pytest.fail(what)
    assert tda.decode_attention.launches == before + 2


# ------------------------------------------------------ the LM serve engine
def _lm_engine(dev, kv, n_slots=4):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM
    from repro_torch.serve import ServeEngine
    cfg = dataclasses.replace(get_config("gemma2-9b", smoke=True),
                              kv_cache_dtype=kv)
    model = LM(cfg, seed=0, device="cpu").to(dev)
    return ServeEngine(cfg, model, n_slots=n_slots, max_len=64,
                       prompt_cap=16, device=dev)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_lm_engine_on_card_equals_cpu(cuda, kv):
    """The smoke model served through the captured step on the card gives
    the CPU engine's tokens; one step program; each replay counts the
    decode kernel's two launches a layer."""
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, 256, int(rng.integers(1, 17))).tolist(),
             int(rng.integers(1, 20))) for _ in range(9)]
    out = {}
    for dev in ("cpu", cuda):
        eng = _lm_engine(dev, kv)
        reset_launch_counts()
        for p, g in reqs:
            eng.submit(p, g)
        eng.close_submissions()
        out[str(dev)] = {r.rid: r.tokens_out for r in eng.run()}
        assert eng.step_cache_size() == 1
        if dev != "cpu":
            n = eng.stats.steps
            assert eng.captured_launches() == {
                "decode_attention": 2 * eng.cfg.n_layers}
            assert launch_counts()["decode_attention"] == (
                2 * eng.cfg.n_layers * n)
    assert out["cpu"] == out[str(cuda)]


def test_lm_replayed_step_equals_the_eager_step(cuda):
    """The captured step replayed on a copy of the state equals the eager
    step function run on the same state, bit for bit (tokens, positions,
    cache, logits)."""
    eng = _lm_engine(cuda, "int8")
    for p in ([1, 2, 3], [9] * 12, [4]):
        eng.submit(p, 5)
    eng.close_submissions()
    eng.run()  # warm-up and capture
    eng.reopen()
    eng.submit(list(range(1, 9)), 3)
    eng.submit([7, 7], 4)
    eng.close_submissions()
    eng.run()

    def snapshot():
        flat = {k: v for k, v in eng.state.items() if k != "cache"}
        for st, c in eng.state["cache"].items():
            flat.update((f"{st}.{n}", t) for n, t in c.items())
        return {k: v.clone() for k, v in flat.items()}

    def restore(saved):
        for k, v in saved.items():
            if "." in k:
                st, n = k.split(".")
                eng.state["cache"][st][n].copy_(v)
            else:
                eng.state[k].copy_(v)
    saved = snapshot()
    logits = eng._run_step().clone()
    replayed = snapshot()
    restore(saved)
    eager = eng.step_fn(eng.params, eng.state)
    assert torch.equal(eager, logits)
    for k, v in snapshot().items():
        assert torch.equal(v, replayed[k]), k
    assert eng.step_cache_size() == 1


# ------------------------------------------- the other LM configs' shapes
# (H, Hkv, dh) of granite-moe-1b-a400m (16 over 8, dh 64) and
# codeqwen1.5-7b (MHA, 32 over 32, dh 128): bf16, no cap, no window
NEW_LM_FLASH_HEADS = [(16, 8, 64), (32, 32, 128)]


@pytest.mark.parametrize("sq,skv,q_offset", RAGGED)
@pytest.mark.parametrize("h,hkv,dh", NEW_LM_FLASH_HEADS)
def test_flash_kernel_at_the_new_lm_head_shapes(cuda, h, hkv, dh, sq, skv,
                                                q_offset):
    """The bf16 forward at granite's and codeqwen's heads, causal with no
    cap or window, at ragged lengths, within one bf16 ulp of the twin; two
    launches bit-equal."""
    q, k, v = _qkv(sq + dh + h, 1, h, hkv, sq, skv, dh, torch.bfloat16)
    kw = dict(causal=True, q_offset=q_offset)
    got, want = _flash_both(cuda, q, k, v, **kw)
    again = tfa.flash_attention_bhsd(q.to(cuda), k.to(cuda), v.to(cuda),
                                     **kw)
    rtol, atol = FLASH_TOL[torch.bfloat16]
    assert torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol)
    assert torch.equal(got, again.cpu())


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv,h,hkv,dh", [("bf16", 16, 8, 64),
                                         ("bf16", 32, 32, 128),
                                         ("int8", 40, 40, 128),
                                         ("int8", 48, 8, 128)])
def test_decode_kernel_at_the_new_lm_head_shapes(cuda, kv, h, hkv, dh,
                                                 q_dtype):
    """The decode kernel at granite's and codeqwen's heads on a bf16 cache
    (no cap), and at qwen1.5-32b's (MHA, 40 heads) and grok-1's (48 over
    8) on an int8 one, at every length of ``_decode_edge_lens`` over a
    1,024-position cache, within ``twin_tolerance`` of the twin; two
    launches bit-equal."""
    from repro_torch.kernels import decode_attention as tda
    from repro_torch.models.attention import decode_attention_plain
    b, s = 4, 1024
    q, k, v, ks, vs = _decode_inputs(cuda, kv, b, h, hkv, s, dh, q_dtype,
                                     seed=h + dh)
    kw = dict(logit_cap=None, k_scale=ks, v_scale=vs)
    edges = _decode_edge_lens(s)
    for i in range(0, len(edges), b):
        lens = torch.tensor((edges[i:i + b] * b)[:b], dtype=torch.int32,
                            device=cuda)
        got = tda.decode_attention(q, k, v, lens, **kw)
        again = tda.decode_attention(q, k, v, lens, **kw)
        want = decode_attention_plain(q, k, v, lens, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert _decode_ratio(got, want, tda.twin_tolerance(
            q, k, v, lens, **kw)) <= 1.0, lens.tolist()


def test_moe_engine_captures_one_step_and_equals_cpu(cuda, monkeypatch):
    """granite-moe's smoke config served through the captured step: the
    step (its MoE dispatch included) is captured once (the warm-up runs
    under ``set_sync_debug_mode("error")``, so a host read raises), each
    replay counts two decode launches a layer, and, with admission made
    synchronous on both engines (MoE capacity couples a step's slots), the
    tokens are the CPU engine's."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM
    from repro_torch.serve import ServeEngine
    from repro_torch.serve import feeder
    poll = feeder.AdmissionFeeder.poll

    def synchronous(self, timeout=None):
        while not self.done:
            got = poll(self, timeout=0.01)
            if got is not None:
                return got
        return None
    monkeypatch.setattr(feeder.AdmissionFeeder, "poll", synchronous)
    cfg = get_config("granite-moe-1b-a400m", smoke=True)
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, cfg.vocab, int(rng.integers(1, 17))).tolist(),
             int(rng.integers(1, 20))) for _ in range(9)]
    out = {}
    for dev in ("cpu", cuda):
        model = LM(cfg, seed=0, device="cpu").to(dev)
        eng = ServeEngine(cfg, model, n_slots=4, max_len=64, prompt_cap=16,
                          device=dev)
        reset_launch_counts()
        for p, g in reqs:
            eng.submit(p, g)
        eng.close_submissions()
        out[str(dev)] = {r.rid: r.tokens_out for r in eng.run()}
        assert eng.step_cache_size() == 1
        if dev != "cpu":
            assert eng.captured_launches() == {
                "decode_attention": 2 * cfg.n_layers}
            assert launch_counts()["decode_attention"] == (
                2 * cfg.n_layers * eng.stats.steps)
    assert out["cpu"] == out[str(cuda)]


# ------------------------------------- LM training configs, the recommender
@pytest.mark.parametrize("hot", [1, 2])
def test_gather_rows_backward_on_a_zipf_batch_within_the_twin(cuda, hot):
    """A dlrm-rm2-shaped lookup (26 tables of 50,000 rows, D 64, 8,192
    samples from ``dlrm_batch``'s Zipf law, 38% of a field's lookups on
    row 0): the layout equals a stable ``torch.sort``; the table gradient
    through ``GatherRows`` (one span-sum launch) within
    ``ptr_scan.twin_tolerance`` of the twin's sum of the same rows, the
    same bits on a second backward, and within the same tolerance of the
    dedup lookup's two sums."""
    from repro_torch.data.synthetic import dlrm_batch
    from repro_torch.kernels import ptr_scan
    from repro_torch.models import dlrm as td
    f, v, d, b = 26, 50_000, 64, 8192
    _, idx, _ = dlrm_batch(3, 0, b, 13, f, hot, v)
    idx = torch.from_numpy(idx).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(hot)
    tables = torch.randn((f, v, d), generator=g, device=cuda)
    up = torch.randn((b, f, d), generator=g, device=cuda)
    layout = td.lookup_layout(idx, v)
    sk, order = torch.sort(layout.keys, stable=True)
    assert torch.equal(layout.rev_perm.long(), order)
    assert torch.equal(layout.rev_ptr.long(), torch.searchsorted(
        sk, torch.arange(f * v + 1, device=cuda, dtype=torch.int32)))
    grads = []
    for bag in (td.embedding_bag, td.embedding_bag, td.embedding_bag_dedup):
        t = tables.clone().requires_grad_()
        reset_launch_counts()
        (bag(t, idx, layout) * up).sum().backward()
        torch.cuda.synchronize()
        assert launch_counts()["ptr_seg_sum"] == (
            2 if bag is td.embedding_bag_dedup else 1)
        grads.append(t.grad.view(f * v, d))
    assert torch.equal(grads[0], grads[1])
    rows_g = up.transpose(0, 1)[:, :, None, :].expand(f, b, hot, d)
    x = rows_g.reshape(-1, d).contiguous()
    want = ptr_scan._ptr_seg_sum_plain(layout.rev_ptr, x, layout.rev_perm)
    tol = ptr_scan.twin_tolerance(layout.rev_ptr, x, layout.rev_perm)
    for got in (grads[0], grads[2]):
        assert bool(((got.double() - want.double()).abs() <= tol).all())


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen1.5-32b"])
def test_lm_config_smoke_train_step_on_card_equals_cpu(cuda, arch):
    """The smoke train cell of an MoE and a qkv-bias config (codeqwen's
    smoke dh of 12 has no flash instantiation; float32, 2 x 64
    tokens, remat on): one forward a layer and its recompute, one dq and
    one dk/dv launch a layer; the loss within 1e-5 of the CPU's; every
    gradient within 1e-4 of the CPU's largest value; the parameters after
    one AdamW step within 2 lr + 1e-6; a second step from the same state
    gives the same bits."""
    import copy
    from repro_torch.launch.steps import lm_train_cell, lm_train_step
    from repro_torch.models.transformer import lm_loss
    cell = lm_train_cell(arch, seq_len=64, batch=2, device="cpu",
                         smoke=True)
    cell.model.cfg = dataclasses.replace(cell.model.cfg, remat=True)
    model = copy.deepcopy(cell.model).to(cuda)

    def state_on_card():
        return {"m": {n: t.to(cuda, copy=True)
                      for n, t in cell.opt_state["m"].items()},
                "v": {n: t.to(cuda, copy=True)
                      for n, t in cell.opt_state["v"].items()},
                "step": cell.opt_state["step"].clone()}
    state = state_on_card()
    tokens = cell.tokens.to(cuda)
    lm_loss(cell.model, cell.tokens).backward()
    reset_launch_counts()
    lm_loss(model, tokens).backward()
    torch.cuda.synchronize()
    n = model.cfg.n_layers
    counts = launch_counts()
    assert (counts["flash_attention_fwd"], counts["flash_attention_bwd_dq"],
            counts["flash_attention_bwd_dkv"]) == (2 * n, n, n)
    for (name, p), q in zip(model.named_parameters(),
                            cell.model.parameters()):
        assert float((p.grad.cpu() - q.grad).abs().max()) <= (
            1e-4 * float(q.grad.abs().max().clamp(min=1e-30))), name
    start, start_state = copy.deepcopy(model), state_on_card()
    want = cell.step()
    got = lm_train_step(model, cell.opt_cfg, state, tokens)
    assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-5
    for (name, p), q in zip(model.named_parameters(),
                            cell.model.parameters()):
        assert float((p.detach().cpu() - q.detach()).abs().max()) <= (
            2 * want["lr"] + 1e-6), name
    lm_train_step(start, cell.opt_cfg, start_state, tokens)
    for (name, p), q in zip(model.named_parameters(), start.parameters()):
        assert torch.equal(p, q), name
