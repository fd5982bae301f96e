"""Card-only checks of the hand-written kernels (marker ``gpu``): each
integer CUDA kernel equals its plain-torch twin element for element, the
segment sum is within rtol = 1e-5, atol = 1e-4 of its float64 twin and
gives the same bits on every launch, the wrappers refuse what the kernels
cannot take, and both serve paths on the card give the integers the CPU
path gives. Every test skips with a reason on a host without a card or
nvcc.

Run them on a machine with an H100:
  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core import pipeline as tp  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
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
SLICE_KERNELS = ("digit_partition_hist", "digit_rank_gather", "rank_search",
                 "rename")
NEW_KERNELS = ("chunk_sort", "fused_merge", "set_count_less",
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
@pytest.mark.parametrize("n,nq", [(1, 4), (600, 300), (1 << 20, 100_000)])
def test_rank_and_rename_kernels_equal_twins(cuda, side, n, nq):
    rng = np.random.default_rng(n)
    arr = np.sort(rng.integers(0, max(2, n // 3), n)).astype(np.int32)
    arr[n // 2 + 1:] = SEN
    q = rng.integers(-5, n // 3 + 5, nq).astype(np.int32)
    q[rng.random(nq) < 0.2] = SEN
    table = np.arange(n, dtype=np.int32) * 3
    a, qq, tb = map(torch.from_numpy, (arr, q, table))
    assert torch.equal(tre.rank_search(a.to(cuda), qq.to(cuda), side).cpu(),
                       tre.rank_search(a, qq, side))
    assert torch.equal(
        tre.rename(a.to(cuda), tb.to(cuda), qq.to(cuda)).cpu(),
        tre.rename(a, tb, qq))


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


@pytest.mark.parametrize("rb", [2, 4, 8])
@pytest.mark.parametrize("with_vals", [False, True])
@pytest.mark.parametrize("n,chunk,key_bits", [(512, 128, 12), (4096, 64, 7),
                                              (1 << 19, 4096, 19)])
def test_chunk_sort_kernel_equals_twin(cuda, rb, with_vals, n, chunk,
                                       key_bits):
    keys = torch.from_numpy(np.random.default_rng(n + rb).integers(
        0, 1 << key_bits, n).astype(np.int32))
    vals = torch.arange(n, dtype=torch.int32) if with_vals else None
    want = trs.chunk_sort(keys, vals, chunk, key_bits, rb)
    got = trs.chunk_sort(keys.to(cuda), None if vals is None
                         else vals.to(cuda), chunk, key_bits, rb)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0])
    assert (got[1] is None) if vals is None else torch.equal(got[1].cpu(),
                                                             want[1])


def _sorted_runs(n, run, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, max(2, n // 8), n).astype(np.int32)
    return torch.from_numpy(np.sort(keys.reshape(-1, run), 1).reshape(-1))


@pytest.mark.parametrize("fan", [2, 4])
@pytest.mark.parametrize("with_vals", [False, True])
@pytest.mark.parametrize("n,run,mb", [(1024, 64, 65536), (1024, 64, 256),
                                      (512, 128, 128), (1 << 19, 4096, 65536)])
def test_fused_merge_kernel_equals_twin(cuda, fan, with_vals, n, run, mb):
    keys = _sorted_runs(n, run, seed=n + run)
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


def test_new_wrappers_refuse_what_the_kernels_cannot_take(cuda):
    k = torch.zeros(1 << 15, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        trs.chunk_sort(k, k, 1 << 15, 16, 4)
    with pytest.raises(ValueError, match="int32"):
        trs.chunk_sort(k.to(torch.int64), None, 4096, 16, 4)
    with pytest.raises(ValueError, match="int32"):
        tm.fused_merge_rounds(k, k.cpu(), 64)
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
