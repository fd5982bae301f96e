"""Card-only checks of the hand-written kernels (marker ``gpu``): each CUDA
kernel equals its plain-torch twin element for element, and the serve
path on the card gives the integers the CPU path gives. Every test skips
with a reason on a host without a card or nvcc.

Run them on a machine with an H100:
  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core import pipeline as tp  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels import radix_sort as trs  # noqa: E402
from repro_torch.kernels import reindex_epilogue as tre  # noqa: E402

pytestmark = pytest.mark.gpu

SEN = 0x7FFFFFFF
SLICE_CFG = tcm.EngineConfig(use_pallas=True, sort_strategy="global_radix",
                             reindex_strategy="fused")


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
    assert all(v > 0 for v in launch_counts().values()), launch_counts()
