"""The pointer segment sum's span-sum kernel (``csrc/ptr_scan.cu``) on the
CPU: its float32 arithmetic emulated in numpy in the kernel's exact order
(pieces summed from 0 in row order, combined adjacent pair by adjacent
pair; the kernel's distribution of a long span over piece blocks and a
register stack gives the same bits) within ``twin_tolerance`` of the twin,
the tolerance computed from the rows the sum reads; and the forward's use
of it bit for bit what the unfused composition gave: GraphSAGE's
gather-and-mean call against the masked message stream, its degree sum and
the division, the mask-free pointer ``seg_sum`` against the masked one,
and every family's forward through ``subgraph_batch``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core import pipeline as tp  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels import ptr_scan  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402

# csrc/ptr_scan.cu's constants
PIECE, MAX_PIECES, SERIAL_ROWS, THREADS = 32, 1024, 256, 256
N_NODES, D_FEAT, N_CLASSES = 300, 12, 7
SLICE_CFG = tcm.EngineConfig(w_upe=256, use_pallas=True,
                             sort_strategy="global_radix",
                             reindex_strategy="fused")

_rng = np.random.default_rng(3)
_DST, _SRC = tg.random_coo(_rng, N_NODES, 2500)
FEATS = _rng.normal(size=(N_NODES, D_FEAT)).astype(np.float32)


# ------------------------------------------------ the kernel's arithmetic
def _piece_sums(m):
    """A span's rows [len, D] float32 cut into pieces of the kernel's
    length, each summed from 0 in row order (np.add.accumulate is
    sequential)."""
    n, d = m.shape
    p = max(PIECE, -(-n // MAX_PIECES))
    zero = np.zeros((1, d), np.float32)
    return [np.add.accumulate(np.concatenate([zero, m[k:k + p]]), axis=0,
                              dtype=np.float32)[-1] for k in range(0, n, p)]


def _pairwise(vals, d):
    """Adjacent pair by adjacent pair, level by level; an odd last one
    carries up."""
    while len(vals) > 1:
        vals = [vals[i] + vals[i + 1] if i + 1 < len(vals) else vals[i]
                for i in range(0, len(vals), 2)]
    return vals[0] if vals else np.zeros(d, np.float32)


def _stack_sum(vals, d):
    """block_sum's register stack: level l holds a pending sum of 2^l
    pieces; folded right to left at the end."""
    stack = {}
    for q, v in enumerate(vals):
        lvl = 0
        while (q >> lvl) & 1:
            v = stack[lvl] + v
            lvl += 1
        stack[lvl] = v
    acc = None
    for lvl in range(len(vals).bit_length()):
        if (len(vals) >> lvl) & 1:
            acc = stack[lvl] if acc is None else stack[lvl] + acc
    return np.zeros(d, np.float32) if acc is None else acc


def _distributed(vals, d, n_blocks):
    """The kernel's long phase: the smallest aligned block of 2^m pieces
    with at most ``n_blocks`` blocks, each block by the stack, the blocks
    combined pairwise (shared memory)."""
    k = len(vals)
    m = 0
    while -(-k // (1 << m)) > n_blocks:
        m += 1
    blocks = [_stack_sum(vals[r << m:(r + 1) << m], d)
              for r in range(-(-k // (1 << m)))]
    s = 1
    while s < len(blocks):
        for r in range(0, len(blocks) - s, 2 * s):
            blocks[r] = blocks[r] + blocks[r + s]
        s *= 2
    return blocks[0] if blocks else np.zeros(d, np.float32)


def _span_sum_emulation(ptr, x, rows=None, mean=False):
    """csrc/ptr_scan.cu in numpy float32: each span's rows (through
    ``rows``, clamped, when given) in pieces, combined pairwise; a long
    span (more than SERIAL_ROWS rows) as its long phase distributes it
    over piece blocks for D's column width; with ``mean`` divided by the
    span's length."""
    ptr = np.asarray(ptr, np.int64)
    m = x if rows is None else x[np.clip(rows, 0, x.shape[0] - 1)]
    d = x.shape[1]
    vec = 2 if d % 2 == 0 else 1
    n_blocks = THREADS // min(d // vec, 8 // vec)  # a sector of columns
    out = np.zeros((ptr.shape[0] - 1, d), np.float32)
    for i in range(ptr.shape[0] - 1):
        a, b = int(ptr[i]), int(ptr[i + 1])
        vals = _piece_sums(m[a:b])
        s = (_pairwise(vals, d) if b - a <= SERIAL_ROWS
             else _distributed(vals, d, n_blocks))
        out[i] = s / np.float32(max(b - a, 1)) if mean else s
    return out


@pytest.mark.parametrize("n_blocks", [1, 32, 64, 85, 128, 256])
def test_kernel_distribution_gives_the_pairwise_order(n_blocks):
    """The long phase's blocks (aligned 2^m pieces, a register stack
    each, then pairs in shared memory) and the short phase's one stack
    give the bits of the pairwise combination level by level, for every
    piece count up to the kernel's 1024, on values whose sums depend on
    the association."""
    rng = np.random.default_rng(n_blocks)
    vals = [np.float32(v) * np.ones(2, np.float32) for v in
            rng.normal(size=MAX_PIECES) * 10.0 ** rng.integers(-4, 5,
                                                              MAX_PIECES)]
    for k in list(range(0, 70)) + [255, 256, 257, 511, 777, 1000, 1024]:
        want = _pairwise(vals[:k], 2)
        got = (_stack_sum(vals[:k], 2) if n_blocks == 1
               else _distributed(vals[:k], 2, n_blocks))
        assert np.array_equal(got, want), k


def _ragged_ptr(rng, n_rows, n_segs):
    """Sorted pointers in [0, n_rows] with empty segments, a first pointer
    past 0 and a last one short of n_rows."""
    p = np.sort(rng.integers(3, n_rows - 2, n_segs + 1))
    p[n_segs // 3:n_segs // 3 + 5] = p[n_segs // 3]
    return p.astype(np.int32)


def _case(split, rng):
    """(ptr, E): ``fanout`` spans (at most a few dozen rows), or the same
    with one span of 33,000 rows in the middle (pieces of 33 rows,
    1,000 of them: the kernel's long phase)."""
    if split == "fanout":
        return _ragged_ptr(rng, 2000, 300), 2000
    p = _ragged_ptr(rng, 3000, 400)
    p[201:] += 33_000
    return p, 36_000


@pytest.mark.parametrize("offset", [0.0, 300.0], ids=["centred", "drifting"])
@pytest.mark.parametrize("split", ["fanout", "long"])
def test_span_kernel_arithmetic_within_the_derived_tolerance(offset, split):
    """The span-sum kernel's float32 arithmetic, emulated, lies within
    twin_tolerance of the twin on ragged pointers, also where the stream
    drifts far from zero (large ulps) and where one span is cut into a
    thousand pieces. The tolerance is not loose: a row left out of a span
    lands outside it."""
    rng = np.random.default_rng(12)
    ptr, e = _case(split, rng)
    msgs = (rng.normal(size=(e, 5)) + offset).astype(np.float32)
    tptr = torch.from_numpy(ptr)
    twin = ptr_scan.ptr_seg_sum(tptr, torch.from_numpy(msgs))
    tol = ptr_scan.twin_tolerance(tptr, torch.from_numpy(msgs))
    emu = torch.from_numpy(_span_sum_emulation(ptr, msgs))
    err = (emu.double() - twin.double()).abs()
    assert bool((err <= tol).all()), float((err / tol.clamp_min(1e-30)).max())
    faulty = msgs.copy()
    i = int(np.argmax(np.diff(ptr[:200]) >= 2))
    faulty[int(ptr[i]) + 1] = 0.0  # a row inside a short span dropped
    emu_f = torch.from_numpy(_span_sum_emulation(ptr, faulty))
    assert not bool(((emu_f.double() - twin.double()).abs() <= tol).all())


@pytest.mark.parametrize("split", ["fanout", "long"])
def test_span_kernel_gather_and_mean_within_the_derived_tolerance(split):
    """With a gather index (out-of-range entries clamped, as gather_src
    does) and the mean, the emulated kernel against the twin within
    twin_tolerance(ptr, x, rows, mean=True); a dropped row lands outside."""
    rng = np.random.default_rng(13)
    ptr, e = _case(split, rng)
    x = (rng.normal(size=(500, 6)) + 40.0).astype(np.float32)
    rows = rng.integers(0, 500, e).astype(np.int32)
    rows[::97] = 0x7FFFFFFF  # SENTINEL: clamped to the last row
    args = (torch.from_numpy(ptr), torch.from_numpy(x),
            torch.from_numpy(rows))
    twin = ptr_scan.ptr_seg_sum(*args, mean=True)
    tol = ptr_scan.twin_tolerance(*args, mean=True)
    emu = torch.from_numpy(_span_sum_emulation(ptr, x, rows, mean=True))
    err = (emu.double() - twin.double()).abs()
    assert bool((err <= tol).all()), float((err / tol.clamp_min(1e-30)).max())
    x_f = np.concatenate([x, np.zeros((1, 6), np.float32)])
    rows_f = np.clip(rows, 0, 499)
    i = int(np.argmax(np.diff(ptr[:200]) >= 2))
    rows_f[int(ptr[i]) + 1] = 500  # a row inside a short span read as 0
    emu_f = torch.from_numpy(_span_sum_emulation(ptr, x_f, rows_f,
                                                 mean=True))
    assert not bool(((emu_f.double() - twin.double()).abs() <= tol).all())


def test_twin_tolerance_reads_only_the_rows_below_ptr_end():
    """The derived tolerance takes its prefix maximum over the rows below
    ptr[N] (through the gather, when there is one): rows the sum never
    reads, however large, leave it unchanged; it equals the bound
    computed by hand from those rows."""
    rng = np.random.default_rng(14)
    ptr = torch.from_numpy(_ragged_ptr(rng, 400, 60))
    end = int(ptr[-1])
    msgs = torch.from_numpy(rng.normal(size=(400, 3)).astype(np.float32))
    huge = msgs.clone()
    huge[end:] = 1e30
    tol = ptr_scan.twin_tolerance(ptr, msgs)
    assert torch.equal(tol, ptr_scan.twin_tolerance(ptr, huge))
    m = torch.cumsum(msgs[:end].double(), 0).abs().amax(0)
    ulp = torch.ldexp(torch.ones(3, dtype=torch.float64),
                      torch.frexp(2 * m)[1] - 24)
    seg = (ptr[1:] - ptr[:-1]).double()[:, None]
    assert torch.equal(tol, (2 * seg + 4) * ulp)
    assert torch.equal(ptr_scan.twin_tolerance(ptr, msgs, mean=True),
                       (2 * seg + 4) * ulp / seg.clamp(min=1) + 2 * ulp)
    x = torch.from_numpy(rng.normal(size=(50, 3)).astype(np.float32))
    rows = torch.from_numpy(rng.integers(0, 49, 400).astype(np.int32))
    x_huge = torch.cat([x, torch.full((1, 3), 1e30)])
    rows_huge = rows.clone()
    rows_huge[end:] = 50  # only past ptr[N]: the huge row
    assert torch.equal(ptr_scan.twin_tolerance(ptr, x, rows),
                       ptr_scan.twin_tolerance(ptr, x_huge, rows_huge))


# ------------------------------------------- the forward, bit for bit
def _csc():
    return tp.convert(tg.COO.from_arrays(_DST, _SRC, N_NODES, capacity=4096,
                                         device="cpu"), SLICE_CFG,
                      device="cpu")


def _batches():
    """Pointer batches of sampled subgraphs (subgraph_batch), a few seed
    counts and fanouts, with SENTINEL tails."""
    csc, feats = _csc(), torch.from_numpy(FEATS)
    out = []
    for i, (n_seeds, fanouts) in enumerate([(1, (3, 2)), (6, (4, 3)),
                                            (16, (5, 2))]):
        seeds = torch.from_numpy(np.random.default_rng(i).choice(
            N_NODES, n_seeds, replace=False).astype(np.int32))
        sub = tp.sample_subgraph(csc, seeds, fanouts,
                                 prng.fold_in(prng.PRNGKey(7), i), SLICE_CFG)
        out.append(tgnn.subgraph_batch(sub, feats))
    return out


def _masked_seg_sum(batch, msgs):
    """The pointer seg_sum as it was: the message stream masked by the
    valid-edge test, then the pointer sum."""
    msgs = torch.where(tgnn._valid(batch)[:, None], msgs,
                       torch.zeros((), dtype=msgs.dtype))
    return tgnn._ptr_seg_sum(batch.ptr, msgs)


def _unfused_agg(batch, h, mean):
    """GraphSAGE's pointer aggregation as it was: the [E, D] gather, the
    masked pointer sum, and for the mean the masked degree sum of a ones
    column and the division."""
    s = _masked_seg_sum(batch, tgnn.gather_src(batch, h))
    if not mean:
        return s
    deg = _masked_seg_sum(batch, torch.ones((batch.edge_dst.shape[0], 1)))
    return s / torch.clamp(deg, min=1.0)


def test_pointer_batches_keep_every_span_row_valid():
    """The invariant that lets the pointer path drop the mask: every edge
    position below ptr[N] is valid (its dst inside the batch), every
    invalid one lies at or past ptr[N]."""
    for batch in _batches():
        end = int(batch.ptr[-1])
        valid = tgnn._valid(batch)
        assert bool(valid[:end].all()) and not bool(valid[end:].any())
        assert end < batch.edge_dst.shape[0]  # a SENTINEL tail exists


@pytest.mark.parametrize("mean", [True, False], ids=["mean", "sum"])
def test_gather_mean_call_equals_the_unfused_composition(mean):
    """_ptr_seg_sum with rows and mean (one ptr_seg_sum call) gives
    the bits of seg_mean(batch, gather_src(batch, h)) as the forward
    computed it before: the masked stream, its pointer sum, the degree sum
    and the division; and of today's seg_mean / seg_sum."""
    for batch in _batches():
        h = batch.node_feat
        got = tgnn._ptr_seg_sum(batch.ptr, h, batch.edge_src, mean)
        assert torch.equal(got, _unfused_agg(batch, h, mean))
        now = (tgnn.seg_mean if mean else tgnn.seg_sum)(
            batch, tgnn.gather_src(batch, h))
        assert torch.equal(got, now)


def test_seg_sum_without_the_mask_equals_the_masked_sum():
    """On pointer batches the mask-free seg_sum gives the bits of the
    masked one, also for messages that are large on the invalid edges
    (GatedGCN's gates are not zero there) and for the ones column."""
    rng = np.random.default_rng(5)
    for batch in _batches():
        e = batch.edge_dst.shape[0]
        for msgs in (torch.from_numpy(rng.normal(size=(e, 4)).astype(
                np.float32) * 1e3), torch.ones((e, 1)),
                tgnn.gather_src(batch, batch.node_feat)):
            assert torch.equal(tgnn.seg_sum(batch, msgs),
                               _masked_seg_sum(batch, msgs))


@pytest.mark.parametrize("arch", ["graphsage-reddit", "gat-cora",
                                  "gatedgcn", "meshgraphnet"])
def test_family_forwards_through_subgraph_batch_keep_their_bits(arch,
                                                                monkeypatch):
    """Every family's forward on pointer batches from subgraph_batch gives
    the bits the forward gave before: GraphSAGE (mean and sum) against its
    unfused aggregation, the others with seg_sum swapped for the masked
    one."""
    cfg = get_config(arch, smoke=True)
    ptr_sum = tgnn._ptr_seg_sum
    aggs = ("mean", "sum") if cfg.kind == "graphsage" else (cfg.aggregator,)
    for agg in aggs:
        model = tgnn.gnn_model(
            dataclasses.replace(cfg, aggregator=agg), d_in=D_FEAT,
            n_classes=N_CLASSES, generator=torch.Generator().manual_seed(2),
            device="cpu")
        for batch in _batches():
            def unfused(ptr, x, rows=None, mean=False, batch=batch):
                if rows is None:
                    return ptr_sum(ptr, x)
                assert rows is batch.edge_src
                return _unfused_agg(batch, x, mean)

            with torch.no_grad():
                got = model(batch)
                with monkeypatch.context() as mp:
                    mp.setattr(tgnn, "seg_sum", lambda b, m, use_pallas=False:
                               _masked_seg_sum(b, m))
                    mp.setattr(tgnn, "_ptr_seg_sum", unfused)
                    want = model(batch)
            assert torch.equal(got, want), (arch, agg)
