"""The yardstick's counts against hand-worked values."""
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[2])]

import pytest  # noqa: E402

from portbench.counts import model_counts, peaks  # noqa: E402
from portbench.counts.convert import convert_bytes  # noqa: E402
from portbench.counts.preprocess import request_bytes  # noqa: E402
from portbench.reference.graph import expected_in_degree  # noqa: E402


def test_convert_bytes_at_reddit_size():
    # 12 B per live edge (dst and src read, src written), 4 B per pointer
    assert convert_bytes(232_965, 114_615_892) == 1_376_322_568
    assert convert_bytes(232_965, 114_615_892) / peaks()[
        "hbm_bytes_per_s"] == pytest.approx(0.411e-3, rel=1e-3)


def test_graphsage_flops_by_hand():
    model = {"kind": "graphsage", "n_layers": 2, "d_hidden": 4}
    # n 3 nodes, e 5 edges, d_in 6, 2 classes:
    # layer 1: (5 + 3) * 6 + 4 * 3 * 6 * 4 + 3 * 4 + 4 * 3 * 4 = 396
    # layer 2: (5 + 3) * 4 + 4 * 3 * 4 * 4 + 3 * 4 = 236; head 2*3*4*2 = 48
    got = model_counts("graphsage").forward_flops(model, 6, 2, 3, 5)
    assert got == 396 + 236 + 48


def test_gatedgcn_flops_by_hand():
    model = {"kind": "gatedgcn", "n_layers": 2, "d_hidden": 3}
    # embed 2*4*5*3 = 120; a layer: 8*4*9 + 2*6*9 + 18*6*3 + 13*4*3 = syn
    layer = 288 + 108 + 324 + 156
    got = model_counts("gatedgcn").forward_flops(model, 5, 2, 4, 6)
    assert got == 120 + 2 * layer + 2 * 4 * 3 * 2


def test_preprocess_bytes_by_hand():
    # 2 seeds, 4 live frontier slots, 6 edges, 5 distinct nodes
    assert request_bytes(2, 4, 6, 5) == 8 + 32 + 24 + 20 + 24 + 24


def test_the_generators_degrees_at_reddit_size():
    n, e = 232_965, 114_615_892
    assert expected_in_degree(n, e, 0.5, 1) == pytest.approx(118_912, rel=1e-3)
    assert expected_in_degree(n, e, 0.5, n) == pytest.approx(246.4, rel=1e-2)
    assert expected_in_degree(n, e, 0.5, (n + 1) // 2) == pytest.approx(
        348.4, rel=1e-2)


def test_a_traced_slice_reads_busy_time_and_gaps():
    from portbench.tracing import SLICE_SPAN, summarize
    ms = 1_000_000
    rows = [(False, SLICE_SPAN, 0, 100 * ms),
            (False, "aten::copy_", 40 * ms, 70 * ms),
            (True, "kernel_a", -5 * ms, 20 * ms),  # clipped at the start
            (True, "kernel_b", 10 * ms, 30 * ms),  # overlaps kernel_a
            (True, "kernel_a", 80 * ms, 90 * ms)]
    got = summarize(rows, 0.1)
    assert got["window_s"] == 0.1 and got["busy_s"] == 0.04
    assert got["device_ops"] == [["kernel_a", 0.03], ["kernel_b", 0.02]]
    assert got["idle_gaps"] == [["aten::copy_", 0.05], [
        "no host operation recorded", 0.01]]
    # a slice that is missing, shorter than asked, or idle throughout
    # fails the run rather than reading ~100% idle
    for bad, seconds in (([(True, "kernel_a", 0, 1)], 0.1), (rows, 1.0),
                         (rows[:2], 0.1)):
        with pytest.raises(RuntimeError):
            summarize(bad, seconds)
