"""The open-loop knee: one engine set up once, the cell's mix offered at
each rate in turn for a short window. For each rate: requests answered
per second, the p50 and p95 latency, the median latency of the last
quarter of the window's requests against the first quarter's, and the
requests still waiting when the window closed. The knee is the highest
rate whose backlog does not grow over the window.

    python3 portbench/sweep.py --workload sage_reddit.open \
        --rates 60,80,100,120 --seconds 8 --seed 5
"""
import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args(argv)

    import torch
    from portbench import harness, traffic
    cell = harness.load_cell(args.workload)
    dev = torch.device("cuda:0")
    P = harness.Program()
    P.build_kernels()
    sv = harness.Served(cell, P, args.seed, dev)
    n_nodes = cell.config["graph"]["n_nodes"]
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        mix = dict(cell.traffic, rate_per_s=rate)
        plan = sv.plan(mix, n_nodes, args.seed + i)
        if i:
            sv.engine.reopen()
        win = traffic.serve_window(sv.engine, plan, args.seconds)
        recs = sorted(win.records, key=lambda r: r.due)
        lat = [(r.done - r.due) * 1e3 if r.done is not None else 1e9
               for r in recs]
        q = max(1, len(lat) // 4)
        print(json.dumps(dict(
            rate=rate, requests=len(recs), failed=win.failed,
            answered_per_s=sum(r.done is not None and r.done <= win.t_end
                               for r in recs) / args.seconds,
            p50_ms=statistics.median(lat),
            p95_ms=harness.percentile(lat, 0.95),
            first_quarter_p50_ms=statistics.median(lat[:q]),
            last_quarter_p50_ms=statistics.median(lat[-q:]),
            waiting_at_close=sum(r.done is None or r.done > win.t_end
                                 for r in recs),
            steps=win.steps, late_p99_ms=win.late_p99_ms)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
