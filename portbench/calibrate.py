"""Readings for a cell's correctness limits, many seeds in one process:
each seed's run (a short window at the cell's own load) with the numbers
compared, and the control's numbers beside them (``harness.run_cell``'s
``control``). The limits in ``limits/<cell>.json`` are set from these.

    python3 portbench/calibrate.py --workload sage_reddit.bulk \
        --seeds 11,12,13 --seconds 3 --out chiprun_out/cal.json
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = harness.run_cell(cell, seed, args.seconds, False, "cuda:0",
                             t0, control=True)
        row = dict(seed=seed, correct=r["correct"], attempted=r["attempted"],
                   failed=r["failed"], metrics=r["metrics"],
                   checks={k: c["value"] for k, c in r["checks"].items()},
                   control=r["control"], run=r["run"],
                   seconds=time.perf_counter() - t0)
        rows.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(dict(
        workload=args.workload, device=torch.cuda.get_device_name(0),
        rows=rows), indent=1))
    for k in rows[0]["checks"]:
        vals = [row["checks"][k] for row in rows]
        print(f"program {k}: max {max(vals)!r} over {len(vals)} seeds")
    for k in rows[0]["control"]:
        vals = [row["control"][k] for row in rows]
        print(f"control {k}: min {min(vals)!r} max {max(vals)!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
