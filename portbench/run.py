"""Run one benchmark cell once on the card and print its result.

    python3 portbench/run.py --workload sage_reddit.bulk --seed 7 \
        --seconds 10 --trace 0

From the root of a checkout: ``BENCHMARK.json`` names the cell, ``src/``
holds the program (``repro_torch``). With ``--trace 0`` the result's
metrics are the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics (a slice of the window traced). The last line of
standard output is the result, one JSON object, its ``checks`` (each
number compared, with its limit) last; the same checks are the last lines
of standard error. Exits non-zero, printing no result, without a card,
with fewer cards than the cell asks for, or when JAX or the JAX package
was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HANG_S = 330  # the driver allows a run 360 s
CACHE = ROOT / "build" / "portbench"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # a run still going this long dumps every thread's stack to stderr
    faulthandler.dump_traceback_later(HANG_S)

    import torch
    from portbench import harness
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s), {n} available", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"portbench: the program is missing ({exc}); run from the "
              "root of a checkout of the repository", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found} (JAX or the JAX "
              "package); no result", file=sys.stderr)
        return 3
    torch.cuda.synchronize()
    print(json.dumps(result), flush=True)
    for line in harness.check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
