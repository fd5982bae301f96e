"""CLI: ``python -m repro_torch.analysis [--census] [--lint] [--json]
[--grid smoke|full] [--contracts ...] [--device cuda|cpu]``.

Runs the AST lint pass and/or the census contract checker and exits
non-zero on any violation, as the reference's CLI does. With neither
``--census`` nor ``--lint``, both run. The contracts run under both
routings: the plain path (``use_pallas`` off) and the kernel wrappers
(``use_pallas`` on: the twins on the CPU, the kernels on the card).
"""
import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static analysis: AST lint + census contracts")
    ap.add_argument("--census", action="store_true",
                    help="run only the census contract checker")
    ap.add_argument("--lint", action="store_true",
                    help="run only the AST lint pass")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit one JSON report on stdout")
    ap.add_argument("--grid", choices=("smoke", "full"), default="full",
                    help="contract sweep size (default: full)")
    ap.add_argument("--contracts",
                    default="convert,sample,shard,serve,gnn_serve,"
                            "delta_update",
                    help="comma-separated contract subset for --census")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the contracts run (default: the card)")
    ap.add_argument("--root", default=None,
                    help="lint root (default: the installed src/repro_torch)")
    args = ap.parse_args(argv)
    run_lint = args.lint or not args.census
    run_census = args.census or not args.lint

    report: dict = {}
    failed = False

    if run_lint:
        from repro_torch.analysis.lint import lint_tree
        violations = lint_tree(args.root)
        report["lint"] = {"ok": not violations,
                          "violations": [str(v) for v in violations]}
        failed |= bool(violations)
        if not args.as_json:
            for v in violations:
                print(str(v), file=sys.stderr)
            print(f"lint: {len(violations)} violation(s)")

    if run_census:
        from repro_torch.analysis import checker
        progress = None if args.as_json else (
            lambda msg: print(f"  .. {msg}", file=sys.stderr))
        parts = tuple(p for p in args.contracts.split(",") if p)
        rep = checker.check_all(grid=args.grid, parts=parts,
                                device=args.device, progress=progress)
        report["census"] = rep.to_json()
        failed |= not rep.ok
        if not args.as_json:
            for v in rep.violations:
                print(str(v), file=sys.stderr)
            print(f"census: {rep.checks} checks over {rep.groups} program "
                  f"groups, {len(rep.violations)} violation(s)")

    if args.as_json:
        print(json.dumps(report, indent=2))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
