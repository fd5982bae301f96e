"""The dry run (port of ``repro/launch/dryrun.py``): build every (arch ×
shape) cell on meta tensors and report its footprint on a mesh.

The reference lowers and compiles each cell on a virtual production mesh
and reads XLA's memory, cost and collective analyses from the compiled
HLO; a torch program has no compiled text to read (``analysis/census.py``
stands in for the HLO analyses on a running call). Here each cell is
built by ``launch/steps.py`` ``build_cell`` on ``device="meta"`` — every
parameter, state and input a meta tensor, nothing allocated — and the
report gives its status (ok, skipped with the reference's reason, or
error), its parameter, optimizer, cache and argument bytes, and the bytes
one rank holds under the cell's placements on a described mesh of the
production shape (no process group, no card).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-9b \
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --preprocess \
      --out /tmp/dryrun.json

Output goes to stdout, one line a cell, and as JSON to ``--out``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import traceback

import torch

from repro_torch.configs import all_cells
from repro_torch.dist.sharding import local_shape
from repro_torch.launch.mesh import DescribedMesh, production_mesh_shape
from repro_torch.launch.steps import (Cell, batch_fields, build_cell,
                                      preprocess_cells)

MESHES = {"single": False, "multi": True}


def _tree(x):
    """``x`` as plain dicts / tuples of tensors (dataclasses by field)."""
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return tuple(_tree(v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return batch_fields(x)
    return x


def _leaves(tree, pls=None):
    """(tensor, its placement tuple or None) of every tensor leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, None if pls is None else pls[k])
    elif isinstance(tree, tuple):
        # a placement tuple is a leaf's, not a subtree
        for i, v in enumerate(tree):
            yield from _leaves(v, None if pls is None else pls[i])
    elif isinstance(tree, torch.Tensor):
        yield tree, pls


def _nbytes(t: torch.Tensor, shape=None) -> int:
    n = 1
    for d in (t.shape if shape is None else shape):
        n *= d
    return n * t.element_size()


def cell_record(cell: Cell, mesh, mesh_name: str) -> dict:
    """The report of one cell: status, bytes by role, the argument bytes,
    and on ``mesh`` the bytes one rank holds under its placements."""
    rec: dict = {"cell": cell.key, "mesh": mesh_name, "note": cell.note,
                 "mesh_shape": dict(zip(mesh.mesh_dim_names, mesh.shape))}
    if cell.skipped:
        rec.update(status="skipped", skip_reason=cell.skipped)
        return rec
    by_role: dict[str, int] = {}
    rank = 0
    pls = cell.placements
    for i, arg in enumerate(cell.args):
        role = cell.roles[i] if i < len(cell.roles) else "input"
        for t, pl in _leaves(_tree(arg), None if pls is None else pls[i]):
            if t.device.type != "meta":
                raise RuntimeError(f"{cell.key}: an argument off meta "
                                   f"({t.device})")
            by_role[role] = by_role.get(role, 0) + _nbytes(t)
            rank += _nbytes(t, t.shape if pl is None
                            else local_shape(t.shape, mesh, pl))
    rec.update(status="ok", bytes=by_role,
               argument_bytes=sum(by_role.values()), rank_bytes=rank)
    return rec


def _preprocess_record(step, mesh, mesh_name: str) -> dict:
    nbytes = sum(_nbytes(t) for a in step.args
                 for t, _ in _leaves(_tree(a)))
    return {"cell": f"{step.arch_id}__{step.shape_name}", "mesh": mesh_name,
            "note": step.note, "status": "ok",
            "mesh_shape": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "bytes": {"input": nbytes}, "argument_bytes": nbytes}


def _gb(n: int) -> str:
    return f"{n / 1e9:.3f}GB"


def line(rec: dict) -> str:
    status = rec["status"]
    extra = ""
    if status == "ok":
        b = rec["bytes"]
        extra = " " + " ".join(f"{k}={_gb(v)}" for k, v in b.items())
        extra += f" args={_gb(rec['argument_bytes'])}"
        if "rank_bytes" in rec:
            extra += f" rank={_gb(rec['rank_bytes'])}"
    elif status == "skipped":
        extra = " " + rec["skip_reason"][:60]
    else:
        extra = " " + rec["error"][:200]
    return f"[{status}] {rec['cell']} ({rec['mesh']}){extra}"


def run(cells, preprocess: bool, mesh_names, out=print) -> list[dict]:
    """Build and report every cell of ``cells`` (and the preprocessing
    cells) on each named mesh; returns the records."""
    records = []
    for mesh_name in mesh_names:
        mesh = DescribedMesh(*production_mesh_shape(MESHES[mesh_name]))
        for arch_id, shape in cells:
            try:
                rec = cell_record(build_cell(arch_id, shape, mesh,
                                             device="meta"), mesh, mesh_name)
            except Exception as e:  # noqa: BLE001 — record and go on
                rec = {"cell": f"{arch_id}__{shape}", "mesh": mesh_name,
                       "status": "error", "error": repr(e),
                       "traceback": traceback.format_exc()}
            records.append(rec)
            out(line(rec))
        if preprocess:
            for step in preprocess_cells(mesh):
                rec = _preprocess_record(step, mesh, mesh_name)
                records.append(rec)
                out(line(rec))
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--preprocess", action="store_true",
                    help="the AutoGNN engine's cells")
    ap.add_argument("--out", help="write the records as JSON here")
    args = ap.parse_args(argv)
    if args.all:
        cells = all_cells()
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    elif args.arch:
        cells = [(a, s) for a, s in all_cells() if a == args.arch]
    elif args.preprocess:
        cells = []
    else:
        ap.error("--arch/--shape, --all, or --preprocess required")
    names = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    records = run(cells, args.preprocess, names,
                  out=lambda s: print(s, flush=True))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    failures = sum(r["status"] == "error" for r in records)
    if failures:
        print(f"{failures} cell(s) failed", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
