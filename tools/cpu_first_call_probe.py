#!/usr/bin/env python3
"""How often the first multi-threaded ``exp``, ``tanh`` or ``log`` of a
process computes other bits than a later call, on this machine's CPU build
of torch, and which warm-up before it removes the difference.

  python3 tools/cpu_first_call_probe.py [--children 400] [--at-once 24] \
      [--threads N]

The process imports torch and makes its inputs with numpy, running no
torch operation. Then, for each (warm-up, op) condition, it forks
``--children`` children, ``--at-once`` at a time. Each child is a process
whose torch has run nothing yet, as a fresh process just after ``import
torch``: it runs the warm-up, then the op twice on 65,536 float32 values
(the flash twins' ``[2, 2, 2, 128, 64]`` score block, on every intra-op
thread), and reports whether the two calls gave the same bits, the first
call's largest error relative to float64, and the first and last index
where they differ. ``--threads`` sets each child's intra-op threads
first (torch's default otherwise; more threads make the fault more
frequent). Warm-ups:

- ``none``: nothing;
- ``exp4``: one ``torch.exp`` of 4 values (under the parallel grain, so on
  one thread);
- ``same4``: the op itself on 4 values;
- ``sin4``: ``torch.sin`` of 4 values (another of torch's vectorised
  transcendental kernels, not one the twins call);
- ``mkl_sin4``: MKL's own ``vmsSin`` of 4 values, called through ctypes
  from torch's library (where torch exports it), no torch operation;
- ``pool``: one parallel ``torch.add`` of 65,536 values (starts the
  intra-op thread pool and runs no transcendental op).

Prints one JSON object (also written to ``chiprun_out/first_call_probe.json``)
with torch's version and parallel configuration and, per condition, the
children whose two calls differed.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import numpy as np
import torch

N = 65_536
OPS = ("exp", "tanh", "log")
WARMUPS = ("none", "exp4", "same4", "sin4", "mkl_sin4", "pool")
# the mode bits of an MKL VML call: high accuracy, errors ignored
VML_HA_IGNORE = 0x2 | 0x100


def inputs(seed: int) -> dict[str, np.ndarray]:
    """Each op's float32 input, in the range the flash twins give it."""
    rng = np.random.default_rng(seed)
    return {"exp": rng.uniform(-10, 0, N).astype(np.float32),  # s - m
            "tanh": rng.normal(0, 1.5, N).astype(np.float32),  # s / cap
            "log": rng.uniform(1, 64, N).astype(np.float32)}  # l


def mkl_sin():
    """MKL's ``vmsSin`` as linked into torch's CPU library, or None."""
    lib = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), "lib",
                                   "libtorch_cpu.so"))
    fn = getattr(lib, "vmsSin", None)
    if fn is not None:
        fn.argtypes = (ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_uint64)
        fn.restype = None
    return fn


def child(op: str, warm: str, x: np.ndarray, want: np.ndarray,
          threads: int | None = None) -> dict:
    """The warm-up and two calls of ``op``, in a process whose torch has
    run nothing yet."""
    if threads:
        torch.set_num_threads(threads)
    fn = getattr(torch, op)
    if warm not in WARMUPS:
        raise ValueError(warm)
    if warm == "exp4":
        torch.exp(torch.zeros(4))
    elif warm == "same4":
        fn(torch.ones(4))
    elif warm == "sin4":
        torch.sin(torch.zeros(4))
    elif warm == "mkl_sin4":
        four = (ctypes.c_float * 4)()
        mkl_sin()(4, four, four, VML_HA_IGNORE)
    elif warm == "pool":
        torch.add(torch.from_numpy(x), 1.0)
    t = torch.from_numpy(x)
    first, second = fn(t).numpy(), fn(t).numpy()
    diff = np.flatnonzero(first != second)
    rel = np.abs(first.astype(np.float64) - want) / np.abs(want)
    return {"same_bits": diff.size == 0,
            "first_max_rel_err": float(rel.max()),
            "second_max_rel_err": float(
                (np.abs(second.astype(np.float64) - want)
                 / np.abs(want)).max()),
            "differ_from": int(diff[0]) if diff.size else None,
            "differ_to": int(diff[-1]) if diff.size else None,
            "n_differ": int(diff.size)}


def run_condition(op: str, warm: str, x: np.ndarray, want: np.ndarray,
                  children: int, at_once: int,
                  threads: int | None = None) -> list[dict]:
    """Fork ``children`` children, ``at_once`` at a time; their reports."""
    reports = []
    left = children
    while left:
        batch = []
        for _ in range(min(at_once, left)):
            r, w = os.pipe()
            pid = os.fork()
            if pid == 0:  # the child: report through the pipe and leave
                os.close(r)
                try:
                    out = json.dumps(child(op, warm, x, want, threads))
                except BaseException as e:  # noqa: BLE001
                    out = json.dumps({"error": repr(e)})
                os.write(w, out.encode())
                os._exit(0)
            os.close(w)
            batch.append((pid, r))
        for pid, r in batch:
            with os.fdopen(r) as f:
                reports.append(json.loads(f.read()))
            os.waitpid(pid, 0)
        left -= len(batch)
    return reports


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--children", type=int, default=400)
    ap.add_argument("--at-once", type=int, default=24)
    ap.add_argument("--threads", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    xs = inputs(args.seed)
    wants = {op: getattr(np, op)(x.astype(np.float64))
             for op, x in xs.items()}
    # torch's parallel configuration is read after the children ran: the
    # read calls into MKL and OpenMP, which the children must find untouched
    result = {"torch": torch.__version__, "cpu_count": os.cpu_count(),
              "children": args.children, "at_once": args.at_once,
              "threads": args.threads, "conditions": []}
    has_mkl_sin = mkl_sin() is not None
    for warm in WARMUPS:
        if warm == "mkl_sin4" and not has_mkl_sin:
            continue
        for op in OPS:
            reps = run_condition(op, warm, xs[op], wants[op], args.children,
                                 args.at_once, args.threads)
            bad = [r for r in reps if not r.get("same_bits", False)]
            row = {"warm": warm, "op": op, "children": len(reps),
                   "differed": len(bad),
                   "errors": sum("error" in r for r in reps),
                   "max_first_rel_err": max(
                       (r.get("first_max_rel_err", 0.0) for r in reps),
                       default=0.0),
                   "max_second_rel_err": max(
                       (r.get("second_max_rel_err", 0.0) for r in reps),
                       default=0.0),
                   "differing": bad[:5]}
            result["conditions"].append(row)
            print(f"{warm:8s} {op:5s} differed {row['differed']} of "
                  f"{row['children']}, first call's worst rel err "
                  f"{row['max_first_rel_err']:.3g}", file=sys.stderr)
    result.update(parallel_info=torch.__config__.parallel_info(),
                  mkl=torch.backends.mkl.is_available(),
                  mkl_vmsSin_exported=has_mkl_sin)
    line = json.dumps(result)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "first_call_probe.json"), "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
