#!/usr/bin/env python3
"""Time tile shapes of the merge-path kernels (``csrc/merge.cu``) on one
card: each shape is the source built with ``-DMERGE_THREADS``,
``-DMERGE_ITEMS_PAIRS`` and ``-DMERGE_ITEMS_KEYS`` into
``build/merge_tiles/`` (all builds started together) and called through
its C entry ``merge_passes``.

  python3 tools/merge_tiles.py

For each shape, at a request's 2^19 elements and the MERGE_CFG convert's
2^27, pairs and keys, on runs of 4096 sorted by ``torch.sort``: the fused
merge's four passes (4096 → 65,536) and one rung above (65,536 →
131,072), each checked against a per-block stable ``torch.sort`` and
timed with ``chip_smoke.cuda_ms`` (CUDA events, queued behind a device
sleep). Prints the card, each shape's ptxas lines and one JSON line per
(size, kind). Needs a card and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (threads, items a thread with values, items a thread of keys alone); the
# first is the source's default
SHAPES = ((256, 4, 8), (256, 8, 16), (256, 2, 4), (128, 4, 8), (128, 8, 16),
          (512, 4, 8), (512, 2, 4))


def build(shapes):
    """{shape: loaded library}, one nvcc per shape, all in parallel."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import merge as tm
    out_dir = os.path.join(ROOT, "build", "merge_tiles")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for th, ip, ik in shapes:
        so = os.path.join(out_dir, f"libmerge_{th}_{ip}_{ik}.so")
        procs[th, ip, ik] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-DMERGE_THREADS={th}",
             f"-DMERGE_ITEMS_PAIRS={ip}", f"-DMERGE_ITEMS_KEYS={ik}", "-o",
             so, str(_build.CSRC_DIR / "merge.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    libs, ptxas = {}, {}
    for shape, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {shape}:\n{log}")
        ptxas[shape] = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                        if "registers" in ln]
        lib = ctypes.CDLL(so)
        restype, argtypes = tm._SIGNATURES["merge_passes"]
        lib.merge_passes.restype = restype
        lib.merge_passes.argtypes = list(argtypes)
        libs[shape] = lib
    return libs, ptxas


def caller(lib, tile, keys, vals, run, fan_ins):
    """A call of ``lib``'s entry on these tensors (outputs allocated once)
    and its outputs."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import merge as tm
    passes = tm.merge_passes(run, fan_ins)
    out_k = torch.empty_like(keys)
    out_v = None if vals is None else torch.empty_like(vals)
    two = len(passes) > 1
    tmp_k = torch.empty_like(keys) if two else None
    tmp_v = torch.empty_like(vals) if two and vals is not None else None
    part = torch.empty(tm.merge_scratch_len(keys.numel(), passes, tile),
                       dtype=torch.int32, device=keys.device)
    groups = (ctypes.c_int * len(passes))(*(g for g, _ in passes))
    subruns = (ctypes.c_int * len(passes))(*(r for _, r in passes))

    def ptr(t):
        return None if t is None else t.data_ptr()

    def call():
        _build.check(lib.merge_passes(
            keys.data_ptr(), ptr(vals), out_k.data_ptr(), ptr(out_v),
            ptr(tmp_k), ptr(tmp_v), part.data_ptr(), part.numel(),
            keys.numel(), groups, subruns, len(passes),
            _build.stream_of(keys)), "merge_passes")
    return call, out_k, out_v


def main():
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # its helpers; it puts ROOT/src on sys.path
    import torch
    from repro_torch.kernels import merge as tm

    if not torch.cuda.is_available():
        print("merge_tiles: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].strip()
    print(smi, flush=True)
    libs, ptxas = build(SHAPES)
    print(json.dumps({"ptxas": {str(k): v for k, v in ptxas.items()}}),
          flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    block = tm.DEFAULT_MAX_BLOCK
    for n, bound in ((cs.SERVE_CAP, cs.SERVE_NODES),
                     (cs.CHUNK_SORT_BIG, cs.REDDIT["nodes"])):
        keys = torch.sort(torch.randint(
            0, bound, (n,), generator=g, device=dev, dtype=torch.int32
        ).view(-1, cs.TILE), dim=1).values.view(-1)
        vals = torch.arange(n, dtype=torch.int32, device=dev)
        for v in (vals, None):
            kind = "pairs" if v is not None else "keys"
            st = torch.sort(keys.view(-1, block), dim=1, stable=True)
            want = (st.values.view(-1), None if v is None else
                    v.view(-1, block).gather(1, st.indices).view(-1))
            del st
            upper_in = want
            st = torch.sort(upper_in[0].view(-1, 2 * block), dim=1,
                            stable=True)
            want_up = (st.values.view(-1), None if v is None else
                       upper_in[1].view(-1, 2 * block).gather(
                           1, st.indices).view(-1))
            del st
            row = {}
            for shape, lib in libs.items():
                tile = shape[0] * (shape[1] if v is not None else shape[2])
                fused, fk, fv = caller(lib, tile, keys, v, cs.TILE,
                                       [2, 2, 2, 2])
                rung, rk, rv = caller(lib, tile, upper_in[0], upper_in[1],
                                      block, [2])
                fused()
                rung()
                torch.cuda.synchronize()
                ok = all(torch.equal(a, b) for a, b in
                         ((fk, want[0]), (rk, want_up[0]))
                         + (() if v is None else ((fv, want[1]),
                                                  (rv, want_up[1]))))
                cs.check(ok, f"shape {shape} at {n} {kind}: == torch.sort")
                row[str(shape)] = dict(fused_ms=cs.cuda_ms(fused),
                                       rung_ms=cs.cuda_ms(rung))
                del fk, fv, rk, rv
            print(json.dumps({f"{n} {kind}": row}), flush=True)
            del want, want_up, upper_in
        del keys, vals
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
