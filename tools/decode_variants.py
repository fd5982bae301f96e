#!/usr/bin/env python3
"""Time variants of the decode attention kernel against each other, in
turns on one card, at ``tools/slice_ab.py``'s three decode shapes.

  python3 tools/decode_variants.py base packed veltkamp i2f b2s4 nocomp

A variant is ``src/repro_torch/csrc/decode_attention.cu`` with the text
replacements of ``VARIANTS`` made in a copy, built by its own ``nvcc``
(the flags of ``kernels/_build.py``; all started together) into
``build/decode_variants/`` and swapped into the wrapper
``kernels/decode_attention.decode_attention`` in this process. At each
shape (gemma2-9b's heads, bf16 q, cap 50, an int8 cache quantized from
N(0, 1) drawn from ``--seed``) every variant is timed twice, the variants
in the order given and then reversed, with ``chip_smoke.cuda_ms`` (queued
behind a device sleep); each output's share of ``twin_tolerance`` against
the twin (the first slot at 32k) and a checksum of its bits are printed
beside the time (``nocomp`` computes nothing: its output is zeros). Also
printed: each variant's ptxas registers and spills and its main
instantiation's SASS counts (``chip_smoke.DECODE_SASS_OPS``). The run goes
to ``chiprun_out/decode_variants.json``. Needs a card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src", "repro_torch", "csrc", "decode_attention.cu")

_ROUND = '''    const __nv_bfloat162 h = __floats2bfloat162_rn(0.f, __fmul_rn(c, s));
    x[i] = __uint_as_float(*reinterpret_cast<const uint32_t*>(&h));
  }'''
_BYTE = '''    const float c = __fsub_rn(
        __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650u | i)),
        8388736.f);  // 2^23 + c + 128, less 2^23 + 128'''
# name: {text of the source: its replacement}
VARIANTS = {
    "base": {},
    # two products an F2FP, unpacked by a shift and a mask
    "packed": {_ROUND: '''    x[i] = __fmul_rn(c, s);
  }
#pragma unroll
  for (int i = 0; i < 4; i += 2) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[i], x[i + 1]);
    const uint32_t u = *reinterpret_cast<const uint32_t*>(&h);
    x[i] = __uint_as_float(u << 16);
    x[i + 1] = __uint_as_float(u & 0xFFFF0000u);
  }'''},
    # bf16 rounding on the FP32 pipe, Veltkamp's split (exact for
    # 2^-126 <= |p| < 2^111: this tool's data)
    "veltkamp": {_ROUND: '''    const float p = __fmul_rn(c, s), g = __fmul_rn(p, 65537.f);
    x[i] = __fadd_rn(g, __fsub_rn(p, g));
  }'''},
    # the byte converted by I2F
    "i2f": {_BYTE: "    const float c = (float)(int)(signed char)(w >> (8 * i));",
            "  w ^= 0x80808080u;  // each byte c + 128, unsigned\n": ""},
    # 2 CTAs an SM (up to 128 registers) and a 4-stage ring
    "b2s4": {"constexpr int kMinBlocks = 3;": "constexpr int kMinBlocks = 2;",
             "constexpr int kStages = 3;": "constexpr int kStages = 4;"},
    # the rows streamed and no arithmetic on them: the pipeline's floor
    "nocomp": {"if (seg && r < rows) {": "if (false) {"},
}


def build(names):
    """{name: loaded library} of each variant, built in parallel."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as tda
    src = open(SRC).read()
    out_dir = os.path.join(ROOT, "build", "decode_variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name].items():
            if old not in text:
                raise SystemExit(f"variant {name}: its text is not in {SRC}")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    restype, argtypes = tda._SIGNATURES["decode_attention"]
    libs, info = {}, {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(so)
        lib.decode_attention.restype = restype
        lib.decode_attention.argtypes = list(argtypes)
        libs[name] = lib
        info[name] = dict(ptxas=main_ptxas(log), sass=sass_counts(so))
    return libs, info


def main_ptxas(log):
    """ptxas's lines (registers; stack and spills) for the main
    instantiation (bf16 q, int8 cache, 16-byte copies) of the split
    kernel."""
    lines, main = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            main = ("decode_split_kernel" in line
                    and "13__nv_bfloat16aLi16E" in line)
        elif main and ("registers" in line or "spill" in line):
            lines.append(line.split(":", 1)[-1].strip())
    return lines


def sass_counts(so):
    """SASS counts of the main instantiation (bf16 q, int8 cache, 16-byte
    copies) of the split kernel in library ``so``."""
    import chip_smoke as cs
    from repro_torch.kernels import _build
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    for block in sass.split("Function :")[1:]:
        fn, body = block.split("\n", 1)
        if "decode_split_kernel" in fn and "13__nv_bfloat16aLi16E" in fn:
            return {op: len(re.findall(r"\*/\s+(?:@!?U?P\w+\s+)?" + op
                                       + r"\b[.\w]*", body))
                    for op in cs.DECODE_SASS_OPS}
    return {}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="+", choices=sorted(VARIANTS))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import chip_smoke as cs
    from slice_ab import DECODE_SHAPES
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as tda
    from repro_torch.models.attention import (decode_attention_plain,
                                              quantize_kv)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs, info = build(args.variants)
    for name in args.variants:
        print(name, json.dumps(info[name]), flush=True)
    real_load = _build.load
    dev = torch.device("cuda", 0)
    h, hkv, dh = 16, 8, 256
    out = dict(card=smi, variants=info, shapes={})
    order = args.variants + args.variants[::-1]
    try:
        for shape, s, lens in DECODE_SHAPES:
            g = torch.Generator(device=dev).manual_seed(args.seed)
            b = len(lens)
            q = torch.randn((b, h, 1, dh), generator=g, device=dev).to(
                torch.bfloat16)
            k, ks = quantize_kv(torch.randn((b, hkv, s, dh), generator=g,
                                            device=dev))
            v, vs = quantize_kv(torch.randn((b, hkv, s, dh), generator=g,
                                            device=dev))
            cl = torch.tensor(lens, dtype=torch.int32, device=dev)
            kw = dict(logit_cap=50.0, k_scale=ks, v_scale=vs)
            n = 1 if s > 4096 else b
            sub = dict(logit_cap=50.0, k_scale=ks[:n], v_scale=vs[:n])
            want = decode_attention_plain(q[:n], k[:n], v[:n], cl[:n], **sub)
            tol = tda.twin_tolerance(q[:n], k[:n], v[:n], cl[:n], **sub)
            rows = out["shapes"][shape] = {}
            for name in order:
                _build.load = lambda _n, _s, lib=libs[name]: lib

                def kernel():
                    return tda.decode_attention(q, k, v, cl, **kw)
                got = kernel()
                diff = (got[:n].double() - want.double()).abs()
                r = rows.setdefault(name, dict(
                    ms=[], share_of_tol=float(torch.where(
                        diff == 0, 0.0, diff / tol).max()),
                    bits=int(got.view(torch.int16).to(torch.int64).sum())))
                r["ms"].append(cs.cuda_ms(kernel))
            print(shape, json.dumps(rows), flush=True)
            del q, k, v, ks, vs, want, tol
            torch.cuda.empty_cache()
    finally:
        _build.load = real_load
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "decode_variants.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
