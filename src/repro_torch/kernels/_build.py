"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled at first use
by its own ``nvcc`` process (all sources started together) into a shared
library under the git-ignored ``build/`` directory at the repository root,
then loaded with ``ctypes``. A library is named after a hash of its source,
the ``csrc/*.cuh`` headers and the flags, so an edited source or header is
rebuilt and an unchanged one is reused.
Nothing here runs at import time: this module only needs ``nvcc`` and a
card when a kernel is launched.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parents[1] / "build" / "repro_torch"
# every csrc/*.cu, so a new source can never be missing from the build
SOURCES = tuple(sorted(p.stem for p in CSRC_DIR.glob("*.cu")))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}  # name -> nvcc/ptxas output of this process


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    # the shared headers too: an edited header rebuilds every source
    src += b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{h}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all in parallel; returns wall seconds per built
    source (empty when everything was already built). Raises with the
    compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load(name: str, signatures: dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed) with
    ``signatures`` ({symbol: (restype, argtypes)}) applied."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            for sym, (restype, argtypes) in signatures.items():
                fn = getattr(lib, sym)
                fn.restype = restype
                fn.argtypes = list(argtypes)
            _LIBS[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise when a C entry point returned a non-zero cudaError_t."""
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError_t {rc}")


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
