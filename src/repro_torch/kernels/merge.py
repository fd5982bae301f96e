"""The fused merge ladder (port of ``repro/kernels/merge.py``).

``fused_merge_rounds`` takes the first rungs of the chunked_merge ladder —
every rung whose super-block still fits ``max_block`` elements — in one
pass: on a CUDA tensor one launch of the kernel of ``csrc/merge.cu``, on a
CPU tensor its plain twin, ``ordering.merge_ladder`` on the same rungs.
The rungs are the prefix of ``ordering.merge_round_fan_ins`` that fits, so
the plain ladder in ``ordering.merge_rounds`` continues on exactly the
rungs the reference prescribes.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.ordering import merge_ladder, merge_round_fan_ins

from . import _build

# Elements of one super-block (the reference's VMEM budget: 2 arrays × in
# and out × 4 B × 65536 = 2 MiB); the kernel's schedule does not depend on
# it, but the rungs it covers do.
DEFAULT_MAX_BLOCK = 65536

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "fused_merge": (ctypes.c_int, (_P, _P, _P, _P, _I, _I, _I, _P)),
}


def _round_fan_ins(n: int, run: int, max_block: int,
                   fan_in: int) -> list[int]:
    """The prefix of the ladder's rungs (``merge_round_fan_ins``) whose
    super-block still fits ``max_block`` elements."""
    fans = []
    block = run
    for k in merge_round_fan_ins(n, run, fan_in):
        if block * k > max_block:
            break
        fans.append(k)
        block *= k
    return fans


def fused_merge_rounds(keys: torch.Tensor, vals: torch.Tensor | None,
                       run: int, max_block: int = DEFAULT_MAX_BLOCK,
                       fan_in: int = 2):
    """Merge sorted runs of ``run`` up to super-blocks of at most
    ``max_block``, ``fan_in`` runs per rung; earlier runs win ties.

    Returns ``(keys, vals, new_run)``, the ``merge_fn`` contract of
    ``ordering.merge_rounds``, with ``new_run = run · prod(fan-ins)``; a
    no-op when no rung fits. ``vals=None`` merges keys alone.
    """
    n = keys.shape[0]
    fan_ins = _round_fan_ins(n, run, max_block, fan_in)
    if not fan_ins:
        return keys, vals, run
    block = run * math.prod(fan_ins)
    if not keys.is_cuda:
        return (*merge_ladder(keys, vals, run, fan_ins), block)
    for t in (keys,) + (() if vals is None else (vals,)):
        if (t.dtype != torch.int32 or t.ndim != 1 or not t.is_contiguous()
                or t.device != keys.device or t.shape[0] != n):
            raise ValueError("the fused merge takes contiguous 1-D int32 "
                             "CUDA tensors of one length on one device")
    out_k = torch.empty_like(keys)
    out_v = None if vals is None else torch.empty_like(vals)
    fused_merge_rounds.launches += 1
    _build.check(_build.load("merge", _SIGNATURES).fused_merge(
        keys.data_ptr(), None if vals is None else vals.data_ptr(),
        out_k.data_ptr(), None if out_v is None else out_v.data_ptr(), n, run,
        block, _build.stream_of(keys)), "fused_merge")
    return out_k, out_v, block


fused_merge_rounds.launches = 0


def make_merge_fn(fan_in: int = 2):
    """``merge_fn`` for ``ordering.merge_rounds`` with the ladder fan-in
    routed from ``EngineConfig.merge_fan_in``."""

    def merge_fn(keys, vals, run):
        return fused_merge_rounds(keys.contiguous(),
                                  None if vals is None else vals.contiguous(),
                                  run, fan_in=fan_in)

    return merge_fn
