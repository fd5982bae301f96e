"""The merge ladder's kernels (port of ``repro/kernels/merge.py`` and of
the rungs ``repro/core/ordering.py`` ``merge_rounds`` runs above it).

``fused_merge_rounds`` takes the first rungs of the chunked_merge ladder —
every rung whose super-block still fits ``max_block`` elements — and
``merge_rung`` one rung above them. On a CUDA tensor each call is one
launch of ``csrc/merge.cu``'s ``merge_passes``: a fan-in-k rung runs as
ceil(log2 k) merge-path passes (``merge_passes`` below), each merging
consecutive pairs of sub-runs. On a CPU tensor both run their plain twin,
``ordering.merge_ladder`` on the same rungs (``merge_sorted_k`` a rung).
The rungs are the prefix of ``ordering.merge_round_fan_ins`` that fits, so
the ladder in ``ordering.merge_rounds`` continues on exactly the rungs the
reference prescribes.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.ordering import merge_ladder, merge_round_fan_ins

from . import _build, kernel_scope

# Elements of one super-block (the reference's VMEM budget: 2 arrays × in
# and out × 4 B × 65536 = 2 MiB); the kernel's schedule does not depend on
# it, but the rungs it covers do.
DEFAULT_MAX_BLOCK = 65536
# output elements of the smaller tile of csrc/merge.cu (pairs: 256 threads
# x 4; keys: x 8), which sizes the tile-boundary scratch for both
MERGE_TILE = 1024

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "merge_passes": (ctypes.c_int, (_P, _P, _P, _P, _P, _P, _P, _L, _I, _P,
                                    _P, _I, _P)),
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


def merge_passes(run: int, fan_ins: list[int]) -> list[tuple[int, int]]:
    """The kernel's schedule of rungs ``fan_ins`` over runs of ``run``:
    (group, sub-run) of each pass, which merges consecutive pairs of
    sub-runs inside every group (a last sub-run with no partner is
    copied). A fan-in-k rung takes ceil(log2 k) passes: a rung of 3 merges
    runs 0 and 1, then the result with run 2."""
    passes = []
    for k in fan_ins:
        group, r = run * k, run
        while r < group:
            passes.append((group, r))
            r *= 2
        run = group
    return passes


def merge_scratch_len(n: int, passes: list[tuple[int, int]],
                      tile: int = MERGE_TILE) -> int:
    """Ints of tile boundaries the largest pass needs: one more than its
    tiles of ``tile`` elements, for every pair."""
    return max(n // group * -(-group // (2 * r)) * (-(-2 * r // tile) + 1)
               for group, r in passes)


def _check(keys: torch.Tensor, vals: torch.Tensor | None) -> None:
    for t in (keys,) + (() if vals is None else (vals,)):
        if (t.dtype != torch.int32 or t.ndim != 1 or not t.is_contiguous()
                or t.device != keys.device or t.shape[0] != keys.shape[0]):
            raise ValueError("the merge kernels take contiguous 1-D int32 "
                             "CUDA tensors of one length on one device")


def merge_passes_c(keys, vals, run: int, fan_ins: list[int]):
    """``csrc/merge.cu``'s entry on these tensors: the rungs ``fan_ins``
    over sorted runs of ``run``, into new tensors (the input stays);
    returns (keys, vals). Counts no launch: the wrappers do."""
    passes = merge_passes(run, fan_ins)
    n = keys.shape[0]
    out_k = torch.empty_like(keys)
    out_v = None if vals is None else torch.empty_like(vals)
    two = len(passes) > 1  # a second buffer to ping-pong with
    tmp_k = torch.empty_like(keys) if two else None
    tmp_v = torch.empty_like(vals) if two and vals is not None else None
    part = torch.empty(merge_scratch_len(n, passes), dtype=torch.int32,
                       device=keys.device)
    groups = (ctypes.c_int * len(passes))(*(g for g, _ in passes))
    subruns = (ctypes.c_int * len(passes))(*(r for _, r in passes))

    def ptr(t):
        return None if t is None else t.data_ptr()
    _build.check(_build.load("merge", _SIGNATURES).merge_passes(
        keys.data_ptr(), ptr(vals), out_k.data_ptr(), ptr(out_v), ptr(tmp_k),
        ptr(tmp_v), part.data_ptr(), part.shape[0], n, groups, subruns,
        len(passes), _build.stream_of(keys)), "merge_passes")
    return out_k, out_v


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
    with kernel_scope("fused_merge", fused_merge_rounds) as scope:
        block = run * math.prod(fan_ins)
        if not keys.is_cuda:
            return (*merge_ladder(keys, vals, run, fan_ins), block)
        _check(keys, vals)
        scope.launched()
        return (*merge_passes_c(keys, vals, run, fan_ins), block)


fused_merge_rounds.launches = 0


def merge_rung(keys: torch.Tensor, vals: torch.Tensor | None, run: int,
               k: int):
    """One ladder rung: every ``k`` consecutive sorted runs of ``run``
    merged into one, earlier runs winning ties (``ordering.merge_rounds``'s
    ``rung_fn``). Returns (keys, vals); ``vals=None`` merges keys alone."""
    with kernel_scope("merge_rung", merge_rung) as scope:
        if not keys.is_cuda:
            return merge_ladder(keys, vals, run, [k])
        _check(keys, vals)
        if k < 2 or keys.shape[0] % (run * k):
            raise ValueError(f"a rung of {k} runs of {run} does not tile "
                             f"{keys.shape[0]} elements")
        scope.launched()
        return merge_passes_c(keys, vals, run, [k])


merge_rung.launches = 0


def make_merge_fn(fan_in: int = 2):
    """``merge_fn`` for ``ordering.merge_rounds`` with the ladder fan-in
    routed from ``EngineConfig.merge_fan_in``."""

    def merge_fn(keys, vals, run):
        return fused_merge_rounds(keys.contiguous(),
                                  None if vals is None else vals.contiguous(),
                                  run, fan_in=fan_in)

    return merge_fn
