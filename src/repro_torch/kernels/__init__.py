"""Hand-written Hopper kernels (``csrc/*.cu``) and their plain-torch twins.

Every wrapper takes its plain twin only for a tensor that lies on the CPU;
on a CUDA tensor it launches the kernel or raises. Each wrapper enters
``kernel_scope(name, wrapper, launches)`` on both branches, ``launches``
being how many kernels the call launches on the card; the scope is the
one owner of that number. The kernel branch launches when
``scope.launches`` is non-zero and calls ``scope.launched()``, which adds
it to the wrapper's ``launches`` counter; a census
(``analysis/census.py``) reads the same number from the scope to count
the call on the CPU as on the card and tells the ops issued inside (a
twin's, or the wrapper's own allocations) from the path's own. A replayed
CUDA graph adds the launches captured in it (``add_launch_counts``). The
counters are bumped under one lock: a prefetcher's producer thread
launches kernels beside the consumer.
"""
from __future__ import annotations

import threading

import torch

_COUNT_LOCK = threading.Lock()
# this thread's open kernel scopes (names, innermost last) and the census
# recording it, if any
_SCOPE = threading.local()


def count_launch(fn, n: int = 1) -> None:
    """Add ``n`` to wrapper ``fn``'s launch counter, under the lock."""
    with _COUNT_LOCK:
        fn.launches += n


class kernel_scope:
    """``with kernel_scope(name, wrapper, launches) as scope:`` around a
    wrapper call's work, on either branch; the kernel branch calls
    ``scope.launched()`` where it launches. Costs a list push and pop when
    no census records."""

    __slots__ = ("name", "wrapper", "launches")

    def __init__(self, name: str, wrapper, launches: int = 1):
        self.name, self.wrapper, self.launches = name, wrapper, int(launches)

    def launched(self) -> None:
        """Count this call's launches on the wrapper's counter."""
        count_launch(self.wrapper, self.launches)

    def __enter__(self):
        stack = _SCOPE.__dict__.setdefault("stack", [])
        stack.append(self.name)
        recorder = _SCOPE.__dict__.get("recorder")
        if recorder is not None:
            recorder(self.name, self.launches)
        return self

    def __exit__(self, *exc):
        _SCOPE.stack.pop()
        return False


def current_kernel_scope() -> str | None:
    """The innermost kernel scope open on this thread, or None."""
    stack = _SCOPE.__dict__.get("stack")
    return stack[-1] if stack else None


def set_scope_recorder(recorder) -> object:
    """Make ``recorder(name, launches)`` hear every kernel scope this
    thread enters (None: none); returns the one it replaces."""
    old = _SCOPE.__dict__.get("recorder")
    _SCOPE.recorder = recorder
    return old


def refuse_detached(name: str, x, instead: str) -> None:
    """Raise when grad mode is on and ``x`` requires grad: a kernel called
    through ``ctypes`` leaves no autograd history, so its output would pass
    no gradient back, silently. The CPU twin would, so the rule holds on
    both devices."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(
            f"{name} has no autograd history: under grad mode its input "
            f"must not require grad (call it through {instead}, or under "
            "torch.no_grad())")


def kernel_wrappers():
    """Every kernel wrapper, by name: the ten of the GNN serve paths
    (the SLICE_CFG sorts run digit_hist and digit_scatter, its forward the
    pointer segment sum ptr_seg_sum), the flash
    attention forward of the LM prefill and training paths, its two
    backward kernels (training), the decode attention of the LM serve
    path and its partial mode (a sequence slice of a cache cut over
    ranks), and the four kernels no path runs
    (digit_partition_hist and digit_rank_gather, the reference's digit
    pass one to one; prefix_partition, filter_tree_lookup)."""
    from .decode_attention import decode_attention, decode_attention_partial
    from .flash_attention import flash_attention_bhsd, flash_dkv, flash_dq
    from .merge import fused_merge_rounds, merge_rung
    from .prefix_partition import prefix_partition
    from .ptr_scan import ptr_seg_sum
    from .radix_sort import (chunk_sort, digit_hist, digit_partition_hist,
                             digit_rank_gather, digit_scatter)
    from .reindex_epilogue import rank_search, rename
    from .segment_agg import segment_sum_sorted
    from .set_count import filter_tree_lookup, set_count_less
    return {"digit_hist": digit_hist, "digit_scatter": digit_scatter,
            "digit_partition_hist": digit_partition_hist,
            "digit_rank_gather": digit_rank_gather,
            "rank_search": rank_search, "rename": rename,
            "chunk_sort": chunk_sort, "fused_merge": fused_merge_rounds,
            "merge_rung": merge_rung,
            "set_count_less": set_count_less,
            "segment_sum_sorted": segment_sum_sorted,
            "ptr_seg_sum": ptr_seg_sum,
            "flash_attention_fwd": flash_attention_bhsd,
            "flash_attention_bwd_dq": flash_dq,
            "flash_attention_bwd_dkv": flash_dkv,
            "decode_attention": decode_attention,
            "decode_attention_partial": decode_attention_partial,
            "prefix_partition": prefix_partition,
            "filter_tree_lookup": filter_tree_lookup}


def launch_counts() -> dict[str, int]:
    return {k: fn.launches for k, fn in kernel_wrappers().items()}


def add_launch_counts(counts: dict[str, int]) -> None:
    """Add ``counts`` to the counters: a replayed CUDA graph launches the
    kernels captured in it, but no wrapper runs on the host to count them."""
    wrappers = kernel_wrappers()
    for k, n in counts.items():
        count_launch(wrappers[k], n)


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for fn in kernel_wrappers().values():
            fn.launches = 0
