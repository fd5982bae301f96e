"""Hand-written Hopper kernels (``csrc/*.cu``) and their plain-torch twins.

Every wrapper takes its plain twin only for a tensor that lies on the CPU;
on a CUDA tensor it launches the kernel or raises. Each wrapper carries a
``launches`` counter that only the kernel branch bumps (``count_launch``);
a replayed CUDA graph adds the launches captured in it
(``add_launch_counts``). The counters are bumped under one lock: a
prefetcher's producer thread launches kernels beside the consumer.
"""
from __future__ import annotations

import threading

import torch

_COUNT_LOCK = threading.Lock()


def count_launch(fn, n: int = 1) -> None:
    """Add ``n`` to wrapper ``fn``'s launch counter, under the lock."""
    with _COUNT_LOCK:
        fn.launches += n


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
