"""Hand-written Hopper kernels (``csrc/*.cu``) and their plain-torch twins.

Every wrapper takes its plain twin only for a tensor that lies on the CPU;
on a CUDA tensor it launches the kernel or raises. Each wrapper carries a
``launches`` counter that only the kernel branch bumps.
"""
from __future__ import annotations


def kernel_wrappers():
    """The four kernel wrappers of the serve path, by name."""
    from .radix_sort import digit_partition_hist, digit_rank_gather
    from .reindex_epilogue import rank_search, rename
    return {"digit_partition_hist": digit_partition_hist,
            "digit_rank_gather": digit_rank_gather,
            "rank_search": rank_search, "rename": rename}


def launch_counts() -> dict[str, int]:
    return {k: fn.launches for k, fn in kernel_wrappers().items()}


def reset_launch_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0
