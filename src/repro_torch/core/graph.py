"""Graph containers and padding conventions (port of ``repro/core/graph.py``).

Padded, power-of-two int32 buffers with an explicit validity count. The
sentinel VID ``SENTINEL`` sorts after every real VID, so padded tails stay
at the end of every Ordering / Reshaping stage without special-casing.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Largest int32; sorts after every valid VID.
SENTINEL = 0x7FFFFFFF


def next_pow2(n: int) -> int:
    n = int(n)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device with no card raises
    (entry points never fall back to the CPU quietly)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain-torch path on the host")
    return dev


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(x, idx, axis=0, mode="clip")``: rows of ``x`` at ``idx``
    clipped into range, shaped ``idx.shape + x.shape[1:]``."""
    flat = idx.reshape(-1).clamp(0, x.shape[0] - 1)
    return x.index_select(0, flat).reshape(idx.shape + x.shape[1:])


def pad_to(x: torch.Tensor, size: int, fill) -> torch.Tensor:
    """Pad 1-D tensor to ``size`` with ``fill`` (no-op if already there)."""
    n = x.shape[0]
    if n == size:
        return x
    if n > size:
        raise ValueError(f"cannot pad {n} down to {size}")
    return torch.cat([x, torch.full((size - n,), fill, dtype=x.dtype,
                                    device=x.device)])


@dataclasses.dataclass
class COO:
    """Edge array: (dst, src) pairs, padded to static length with SENTINEL.

    ``n_edges`` is the number of valid entries (a 0-d int32 tensor);
    before Ordering the valid edges may sit anywhere (the sort compacts
    them).
    """

    dst: torch.Tensor  # int32 [E_pad]
    src: torch.Tensor  # int32 [E_pad]
    n_edges: torch.Tensor  # int32 scalar
    n_nodes: int

    @property
    def capacity(self) -> int:
        return self.dst.shape[0]

    @property
    def device(self) -> torch.device:
        return self.dst.device

    def to(self, device) -> "COO":
        return COO(self.dst.to(device), self.src.to(device),
                   self.n_edges.to(device), self.n_nodes)

    @staticmethod
    def from_arrays(dst, src, n_nodes: int, capacity: int | None = None,
                    device="cuda") -> "COO":
        dev = resolve_device(device)
        dst = torch.as_tensor(np.asarray(dst), dtype=torch.int32).to(dev)
        src = torch.as_tensor(np.asarray(src), dtype=torch.int32).to(dev)
        e = dst.shape[0]
        cap = capacity or next_pow2(e)
        return COO(dst=pad_to(dst, cap, SENTINEL), src=pad_to(src, cap, SENTINEL),
                   n_edges=torch.tensor(e, dtype=torch.int32, device=dev),
                   n_nodes=n_nodes)


@dataclasses.dataclass
class CSC:
    """Compressed sparse column: pointers indexed by dst VID, indices = src
    VIDs. ``ptr`` has length n_nodes+1; ``idx`` is the src column of the
    dst-sorted COO (SENTINEL-padded)."""

    ptr: torch.Tensor  # int32 [n_nodes + 1]
    idx: torch.Tensor  # int32 [E_pad]
    n_edges: torch.Tensor  # int32 scalar
    n_nodes: int

    def to(self, device) -> "CSC":
        return CSC(self.ptr.to(device), self.idx.to(device),
                   self.n_edges.to(device), self.n_nodes)


@dataclasses.dataclass
class Subgraph:
    """Sampled subgraph in CSC form with the reindex map back to original
    VIDs: ``order`` lists the original VID of each new VID (SENTINEL
    padded), ``n_sub_nodes`` counts valid entries."""

    csc: CSC
    order: torch.Tensor  # int32 [N_sub_pad]
    n_sub_nodes: torch.Tensor  # int32 scalar


def synthetic_coo(n_nodes: int, n_edges: int, capacity: int, seed: int,
                  device="cuda", power_law: float = 1.5,
                  chunk: int = 1 << 24) -> COO:
    """A ``random_coo``-shaped graph made on ``device`` from a seeded
    ``torch.Generator``: power-law dst (probability ∝ rank^-alpha over a
    shuffled node order, drawn by inverse CDF in chunks of ``chunk``
    edges) and uniform src. Not the same numbers as ``random_coo``."""
    from .set_count import rank_in_sorted
    dev = resolve_device(device)
    if n_edges > capacity:
        raise ValueError(f"{n_edges} edges exceed capacity {capacity}")
    g = torch.Generator(device=dev).manual_seed(seed)
    ranks = torch.arange(1, n_nodes + 1, dtype=torch.float64, device=dev)
    cdf = torch.cumsum(ranks ** (-power_law), 0)
    cdf /= cdf[-1].clone()
    perm = torch.randperm(n_nodes, generator=g, device=dev).to(torch.int32)
    dst = torch.full((capacity,), SENTINEL, dtype=torch.int32, device=dev)
    for lo in range(0, n_edges, chunk):
        n = min(chunk, n_edges - lo)
        u = torch.rand(n, generator=g, dtype=torch.float64, device=dev)
        idx = rank_in_sorted(cdf, u, side="right", unroll=True)
        dst[lo:lo + n] = take(perm, torch.clamp(idx, max=n_nodes - 1))
    src = torch.full_like(dst, SENTINEL)
    src[:n_edges] = torch.randint(0, n_nodes, (n_edges,), generator=g,
                                  dtype=torch.int32, device=dev)
    return COO(dst=dst, src=src,
               n_edges=torch.tensor(n_edges, dtype=torch.int32, device=dev),
               n_nodes=n_nodes)


def random_coo(rng: np.random.Generator, n_nodes: int, n_edges: int,
               power_law: float | None = 1.5) -> tuple[np.ndarray, np.ndarray]:
    """Random COO with optional power-law dst-degree skew (numpy, host)."""
    if power_law:
        # Zipf-ish: dst probability ∝ rank^-alpha over a shuffled node order.
        ranks = np.arange(1, n_nodes + 1, dtype=np.float64)
        p = ranks ** (-power_law)
        p /= p.sum()
        perm = rng.permutation(n_nodes)
        dst = perm[rng.choice(n_nodes, size=n_edges, p=p)]
    else:
        dst = rng.integers(0, n_nodes, size=n_edges)
    src = rng.integers(0, n_nodes, size=n_edges)
    return dst.astype(np.int32), src.astype(np.int32)
