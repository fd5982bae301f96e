"""The benchmark's inputs, made on the device from a seed.

* ``power_law_coo``: a COO of ``n_edges`` edges padded with SENTINEL to
  ``capacity`` slots. Each edge's dst is drawn with probability
  proportional to rank^-alpha over a seeded order of the nodes (inverse
  CDF, in chunks), its src uniformly. Node r then expects
  n_edges * r^-alpha / H(alpha) in-edges, H the generalised harmonic
  number over the node count.
* ``features``: N(0, 1) float32 rows.
* ``weights``: every parameter of a model from one normal draw: matrices
  N(0, 1/d_in), biases 0.1 N(0, 1), LayerNorm scales 1 + 0.1 N(0, 1).

Each input has its own generator stream: ``stream_seed(seed, tag)``.
"""
from __future__ import annotations

import math

import torch

SENTINEL = 0x7FFFFFFF
TAGS = {"graph": 1, "features": 2, "weights": 3, "traffic": 4}


def stream_seed(seed: int, tag: str, index: int = 0) -> int:
    """A 63-bit seed of its own for each (run seed, input, index)."""
    return ((int(seed) * 1_000_003 + TAGS[tag]) * 1_009 + index) % (2 ** 63)


def generator(seed: int, tag: str, device, index: int = 0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, tag, index))


def expected_in_degree(n_nodes: int, n_edges: int, alpha: float,
                       rank: int) -> float:
    """The expected in-degree of the node of rank ``rank`` (1-based)."""
    h = sum(r ** -alpha for r in range(1, n_nodes + 1))
    return n_edges * rank ** -alpha / h


def power_law_coo(n_nodes: int, n_edges: int, capacity: int, alpha: float,
                  gen: torch.Generator, device, chunk: int = 1 << 24
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dst, src) int32 [capacity], SENTINEL past ``n_edges``."""
    if n_edges > capacity:
        raise ValueError(f"{n_edges} edges exceed capacity {capacity}")
    ranks = torch.arange(1, n_nodes + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(ranks ** (-float(alpha)), 0)
    cdf /= cdf[-1].clone()
    order = torch.randperm(n_nodes, generator=gen, device=device
                           ).to(torch.int32)
    dst = torch.full((capacity,), SENTINEL, dtype=torch.int32, device=device)
    for lo in range(0, n_edges, chunk):
        n = min(chunk, n_edges - lo)
        u = torch.rand(n, generator=gen, dtype=torch.float64, device=device)
        r = torch.searchsorted(cdf, u, right=True).clamp_(max=n_nodes - 1)
        dst[lo:lo + n] = order[r]
    src = torch.full_like(dst, SENTINEL)
    src[:n_edges] = torch.randint(0, n_nodes, (n_edges,), generator=gen,
                                  dtype=torch.int32, device=device)
    return dst, src


def features(n_nodes: int, d_feat: int, gen: torch.Generator,
             device) -> torch.Tensor:
    return torch.randn((n_nodes, d_feat), generator=gen, device=device)


def weights(specs: list[tuple[str, tuple[int, ...], str]],
            gen: torch.Generator, device) -> dict[str, torch.Tensor]:
    """``specs``: (name, shape, init) with init ``dense`` (N(0, 1/d_in),
    d_in the first dimension), ``bias`` or ``scale``; one draw for all."""
    sizes = [math.prod(shape) for _, shape, _ in specs]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, lo = {}, 0
    for (name, shape, init), n in zip(specs, sizes):
        x = flat[lo:lo + n].reshape(shape)
        lo += n
        if init == "dense":
            x = x / math.sqrt(shape[0])
        elif init == "bias":
            x = 0.1 * x
        elif init == "scale":
            x = 1.0 + 0.1 * x
        else:
            raise ValueError(f"unknown init {init!r} of {name}")
        out[name] = x.contiguous()
    return out
