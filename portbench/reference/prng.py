"""Threefry-2x32 keys and uniform draws (the counter-based generator of
``jax.random`` with partitionable threefry), written out plainly.

A key is a pair of uint32 as Python ints. ``floyd_schedule`` lays out the
sub-keys a Floyd k-hop sampler draws with: for layer l, ``fold_in(key, l)``
split k_l times in a chain, each split's second half one row.
``uniform_rows`` hashes the element counter (0, i) under each row's key and
maps the xor of the two words to [0, 1) through the float32 mantissa.
uint32 arithmetic is emulated in int64 with a mask.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry(k0, k1, x0, x1):
    """20 rounds of Threefry-2x32 on Python ints or int64 tensors."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def root_key(seed: int) -> tuple[int, int]:
    if not 0 <= seed < 2 ** 31:
        raise ValueError(f"key seed {seed} outside [0, 2^31)")
    return (0, int(seed))


def fold_in(key, data: int):
    return threefry(key[0], key[1], 0, int(data) & M32)


def split2(key):
    return (threefry(key[0], key[1], 0, 0), threefry(key[0], key[1], 0, 1))


def floyd_schedule(key, fanouts) -> list[list[tuple[int, int]]]:
    """Per layer, the k_l sub-keys of Floyd's k_l steps."""
    layers = []
    for layer, k in enumerate(fanouts):
        lk = fold_in(key, layer)
        rows = []
        for _ in range(int(k)):
            lk, sub = split2(lk)
            rows.append(sub)
        layers.append(rows)
    return layers


def uniform_rows(keys: list[tuple[int, int]], n: int, device) -> torch.Tensor:
    """[len(keys), n] float32 in [0, 1): row i draws under keys[i] at the
    counters 0 .. n-1."""
    table = torch.tensor(keys, dtype=torch.int64, device=device)
    idx = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    b0, b1 = threefry(table[:, :1], table[:, 1:], torch.zeros_like(idx), idx)
    bits = b0 ^ b1
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp(f - 1.0, min=0.0)
