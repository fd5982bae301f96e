"""Counter-based threefry-2x32 keys and draws, bit-equal to ``jax.random``.

The reference samples with ``jax.random`` under
``jax_threefry_partitionable=True``; a sampled subgraph can only match it
if every draw matches. This module re-implements that generator:

* a key is a pair of uint32 held as a tuple of Python ints ``(k0, k1)``;
  key derivation (``PRNGKey``, ``fold_in``, ``split``) is scalar integer
  math on the host, exactly like JAX's ``threefry_seed`` / ``fold_in`` /
  ``_threefry_split_foldlike``;
* ``key_schedule`` lays out every sub-key a request's sampler draws with
  (Floyd, keysort or reservoir selection) as one [K, 2] int64 table, so
  a captured serve step reads its keys from a device tensor that
  admission overwrites, with no host-to-device copy of its own;
* ``uniform`` hashes the flat element index (high word 0, low word the
  index) on the tensor's device and maps the xor of the two output words
  to [0, 1) through the mantissa trick of ``jax.random.uniform``.

uint32 arithmetic is emulated in int64 with ``& 0xFFFFFFFF``; the same
``threefry2x32`` serves Python ints and int64 tensors.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = tuple  # (k0, k1), each a uint32 as a Python int


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block (20 rounds) on two counter words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def PRNGKey(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2^31)."""
    seed = int(seed)
    if not 0 <= seed < 2**31:
        raise ValueError(f"seed {seed} outside [0, 2^31)")
    return (0, seed)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``: hash the counter pair (0, data)."""
    return threefry2x32(key[0], key[1], 0, int(data) & M32)


def split(key: Key, num: int = 2) -> list[Key]:
    """``jax.random.split(key, num)``: key i hashes the counter pair (0, i)."""
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def schedule_rows(selection: str, fanouts, window: int) -> list[int]:
    """Sub-key rows each layer's selector draws with: Floyd one a step
    (k_l), keysort one (the layer key itself), reservoir one a step past
    the first k_l (``window - k_l``, none when the window is not wider)."""
    if selection == "floyd":
        return [int(k) for k in fanouts]
    if selection == "keysort":
        return [1] * len(fanouts)
    if selection == "reservoir":
        return [max(0, int(window) - int(k)) for k in fanouts]
    raise ValueError(f"unknown selection {selection!r}")


def key_schedule(key: Key, fanouts, selection: str = "floyd",
                 window: int = 1024) -> torch.Tensor:
    """The sub-keys a request's selection draws with, as one [K, 2] int64
    CPU table, layer by layer (``schedule_rows`` gives each layer's K_l;
    ``core/sampling.py``): keysort's row is ``fold_in(key, l)``; Floyd's
    and reservoir's rows are the second halves of successive ``split``s
    of ``fold_in(key, l)``."""
    rows = []
    for layer, n in enumerate(schedule_rows(selection, fanouts, window)):
        lk = fold_in(key, layer)
        if selection == "keysort":
            rows.append(lk)
            continue
        for _ in range(n):
            lk, sub = split(lk)
            rows.append(sub)
    return torch.tensor(rows, dtype=torch.int64).reshape(len(rows), 2)


def random_bits(keys, n: int, device) -> torch.Tensor:
    """32 random bits per element as int64 in [0, 2^32): one row of ``n``
    per key, [len(keys), n]. ``keys`` is a list of keys or a [K, 2] int64
    table; a table is read where it lies (``device`` is then ignored)."""
    if isinstance(keys, torch.Tensor):
        table, device = keys, keys.device
    else:
        table = torch.tensor([list(k) for k in keys], dtype=torch.int64,
                             device=device).reshape(len(keys), 2)
    idx = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    b0, b1 = threefry2x32(table[:, :1], table[:, 1:], torch.zeros_like(idx),
                          idx)
    return b0 ^ b1


def _bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp(f - 1.0, min=0.0)


def uniform(key: Key, shape, device) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32 in [0, 1))."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    n = 1
    for s in shape:
        n *= s
    return uniform_rows([key], n, device).reshape(shape)


def uniform_rows(keys, n: int, device) -> torch.Tensor:
    """[len(keys), n]: row i equals ``uniform(keys[i], (n,))`` — several
    draws in one batch of hash ops. ``keys`` is a list of keys or a [K, 2]
    int64 table (``key_schedule``) on the device that draws."""
    return _bits_to_unit_float(random_bits(keys, n, device))
