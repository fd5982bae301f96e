"""Flash attention forward (port of ``flash_attention_fwd`` and its GQA
wrapper ``flash_attention_bhsd`` in ``repro/kernels/flash_attention.py``).

``flash_attention_bhsd`` launches the kernel of ``csrc/flash_attention.cu``
on CUDA tensors and runs its plain twin, ``models.attention
.flash_attention_plain`` (the reference's blocked scan), on CPU tensors.
The layout is the reference wrapper's: q [B, H, Sq, dh], k and v
[B, Hkv, Skv, dh]. The kernel reads kv head h // (H / Hkv) for query head
h in place, where the reference repeats k and v.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.models.attention import flash_attention_plain

from . import _build

TILE = 64  # the kernel's query and kv tile; Sq and Skv must be multiples
HEAD_DIMS = (16, 32, 64, 128, 256)  # the head widths the kernel is built for
DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "flash_attention_fwd": (ctypes.c_int, (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                           _I, _I, _I, _I, _I, _I, _F, _F, _I,
                                           _P)),
}


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         logit_cap: float | None = None, q_offset: int = 0,
                         kv_block: int = 512) -> torch.Tensor:
    """Causal / windowed / softcapped online-softmax attention with GQA.

    q [B, H, Sq, dh]; k, v [B, Hkv, Skv, dh]; H % Hkv == 0; query row i
    sits at position ``q_offset + i``. On the card: bf16 or float32, dh in
    ``HEAD_DIMS``, Sq and Skv multiples of ``TILE``, B * H <= 65535,
    contiguous, 16-byte aligned. ``kv_block`` is the CPU twin's block (the kernel tiles by
    ``TILE``); the block size changes only the order of float sums.
    """
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError("flash_attention_bhsd takes q [B, H, Sq, dh] and "
                         "k, v [B, Hkv, Skv, dh]")
    b, h, sq, dh = q.shape
    _, hkv, skv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != dh or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "share batch and head width, or H % Hkv != 0")
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     logit_cap=logit_cap, kv_block=kv_block,
                                     q_offset=q_offset)
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("the flash kernel takes bf16 or float32 q, k, v of "
                         f"one dtype, not {q.dtype}, {k.dtype}, {v.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"the flash kernel takes dh in {HEAD_DIMS}, not {dh}")
    if sq % TILE or skv % TILE:
        raise ValueError(f"the flash kernel takes Sq and Skv that are "
                         f"multiples of {TILE}, not {sq} and {skv}")
    if b * h > 65535:  # one grid row per (batch, head)
        raise ValueError(f"the flash kernel takes B * H <= 65535, not {b * h}")
    for t in (q, k, v):
        if (t.device != q.device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError("the flash kernel takes contiguous, 16-byte "
                             "aligned q, k, v on one CUDA device")
    out = torch.empty_like(q)
    if out.numel():
        flash_attention_bhsd.launches += 1
        _build.check(_build.load("flash_attention", _SIGNATURES)
                     .flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            hkv, sq, skv, dh, int(q.dtype == torch.bfloat16), int(causal),
            int(window is not None), 0 if window is None else int(window),
            int(logit_cap is not None),
            0.0 if logit_cap is None else float(logit_cap), dh ** -0.5,
            int(q_offset), _build.stream_of(q)), "flash_attention_fwd")
    return out


flash_attention_bhsd.launches = 0
