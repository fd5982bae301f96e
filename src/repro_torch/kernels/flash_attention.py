"""Flash attention forward and backward (port of ``flash_attention_fwd``,
``flash_attention_bwd`` and the GQA wrapper ``flash_attention_bhsd`` in
``repro/kernels/flash_attention.py``, and of the custom VJP of
``repro/models/attention.py``).

``flash_attention_bhsd`` launches the forward kernel of
``csrc/flash_attention.cu`` on CUDA tensors and runs its plain twin,
``models.attention.flash_attention_plain`` (the reference's blocked
scan), on CPU tensors. When q, k or v requires a gradient it goes through
``FlashAttention``, a ``torch.autograd.Function`` whose forward also
keeps the log-sum-exp and, as the reference's custom VJP does, the
float32 output before its cast to q's dtype, and whose backward is
``flash_attention_bwd``: the
two kernels of ``csrc/flash_attention_bwd.cu`` on the card, the twin
``models.attention.flash_attention_bwd_plain`` (the reference's
``_bwd_impl``) on the CPU. The layout is the reference wrapper's: q
[B, H, Sq, dh], k and v [B, Hkv, Skv, dh]. The kernels read kv head
h // (H / Hkv) for query head h in place, where the reference repeats k
and v.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.models.attention import (flash_attention_bwd_plain,
                                          flash_attention_plain)

from . import _build, kernel_scope

HEAD_DIMS = (16, 32, 64, 128, 256)  # the head widths the kernels are built for
DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_OPTS = (_I,) * 11 + (_F, _F, _I, _P)  # B .. q_offset, stream
_SIGNATURES = {
    "flash_attention_fwd": (ctypes.c_int, (_P,) * 6 + _OPTS),
}
_BWD_SIGNATURES = {
    "flash_attention_bwd_dq": (ctypes.c_int, (_P,) * 7 + _OPTS),
    "flash_attention_bwd_dkv": (ctypes.c_int, (_P,) * 8 + _OPTS),
}


def _check_shapes(q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError("flash attention takes q [B, H, Sq, dh] and "
                         "k, v [B, Hkv, Skv, dh]")
    if k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] or (
            q.shape[1] % k.shape[1]):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "share batch and head width, or H % Hkv != 0")


def _check_kernel_inputs(q, k, v, *more) -> None:
    """Raise on what the CUDA kernels cannot take."""
    b, h, sq, dh = q.shape
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("the flash kernels take bf16 or float32 q, k, v of "
                         f"one dtype, not {q.dtype}, {k.dtype}, {v.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"the flash kernels take dh in {HEAD_DIMS}, not {dh}")
    if b * h > 65535:  # one grid row per (batch, head)
        raise ValueError(f"the flash kernels take B * H <= 65535, not "
                         f"{b * h}")
    for t in (q, k, v) + more:
        if (t.device != q.device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError("the flash kernels take contiguous, 16-byte "
                             "aligned tensors on one CUDA device")


def _mask_args(q, causal, window, logit_cap, q_offset):
    """The C entry points' trailing arguments after the shape."""
    return (int(q.dtype == torch.bfloat16), int(causal),
            int(window is not None), 0 if window is None else int(window),
            int(logit_cap is not None),
            0.0 if logit_cap is None else float(logit_cap),
            q.shape[3] ** -0.5, int(q_offset), _build.stream_of(q))


def _fwd_kernel(q, k, v, *, lse: bool, causal, window, logit_cap, q_offset):
    """Launch the forward kernel: (out in q's dtype, the float32
    log-sum-exp [B, H, Sq], the float32 output [B, H, Sq, dh] that out
    rounds), the last two only with ``lse`` (None without). In float32
    the float32 output is out itself; in bf16 the kernel writes it beside
    out. The caller's kernel scope counts the launch."""
    b, h, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse_t = out_f32 = None
    if lse:
        lse_t = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        out_f32 = (out if q.dtype == torch.float32 else
                   torch.empty(q.shape, dtype=torch.float32, device=q.device))
    if out.numel():
        _build.check(_build.load("flash_attention", _SIGNATURES)
                     .flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse_t is None else lse_t.data_ptr(),
            None if out_f32 is None or out_f32 is out
            else out_f32.data_ptr(), b, h, hkv, sq, skv,
            dh, *_mask_args(q, causal, window, logit_cap, q_offset)),
            "flash_attention_fwd")
    return out, lse_t, out_f32


def flash_dq(q, k, v, dout, lse, delta, dq, **mask) -> None:
    """Launch ``flash_dq_kernel`` into ``dq`` (inputs checked by
    ``flash_attention_bwd``)."""
    with kernel_scope("flash_attention_bwd_dq", flash_dq) as scope:
        b, h, sq, dh = q.shape
        scope.launched()
        _build.check(_build.load("flash_attention_bwd", _BWD_SIGNATURES)
                     .flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, k.shape[1],
            sq, k.shape[2], dh, *_mask_args(q, **mask)), "flash_dq_kernel")


def flash_dkv(q, k, v, dout, lse, delta, dk, dv, **mask) -> None:
    """Launch ``flash_dkv_kernel`` into ``dk``, ``dv`` (inputs checked by
    ``flash_attention_bwd``)."""
    with kernel_scope("flash_attention_bwd_dkv", flash_dkv) as scope:
        b, h, sq, dh = q.shape
        scope.launched()
        _build.check(_build.load("flash_attention_bwd", _BWD_SIGNATURES)
                     .flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b,
            h, k.shape[1], sq, k.shape[2], dh, *_mask_args(q, **mask)),
            "flash_dkv_kernel")


flash_dq.launches = 0
flash_dkv.launches = 0


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: int | None = None,
                        logit_cap: float | None = None, q_offset: int = 0,
                        kv_block: int = 512):
    """(dq, dk, dv) of the flash forward, from its float32 output ``out``
    [B, H, Sq, dh] (before any cast to q's dtype, as the reference's VJP
    keeps it) and float32 log-sum-exp ``lse`` [B, H, Sq] and the output
    gradient ``dout`` [B, H, Sq, dh]; dk and dv sum each kv head's group
    of query heads. On the card the two kernels, after one plain
    reduction for delta = sum(dout * out) per row; the kernels take what
    the forward takes, and lse float32. On the CPU the twin, in blocks of
    ``kv_block``."""
    _check_shapes(q, k, v)
    if out.shape != q.shape or dout.shape != q.shape or (
            lse.shape != q.shape[:3]):
        raise ValueError("out and dout take q's shape and lse [B, H, Sq]")
    if out.dtype != torch.float32:
        raise ValueError("the flash backward takes the forward's float32 "
                         f"out (delta = sum(dout * out)), not {out.dtype}")
    mask = dict(causal=causal, window=window, logit_cap=logit_cap,
                q_offset=q_offset)
    if not q.is_cuda:  # one twin for both kernels
        with kernel_scope("flash_attention_bwd_dq", flash_dq,
                          q.numel() > 0), \
                kernel_scope("flash_attention_bwd_dkv", flash_dkv,
                             q.numel() > 0 and k.numel() > 0):
            return flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                             kv_block=kv_block, **mask)
    _check_kernel_inputs(q, k, v, out, dout, lse)
    if dout.dtype != q.dtype or lse.dtype != torch.float32:
        raise ValueError("the flash backward kernels take dout in q's dtype "
                         "and lse in float32")
    delta = torch.sum(dout.to(torch.float32) * out, dim=-1)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel():
        flash_dq(q, k, v, dout, lse, delta, dq, **mask)
    if q.numel() and k.numel():
        flash_dkv(q, k, v, dout, lse, delta, dk, dv, **mask)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with the reference's custom VJP: the forward keeps
    (q, k, v, out, lse) with out the float32 output, as the reference's
    ``fwd`` does, and returns its cast to q's dtype; the backward takes
    delta from that float32 out and recomputes the probabilities from
    lse. The kernels on the card, the twins on the CPU (O(block) memory,
    no autograd record of the scan)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, logit_cap, q_offset, kv_block):
        mask = dict(causal=causal, window=window, logit_cap=logit_cap,
                    q_offset=q_offset)
        with kernel_scope("flash_attention_fwd", flash_attention_bhsd,
                          q.numel() > 0) as scope:
            if q.is_cuda:
                _check_kernel_inputs(q, k, v)
                scope.launched()
                out, lse, out_f32 = _fwd_kernel(q, k, v, lse=True, **mask)
            else:
                out_f32, lse = flash_attention_plain(
                    q, k, v, kv_block=kv_block, return_lse=True,
                    out_dtype=torch.float32, **mask)
                out = out_f32.to(q.dtype)
        ctx.save_for_backward(q, k, v, out_f32, lse)
        ctx.mask, ctx.kv_block = mask, kv_block
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(),
                                         kv_block=ctx.kv_block, **ctx.mask)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         logit_cap: float | None = None, q_offset: int = 0,
                         kv_block: int = 512) -> torch.Tensor:
    """Causal / windowed / softcapped online-softmax attention with GQA.

    q [B, H, Sq, dh]; k, v [B, Hkv, Skv, dh]; H % Hkv == 0; query row i
    sits at position ``q_offset + i``. On the card: bf16 or float32, dh in
    ``HEAD_DIMS``, any Sq and Skv, B * H <= 65535, contiguous, 16-byte
    aligned. ``kv_block`` is the CPU twins' block (the
    kernels tile by themselves); the block size changes only the order of
    float sums. Differentiable through ``FlashAttention`` when q, k or v
    requires a gradient; otherwise the forward alone, with no lse.
    """
    _check_shapes(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, logit_cap,
                                    q_offset, kv_block)
    mask = dict(causal=causal, window=window, logit_cap=logit_cap,
                q_offset=q_offset)
    with kernel_scope("flash_attention_fwd", flash_attention_bhsd,
                      q.numel() > 0) as scope:
        if not q.is_cuda:
            return flash_attention_plain(q, k, v, kv_block=kv_block, **mask)
        _check_kernel_inputs(q, k, v)
        scope.launched()
        return _fwd_kernel(q, k, v, lse=False, **mask)[0]


flash_attention_bhsd.launches = 0
