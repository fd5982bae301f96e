"""One-token decode attention over a KV cache (no Pallas counterpart: the
reference computes ``decode_attention`` in jnp,
``repro/models/attention.py``).

``decode_attention`` launches the kernels of ``csrc/decode_attention.cu``
on CUDA tensors and runs the plain twin,
``models.attention.decode_attention_plain`` (the reference's function),
on CPU tensors. The kernel is flash-decoding: the cache is cut into fixed
splits of ``split_size(S)`` positions, one CTA a (split, slot, kv head,
pair of query heads) streams the split's live k rows, then its v rows,
through a ring in shared memory (``load_width`` bytes a copy) and computes
the split's float32 partial softmax; a second launch combines the live
splits in split order by the log-sum-exp rule
(``models.attention.decode_attention_split`` is the same arithmetic in
torch). An int8 cache is read through bf16, as the reference reads it. A
slot's output depends on its own cache rows and length only. The two
agree within float32 rounding (``twin_tolerance``), not bit for bit.

``decode_attention_partial`` is the kernel's partial mode, for a rank's
sequence slice of a cache cut over ranks: the same two launches, the
combine writing the slice's float32 (m, l, acc) — the largest score, the
sum of the exponentials and the unnormalised p · v — in place of the
output; a slot whose slice holds no live position (length 0) gives
(-inf, 0, 0). Its twin is ``models.attention.decode_attention_partial``
with such slots set so.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.models import attention
from repro_torch.models.attention import (_group_q, decode_attention_plain,
                                          decode_mask, dequantize_kv)

from . import _build, kernel_scope

SPLIT = 256  # the least split: cache positions a CTA
CHUNK = 64  # cache rows a ring stage (csrc/decode_attention.cu kChunk)
MAX_SPLIT = 2048  # csrc/decode_attention.cu kMaxSplit
TARGET_SPLITS = 32  # splits a (slot, head) from 8,192 positions to 65,536
MAX_GROUP, MAX_DH = 8, 256  # query heads a kv head, head width
Q_DTYPES = (torch.float32, torch.bfloat16)
# cache positions a step of twin_tolerance's float64 spread sum takes (its
# [B, Hkv, G, 1, TOL_CHUNK, dh] temporary is 268 MB at 8 slots, dh 256)
TOL_CHUNK = 1024

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "decode_attention": (ctypes.c_int,
                         (_P, _I, _P, _P, _I, _P, _P, _P) + (_I,) * 7
                         + (_I, _F, _F, _I, _I) + (_P,) * 5),
    "decode_attention_partial": (ctypes.c_int,
                                 (_P, _I, _P, _P, _I, _P, _P, _P) + (_I,) * 6
                                 + (_F, _F, _I, _I) + (_P,) * 7),
}


def split_size(s: int) -> int:
    """Cache positions a split for a cache of ``s`` positions: SPLIT up to
    8,192 positions, then about TARGET_SPLITS splits (so that the
    combine's partials stay a few % of the rows read), at most MAX_SPLIT;
    a multiple of CHUNK. Never below SPLIT, so that ``twin_tolerance``'s
    split term is never above ceil(s / SPLIT)."""
    per = -(-s // (TARGET_SPLITS * CHUNK)) * CHUNK
    return min(MAX_SPLIT, max(SPLIT, per))


def n_splits(s: int) -> int:
    return -(-s // split_size(s))


def load_width(k: torch.Tensor, v: torch.Tensor) -> int:
    """The bytes a copy of the kernel moves from the cache: 16 where a
    row's bytes and both caches' addresses allow it, else 4 or 1."""
    row = k.shape[-1] * k.element_size()
    return next(w for w in (16, 4, 1)
                if row % w == 0 and k.data_ptr() % w == 0
                and v.data_ptr() % w == 0)


def _check_kernel_inputs(q, k, v, cache_len, k_scale, v_scale) -> None:
    """Raise on what the kernel cannot take."""
    if q.ndim != 4 or q.shape[2] != 1 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError("decode attention takes q [B, H, 1, dh] and k, v "
                         "[B, Hkv, S, dh]")
    b, h, _, dh = q.shape
    hkv = k.shape[1]
    if k.shape[0] != b or k.shape[3] != dh or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "share batch and head width, or H % Hkv != 0")
    if h // hkv > MAX_GROUP or dh > MAX_DH or b * hkv > 65535:
        raise ValueError(f"the decode kernel takes H / Hkv <= {MAX_GROUP}, "
                         f"dh <= {MAX_DH}, B * Hkv <= 65535, not "
                         f"{h // hkv}, {dh}, {b * hkv}")
    if q.dtype not in Q_DTYPES:
        raise ValueError(f"the decode kernel takes q in {Q_DTYPES}, not "
                         f"{q.dtype}")
    int8 = k_scale is not None
    if int8 != (v_scale is not None) or k.dtype != v.dtype or k.dtype != (
            torch.int8 if int8 else torch.bfloat16):
        raise ValueError("the decode kernel takes a bf16 cache, or an int8 "
                         "cache with both scales")
    more = ()
    if int8:
        if (k_scale.shape != k.shape[:3] + (1,) or k_scale.shape
                != v_scale.shape or k_scale.dtype != torch.float32
                or v_scale.dtype != torch.float32):
            raise ValueError("int8 scales are float32 [B, Hkv, S, 1]")
        more = (k_scale, v_scale)
    if cache_len.dtype != torch.int32 or tuple(cache_len.shape) != (b,):
        raise ValueError("cache_len is int32 [B]")
    for t in (q, k, v, cache_len) + more:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("the decode kernel takes contiguous tensors on "
                             "one CUDA device")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     window: int | None = None,
                     logit_cap: float | None = None,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """[B, H, 1, dh] in q's dtype: the decode attention of q [B, H, 1, dh]
    over k, v [B, Hkv, S, dh] (bf16, or int8 with float32 scales
    [B, Hkv, S, 1]), the positions below ``cache_len`` [B] int32 (at least
    1; with ``window``, not below cache_len - window). On the card two
    launches: the splits and their combine. A cache view that is not
    16-byte aligned, or rows of dh bytes not a multiple of 16, take
    narrower copies (``load_width``)."""
    with kernel_scope("decode_attention", decode_attention, 2) as scope:
        if q.device.type == "cpu":
            return decode_attention_plain(q, k_cache, v_cache, cache_len,
                                          window=window, logit_cap=logit_cap,
                                          k_scale=k_scale, v_scale=v_scale)
        if q.device.type != "cuda":
            raise ValueError(f"decode attention runs on cuda or cpu, not "
                             f"{q.device}")
        _check_kernel_inputs(q, k_cache, v_cache, cache_len, k_scale, v_scale)
        b, h, _, dh = q.shape
        hkv, s = k_cache.shape[1], k_cache.shape[2]
        ns = n_splits(s)
        out = torch.empty_like(q)
        f32 = dict(dtype=torch.float32, device=q.device)
        m = torch.empty((b * h * ns,), **f32)
        l = torch.empty((b * h * ns,), **f32)
        acc = torch.empty((b * h * ns * dh,), **f32)
        int8 = k_scale is not None
        scope.launched()
        _build.check(_build.load("decode_attention", _SIGNATURES)
                     .decode_attention(
            q.data_ptr(), int(q.dtype == torch.bfloat16), k_cache.data_ptr(),
            v_cache.data_ptr(), int(int8),
            k_scale.data_ptr() if int8 else None,
            v_scale.data_ptr() if int8 else None, cache_len.data_ptr(), b, h,
            hkv, s, dh, int(window is not None), int(window or 0),
            int(logit_cap is not None), float(logit_cap or 0.0), dh ** -0.5,
            split_size(s), load_width(k_cache, v_cache), m.data_ptr(),
            l.data_ptr(), acc.data_ptr(), out.data_ptr(),
            _build.stream_of(q)), "decode_attention")
        return out


decode_attention.launches = 0


def decode_partial_plain(q, k_cache, v_cache, cache_len, *, logit_cap=None,
                         k_scale=None, v_scale=None):
    """The partial mode's twin: ``models.attention.decode_attention_partial``
    over the positions below ``cache_len`` (int8 read through bf16), a
    slot with none of them set to (-inf, 0, 0)."""
    if k_scale is not None:
        k_cache = dequantize_kv(k_cache, k_scale)
        v_cache = dequantize_kv(v_cache, v_scale)
    m, l, acc = attention.decode_attention_partial(
        q, k_cache, v_cache, decode_mask(cache_len, k_cache.shape[2]),
        logit_cap=logit_cap)
    dead = (cache_len <= 0)[:, None, None, None]
    return (m.masked_fill(dead, -math.inf), l.masked_fill(dead, 0.0),
            acc.masked_fill(dead[..., None], 0.0))


def decode_attention_partial(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, cache_len: torch.Tensor,
                             *, logit_cap: float | None = None,
                             k_scale: torch.Tensor | None = None,
                             v_scale: torch.Tensor | None = None):
    """The partial softmax of q [B, H, 1, dh] over the positions below
    ``cache_len`` [B] int32 (0 allowed) of a cache slice k, v [B, Hkv, S,
    dh]: float32 (m [B, Hkv, G, 1], l [B, Hkv, G, 1], acc [B, Hkv, G, 1,
    dh]), the shapes of ``models.attention.decode_attention_partial``. On
    the card two launches (the splits, the combine in partial mode)."""
    with kernel_scope("decode_attention_partial", decode_attention_partial,
                      2) as scope:
        if q.device.type == "cpu":
            return decode_partial_plain(q, k_cache, v_cache, cache_len,
                                        logit_cap=logit_cap, k_scale=k_scale,
                                        v_scale=v_scale)
        if q.device.type != "cuda":
            raise ValueError(f"decode attention runs on cuda or cpu, not "
                             f"{q.device}")
        _check_kernel_inputs(q, k_cache, v_cache, cache_len, k_scale, v_scale)
        b, h, _, dh = q.shape
        hkv, s = k_cache.shape[1], k_cache.shape[2]
        g = h // hkv
        ns = n_splits(s)
        f32 = dict(dtype=torch.float32, device=q.device)
        m_part = torch.empty((b * h * ns,), **f32)
        l_part = torch.empty((b * h * ns,), **f32)
        acc_part = torch.empty((b * h * ns * dh,), **f32)
        m = torch.empty((b, hkv, g, 1), **f32)
        l = torch.empty((b, hkv, g, 1), **f32)
        acc = torch.empty((b, hkv, g, 1, dh), **f32)
        int8 = k_scale is not None
        scope.launched()
        _build.check(_build.load("decode_attention", _SIGNATURES)
                     .decode_attention_partial(
            q.data_ptr(), int(q.dtype == torch.bfloat16), k_cache.data_ptr(),
            v_cache.data_ptr(), int(int8),
            k_scale.data_ptr() if int8 else None,
            v_scale.data_ptr() if int8 else None, cache_len.data_ptr(), b, h,
            hkv, s, dh, int(logit_cap is not None), float(logit_cap or 0.0),
            dh ** -0.5, split_size(s), load_width(k_cache, v_cache),
            m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
            m.data_ptr(), l.data_ptr(), acc.data_ptr(), _build.stream_of(q)),
            "decode_attention_partial")
        return m, l, acc


decode_attention_partial.launches = 0


def _softcap64(x, cap):
    return x if cap is None else cap * torch.tanh(x / cap)


def twin_tolerance(q, k_cache, v_cache, cache_len, *, window=None,
                   logit_cap=None, k_scale=None,
                   v_scale=None) -> torch.Tensor:
    """[B, H, 1, dh] float64 bound on |kernel − twin| for
    ``decode_attention`` on these inputs, derived from float32 rounding,
    not measured (u = 2^-24).

    Each side sums a score of dh products: at most dh·u·A off, A =
    Σ_d |q_d k_d| (q scaled); the softcap's division, tanh and product add
    a few ulps: E = max over live positions of dh·u·A + 4u·|score|, so
    the sides' scores differ by at most 2E. A score error ε_s moves the
    output by Σ_s p_s ε_s (v_s − o) / l to first order (the maximum
    cancels), and each side's exponentials and split corrections add 8u:
    (2E + 8u)·Σ_s p_s |v_s − o| / l. The sums of p·v and p over the live
    positions and the splits round: 2(n + n_splits + 4)·u·(Σ_s p_s |v_s| /
    l + |o|), n the live positions. Twice the sum allows the second-order
    terms. With a bf16 q the output rounds once on each side: one bf16 ulp
    more, 2^-7 of |o|. p, o and the sums are taken in float64 from the
    twin's own inputs, TOL_CHUNK positions at a time."""
    u = 2.0 ** -24
    b, h, _, dh = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    if k_scale is not None:
        k_cache = dequantize_kv(k_cache, k_scale)
        v_cache = dequantize_kv(v_cache, v_scale)
    qg = (_group_q(q, hkv).to(torch.float32) * dh ** -0.5).to(torch.float64)
    mask = decode_mask(cache_len, s, window)[:, None, None, None, :]
    kf, vf = k_cache.to(torch.float64), v_cache.to(torch.float64)
    sc = _softcap64(torch.einsum("bkgqd,bkcd->bkgqc", qg, kf), logit_cap)
    err = dh * u * torch.einsum("bkgqd,bkcd->bkgqc", qg.abs(), kf.abs()) + (
        4 * u * sc.abs())
    e_max = torch.where(mask, err, 0.0).amax(dim=-1)  # [B, Hkv, G, 1]
    sc = torch.where(mask, sc, -math.inf)
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1)[..., None]
    o = torch.einsum("bkgqc,bkcd->bkgqd", p, vf) / l
    spread = torch.zeros_like(o)
    for i in range(0, s, TOL_CHUNK):
        dv = (vf[:, :, None, None, i:i + TOL_CHUNK] - o[..., None, :]).abs()
        spread += torch.einsum("bkgqc,bkgqcd->bkgqd",
                               p[..., i:i + TOL_CHUNK], dv)
    weight = torch.einsum("bkgqc,bkcd->bkgqd", p, vf.abs()) / l
    n = mask.sum(dim=-1).to(torch.float64)
    tol = 2 * ((2 * e_max[..., None] + 8 * u) * spread / l
               + 2 * (n[..., None] + n_splits(s) + 4) * u
               * (weight + o.abs()))
    if q.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * (o.abs() + tol)
    return tol.reshape(b, h, 1, dh)
