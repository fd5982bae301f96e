"""Attention for the LM prefill path (port of the forward part of
``repro/models/attention.py``): RoPE, the GQA grouping, the block mask and
the blocked online-softmax flash attention.

``flash_attention_plain`` is the reference's ``lax.scan`` over kv blocks
written as a Python loop: the plain twin of the flash kernel. The model
calls ``kernels.flash_attention.flash_attention_bhsd``, which launches the
kernel on a CUDA tensor and runs this twin on a CPU tensor. Decode,
``quantize_kv`` and the custom VJP belong to later slices.
"""
from __future__ import annotations

import torch

from .common import softcap as _softcap

NEG_INF = -1e30


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0
         ) -> torch.Tensor:
    """Split-half rotary embedding. x [..., S, dh], positions [..., S]
    (broadcastable); angles in float32, result cast back to x.dtype."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs  # [..., S, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def _group_q(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[B,H,S,dh] → [B,Hkv,G,S,dh]: query head h reads kv head h // G."""
    b, h, s, dh = q.shape
    return q.reshape(b, n_kv, h // n_kv, s, dh)


def _blk_mask(sq: int, kv_block: int, j: int, q_offset: int, causal: bool,
              window: int | None, device=None) -> torch.Tensor:
    q_pos = q_offset + torch.arange(sq, device=device)
    kv_pos = j * kv_block + torch.arange(kv_block, device=device)
    mask = torch.ones((sq, kv_block), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos[:, None] >= kv_pos[None, :]
    if window is not None:
        mask &= q_pos[:, None] - kv_pos[None, :] < window
    return mask


def _flash_fwd_scan(qg, kb, vb, *, sq, kv_block, q_offset, causal, window,
                    logit_cap):
    """Returns (out, lse). qg [B,Hkv,G,Sq,dh] pre-scaled float32; kb, vb
    [nb, B, Hkv, kv_block, dh]. A row masked in a whole block keeps
    m = -1e30 and takes p = 1 there, until a live key resets it through
    corr = 0, as in the reference."""
    b, hkv, g, _, dh = qg.shape
    dev = qg.device
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, sq, dh), dtype=torch.float32, device=dev)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    for j in range(kb.shape[0]):
        s = torch.einsum("bkgqd,bkcd->bkgqc", qg, kb[j].to(torch.float32))
        s = _softcap(s, logit_cap)
        mask = _blk_mask(sq, kv_block, j, q_offset, causal, window, dev)
        s = torch.where(mask, s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqc,bkcd->bkgqd", p, vb[j].to(torch.float32))
        m = m_new
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out, lse


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          logit_cap: float | None = None,
                          kv_block: int = 512, q_offset: int = 0
                          ) -> torch.Tensor:
    """The plain twin of the flash kernel: the reference's blocked scan.
    q [B,H,Sq,dh]; k, v [B,Hkv,Skv,dh]; Skv % min(kv_block, Skv) == 0."""
    b, h, sq, dh = q.shape
    _, hkv, skv, _ = k.shape
    if h % hkv:
        raise ValueError(f"{h} query heads over {hkv} kv heads")
    scale = dh ** -0.5
    qg = _group_q(q, hkv).to(torch.float32) * scale  # [B,Hkv,G,Sq,dh]
    kv_block = min(kv_block, skv)
    nb = skv // kv_block
    if nb * kv_block != skv:
        raise ValueError(f"kv length {skv} is not a multiple of {kv_block}")
    kb = torch.movedim(k.reshape(b, hkv, nb, kv_block, dh), 2, 0)
    vb = torch.movedim(v.reshape(b, hkv, nb, kv_block, dh), 2, 0)
    out, _ = _flash_fwd_scan(qg, kb, vb, sq=sq, kv_block=kv_block,
                             q_offset=q_offset, causal=causal, window=window,
                             logit_cap=logit_cap)
    return out.reshape(b, h, sq, dh).to(q.dtype)

