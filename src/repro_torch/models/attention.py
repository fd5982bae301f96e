"""Attention for the LM prefill, training and decode paths (port of
``repro/models/attention.py``): RoPE, the GQA grouping, the block mask,
the blocked online-softmax flash attention forward and backward, the
int8 KV quantization and the one-token decode attention over a cache.

``flash_attention_plain`` is the reference's ``lax.scan`` over kv blocks
written as a Python loop: the plain twin of the flash forward kernel.
``flash_attention_bwd_plain`` is the reference's custom-VJP backward
(``_bwd_impl``) as a loop over kv blocks: the plain twin of the two
backward kernels. The model calls ``kernels.flash_attention
.flash_attention_bhsd``, which launches the kernels on CUDA tensors and
runs these twins on CPU tensors.

``decode_attention_plain`` is the reference's ``decode_attention``: the
plain twin of the decode kernel (``kernels.decode_attention``, which the
decode step calls). ``decode_attention_partial`` is the reference's
per-shard ``(m, l, acc)`` form, and ``decode_attention_split`` runs the
kernel's own arithmetic in torch: fixed splits of the cache, each a
partial, combined in split order by the log-sum-exp rule.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.dist.groups import Reduce

from .common import softcap as _softcap

NEG_INF = -1e30


@functools.cache
def _init_cpu_math() -> None:
    """One single-threaded ``torch.exp`` per process, before the float32
    twins' first parallel transcendental op. Works around a fault of
    torch's CPU build (MKL's vector math under OpenMP): the first
    multi-threaded ``exp``, ``log`` or ``tanh`` of a process can compute
    one thread's chunk with errors up to 1.5e-4 relative, so the twins'
    first call did not give the bits of later ones. What that call races
    on is set up once for all of MKL's vector-math functions: a 4-element
    call of any of them (it runs on one thread, under the parallel grain)
    removes the fault from all three ops, and starting the thread pool
    alone does not (``tools/cpu_first_call_probe.py``)."""
    torch.exp(torch.zeros(4))


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
    _init_cpu_math()
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


def _flash_bwd_scan(qg, kb, vb, out, lse, dout, *, sq, kv_block, q_offset,
                    causal, window, logit_cap):
    """The reference's ``_bwd_impl``: returns (dqg, dk, dv), dqg the
    float32 gradient of the pre-scaled qg, dk and dv [nb, B, Hkv,
    kv_block, dh] in kb's and vb's dtypes. out and dout [B,Hkv,G,Sq,dh],
    lse [B,Hkv,G,Sq] float32. P is recomputed per block from lse, so no
    [Sq, Skv] tile outlives its block."""
    _init_cpu_math()
    dout = dout.to(torch.float32)
    delta = torch.sum(dout * out.to(torch.float32), dim=-1)  # [B,K,G,Sq]
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=qg.device)
    dq = torch.zeros_like(qg)
    dks, dvs = [], []
    for j in range(kb.shape[0]):
        kjf = kb[j].to(torch.float32)
        vjf = vb[j].to(torch.float32)
        s_cap = _softcap(torch.einsum("bkgqd,bkcd->bkgqc", qg, kjf),
                         logit_cap)
        mask = _blk_mask(sq, kv_block, j, q_offset, causal, window,
                         qg.device)
        p = torch.exp(torch.where(mask, s_cap, neg) - lse[..., None])
        dvs.append(torch.einsum("bkgqc,bkgqd->bkcd", p, dout).to(vb.dtype))
        dp = torch.einsum("bkgqd,bkcd->bkgqc", dout, vjf)
        ds = p * (dp - delta[..., None])
        if logit_cap is not None:
            t = s_cap / logit_cap  # tanh(s_raw / cap), in [-1, 1]
            ds = ds * (1.0 - t * t)
        ds = torch.where(mask, ds, 0.0)
        dq = dq + torch.einsum("bkgqc,bkcd->bkgqd", ds, kjf)
        dks.append(torch.einsum("bkgqc,bkgqd->bkcd", ds, qg).to(kb.dtype))
    return dq, torch.stack(dks), torch.stack(dvs)


def _blocks(q, k, v, kv_block):
    """(qg scaled float32 [B,Hkv,G,Sq,dh], kb, vb [nb,B,Hkv,blk,dh],
    the block length)."""
    b, h, sq, dh = q.shape
    _, hkv, skv, _ = k.shape
    if h % hkv:
        raise ValueError(f"{h} query heads over {hkv} kv heads")
    qg = _group_q(q, hkv).to(torch.float32) * dh ** -0.5
    kv_block = min(kv_block, skv)
    nb = skv // kv_block
    if nb * kv_block != skv:
        raise ValueError(f"kv length {skv} is not a multiple of {kv_block}")
    kb = torch.movedim(k.reshape(b, hkv, nb, kv_block, dh), 2, 0)
    vb = torch.movedim(v.reshape(b, hkv, nb, kv_block, dh), 2, 0)
    return qg, kb, vb, kv_block


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          logit_cap: float | None = None,
                          kv_block: int = 512, q_offset: int = 0,
                          return_lse: bool = False,
                          out_dtype: torch.dtype | None = None):
    """The plain twin of the flash forward kernel: the reference's blocked
    scan. q [B,H,Sq,dh]; k, v [B,Hkv,Skv,dh]; Skv % min(kv_block, Skv)
    == 0. Returns out [B,H,Sq,dh] in ``out_dtype`` (q's dtype when None;
    float32 is the scan's own output, the reference VJP's residual) and,
    with ``return_lse``, also the float32 log-sum-exp [B,H,Sq] of the
    scaled, capped scores."""
    b, h, sq, dh = q.shape
    qg, kb, vb, kv_block = _blocks(q, k, v, kv_block)
    out, lse = _flash_fwd_scan(qg, kb, vb, sq=sq, kv_block=kv_block,
                               q_offset=q_offset, causal=causal,
                               window=window, logit_cap=logit_cap)
    out = out.reshape(b, h, sq, dh).to(out_dtype or q.dtype)
    return (out, lse.reshape(b, h, sq)) if return_lse else out


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal=True,
                              window=None, logit_cap=None, kv_block=512,
                              q_offset=0):
    """The plain twin of the flash backward kernels: (dq, dk, dv) in the
    dtypes of q, k, v, from the forward's float32 out [B,H,Sq,dh] and lse
    [B,H,Sq] and the output gradient dout [B,H,Sq,dh]. dk and dv sum
    each kv head's group of query heads."""
    b, h, sq, dh = q.shape
    hkv = k.shape[1]
    qg, kb, vb, kv_block = _blocks(q, k, v, kv_block)
    dqg, dk, dv = _flash_bwd_scan(
        qg, kb, vb, _group_q(out, hkv), lse.reshape(b, hkv, h // hkv, sq),
        _group_q(dout, hkv), sq=sq, kv_block=kv_block, q_offset=q_offset,
        causal=causal, window=window, logit_cap=logit_cap)
    dq = (dqg * dh ** -0.5).reshape(b, h, sq, dh).to(q.dtype)
    return (dq, torch.movedim(dk, 0, 2).reshape(k.shape),
            torch.movedim(dv, 0, 2).reshape(v.shape))



# ------------------------------------------------------------------ decode
def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(B, H, S) symmetric int8 quantization of a KV tensor [B,H,S,dh]:
    (int8 values, float32 scales [B,H,S,1]). ``torch.round`` rounds half
    to even, as ``jnp.round``: the bits are the reference's."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """``int8 × scale`` in float32, rounded to ``dtype`` (bf16: the decode
    attention reads an int8 cache through bf16)."""
    return (q.to(torch.float32) * scale).to(dtype)


def _decode_scores(q, k_cache, logit_cap):
    """(qg [B,Hkv,G,1,dh] scaled float32, capped float32 scores
    [B,Hkv,G,1,S])."""
    dh = q.shape[-1]
    qg = _group_q(q, k_cache.shape[1]).to(torch.float32) * dh ** -0.5
    sc = torch.einsum("bkgqd,bkcd->bkgqc", qg, k_cache.to(torch.float32))
    return qg, _softcap(sc, logit_cap)


def decode_mask(cache_len: torch.Tensor, s: int,
                window: int | None = None) -> torch.Tensor:
    """[B, S] bool: the positions a decode step attends, ``pos <
    cache_len`` (and ``pos >= cache_len - window``)."""
    pos = torch.arange(s, device=cache_len.device)
    mask = pos[None, :] < cache_len[:, None]
    if window is not None:
        mask &= pos[None, :] >= cache_len[:, None] - window
    return mask


def _partial(sc, v_cache, mask):
    """(m, l, acc) of capped scores sc [B,Hkv,G,1,S] under mask [B,S]."""
    sc = torch.where(mask[:, None, None, None, :], sc, NEG_INF)
    m = sc.amax(dim=-1)
    p = torch.exp(sc - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgqc,bkcd->bkgqd", p, v_cache.to(torch.float32))
    return m, l, acc


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, cache_len: torch.Tensor,
                           *, window: int | None = None,
                           logit_cap: float | None = None,
                           k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """One-token decode attention, the reference's ``decode_attention``:
    q [B,H,1,dh]; caches [B,Hkv,S,dh] (bf16, or int8 with float32 scales
    [B,Hkv,S,1], read through bf16); ``cache_len`` [B] the valid length
    (the new token at cache_len - 1). Softmax in float32 over one pass;
    returns [B,H,1,dh] in q's dtype. The plain twin of the decode
    kernel."""
    b, h, _, dh = q.shape
    _init_cpu_math()
    if k_scale is not None:
        k_cache = dequantize_kv(k_cache, k_scale)
        v_cache = dequantize_kv(v_cache, v_scale)
    _, sc = _decode_scores(q, k_cache, logit_cap)
    m, l, acc = _partial(sc, v_cache,
                         decode_mask(cache_len, k_cache.shape[2], window))
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, h, 1, dh).to(q.dtype)


def decode_attention_partial(q, k_cache, v_cache, valid_mask, *,
                             logit_cap=None):
    """Partial-softmax decode over a sequence shard of the cache, the
    reference's form for a log-sum-exp combine: (m, l, acc) shaped
    [B,Hkv,G,1], [B,Hkv,G,1], [B,Hkv,G,1,dh]. q [B,H,1,dh]; caches
    [B,Hkv,S_shard,dh]; valid_mask [B,S_shard]."""
    _init_cpu_math()
    _, sc = _decode_scores(q, k_cache, logit_cap)
    return _partial(sc, v_cache, valid_mask)


def combine_partials(parts, reduce=None) -> torch.Tensor:
    """The log-sum-exp combine of (m, l, acc) partials (the reference's
    rule, ``repro/dist/collectives.py``): out = Σ acc·e^(m − M) / max(Σ
    l·e^(m − M), 1e-30), M the largest m. ``reduce``
    (``dist.groups.Reduce``) takes the max and the sums: None folds
    ``parts`` in their order in this process; on a process group
    ``parts`` is this rank's one partial, all-reduced over it."""
    red = reduce or Reduce()
    mg = red.max([m for m, _, _ in parts])
    corr = [torch.exp(m - mg) for m, _, _ in parts]
    l_sum = red.sum([l * c for (_, l, _), c in zip(parts, corr)])
    acc_sum = red.sum([acc * c[..., None]
                       for (_, _, acc), c in zip(parts, corr)])
    return acc_sum / torch.clamp(l_sum[..., None], min=1e-30)


def decode_attention_split(q, k_cache, v_cache, cache_len, *, split: int,
                           window=None, logit_cap=None, k_scale=None,
                           v_scale=None) -> torch.Tensor:
    """The decode kernel's arithmetic in torch: the cache cut into fixed
    splits of ``split`` positions, a (m, l, acc) partial each, combined in
    split order by ``combine_partials``. Equal to
    ``decode_attention_plain`` up to float32 summation order."""
    b, h, _, dh = q.shape
    if k_scale is not None:
        k_cache = dequantize_kv(k_cache, k_scale)
        v_cache = dequantize_kv(v_cache, v_scale)
    mask = decode_mask(cache_len, k_cache.shape[2], window)
    parts = [decode_attention_partial(
        q, k_cache[:, :, i:i + split], v_cache[:, :, i:i + split],
        mask[:, i:i + split], logit_cap=logit_cap)
        for i in range(0, k_cache.shape[2], split)]
    return combine_partials(parts).reshape(b, h, 1, dh).to(q.dtype)
