"""Sharded decode attention on ``torch.distributed`` (port of
``repro/dist/collectives.py``).

Every rank holds q [B, H, 1, dh] whole and its own shard of the KV cache
(``dist.sharding.lm_cache_shardings``) as plain tensors; the collectives
are explicit calls on the mesh's process groups. The caller names the
cache's whole extent (``kv_heads``, ``seq_len``: None is the shard's
own, an uncut cache), which decides, by the reference's rules, whether
the shard is cut at all.

* ``sharded_decode_attention`` — KV heads over the ``model`` axis. Each
  rank runs the decode kernel on its own head group (query heads travel
  with their KV head, regrouped kv-major), then an all-gather over
  ``model`` restores the head dim.
* ``sharded_decode_attention_seq`` — the cache's sequence over the dp
  axes (flash-decoding). Each rank computes its slice's partial softmax
  (m, l, acc) with the decode kernel's partial mode, over its *local*
  lengths ``clamp(cache_len - r · S_l, 0, S_l)`` (the global positions
  below ``cache_len``), then the ranks combine them by the reference's
  rule (``models.attention.combine_partials`` over the dp group's
  ``Reduce``): an all-reduce MAX of m, and all-reduce SUMs of
  ``l · e^(m − M)`` and ``acc · e^(m − M)``. A rank whose slice holds no
  live position gives (−inf, 0, 0), weighed by 0. int8 caches pass their
  scales, sliced alongside, and dequantize in the kernel. Where the KV heads cover
  ``model`` they stay cut over it too. ``sharded_decode_attention_seq_ranks``
  runs every rank's stage in one process (how one card holds it), the
  same combine folding the ranks' partials in rank order.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_partial)
from repro_torch.models.attention import combine_partials

from .groups import (Reduce, all_gather_cat, check_mesh, dp_group, dp_rank,
                     dp_size, model_group, model_rank)
from .sharding import model_axis_size


def _head_sharded(mesh, hkv: int) -> bool:
    msz = 1 if mesh is None else model_axis_size(mesh)
    return msz > 1 and hkv % msz == 0 and hkv >= msz


def _head_group(mesh, q: torch.Tensor, hkv: int, hkv_l: int) -> torch.Tensor:
    """This model rank's query heads [B, hkv_l · G, 1, dh] (kv-major: head
    h = kv · G + g travels with kv head kv)."""
    b, h, _, dh = q.shape
    r = model_rank(mesh)
    qg = q.reshape(b, hkv, h // hkv, dh)[:, r * hkv_l:(r + 1) * hkv_l]
    return qg.reshape(b, -1, 1, dh).contiguous()


def _check_shard(what: str, got: int, whole: int, n: int) -> None:
    if got * n != whole:
        raise ValueError(f"a cache shard of {got} {what} is not 1/{n} of "
                         f"{whole}")


def sharded_decode_attention(mesh, q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, cache_len: torch.Tensor,
                             *, kv_heads: int | None = None,
                             window: int | None = None,
                             logit_cap: float | None = None,
                             k_scale: torch.Tensor | None = None,
                             v_scale: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Head-sharded decode: q [B, H, 1, dh] whole, the caches this rank's
    KV heads [B, Hkv / m, S, dh] of ``kv_heads`` (m the ``model`` extent);
    returns [B, H, 1, dh] whole on every rank. The dense kernel where the
    mesh has no model extent or the KV heads do not cover it."""
    hkv = kv_heads or k_cache.shape[1]
    if not _head_sharded(mesh, hkv):
        return decode_attention(q, k_cache, v_cache, cache_len,
                                window=window, logit_cap=logit_cap,
                                k_scale=k_scale, v_scale=v_scale)
    check_mesh(mesh)
    _check_shard("kv heads", k_cache.shape[1], hkv, model_axis_size(mesh))
    q_l = _head_group(mesh, q, hkv, k_cache.shape[1])
    o = decode_attention(q_l, k_cache, v_cache, cache_len, window=window,
                         logit_cap=logit_cap, k_scale=k_scale,
                         v_scale=v_scale)
    return all_gather_cat(o, model_group(mesh), dim=1)


def seq_slice_partial(q, k_slice, v_slice, cache_len, r: int, *,
                      logit_cap=None, k_scale=None, v_scale=None):
    """Rank r's stage: the partial (m, l, acc) of its slice of S_l
    positions (the decode kernel's partial mode), over its local lengths
    ``clamp(cache_len - r · S_l, 0, S_l)``."""
    s_l = k_slice.shape[2]
    local_len = torch.clamp(cache_len - r * s_l, 0, s_l).to(torch.int32)
    return decode_attention_partial(q, k_slice, v_slice, local_len,
                                    logit_cap=logit_cap, k_scale=k_scale,
                                    v_scale=v_scale)


def sharded_decode_attention_seq_ranks(q, k_cache, v_cache, cache_len,
                                       world: int, *, logit_cap=None,
                                       k_scale=None, v_scale=None):
    """``sharded_decode_attention_seq`` at a world of ``world`` ranks over
    the whole cache, run in this process: each rank's stage on its slice
    in turn, the combine (``models.attention.combine_partials``) folding
    the partials in rank order."""
    b, h, _, dh = q.shape
    s_l = k_cache.shape[2] // world

    def cut(t, r):
        return None if t is None else \
            t[:, :, r * s_l:(r + 1) * s_l].contiguous()
    parts = [seq_slice_partial(q, cut(k_cache, r), cut(v_cache, r),
                               cache_len, r, logit_cap=logit_cap,
                               k_scale=cut(k_scale, r),
                               v_scale=cut(v_scale, r))
             for r in range(world)]
    return combine_partials(parts).reshape(b, h, 1, dh).to(q.dtype)


def sharded_decode_attention_seq(mesh, q: torch.Tensor,
                                 k_cache: torch.Tensor,
                                 v_cache: torch.Tensor,
                                 cache_len: torch.Tensor, *,
                                 seq_len: int | None = None,
                                 kv_heads: int | None = None,
                                 logit_cap: float | None = None,
                                 k_scale: torch.Tensor | None = None,
                                 v_scale: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """Sequence-sharded decode: the caches (and int8 scales) this rank's
    slice [B, Hkv_l, S / n, dh] of a cache of ``seq_len`` positions (n
    the dp extent; the heads also cut over ``model`` where they cover
    it), ``cache_len`` [B] the global lengths; returns [B, H, 1, dh] whole
    on every rank. Where the mesh has no dp extent or ``seq_len`` does not
    divide, the slice is the whole sequence and the head-sharded path
    runs."""
    b, h, _, dh = q.shape
    hkv = kv_heads or k_cache.shape[1]
    s = seq_len or k_cache.shape[2]
    n = 1 if mesh is None else dp_size(mesh)
    if n <= 1 or s % n:
        return sharded_decode_attention(mesh, q, k_cache, v_cache, cache_len,
                                        kv_heads=hkv, logit_cap=logit_cap,
                                        k_scale=k_scale, v_scale=v_scale)
    check_mesh(mesh)
    s_l = k_cache.shape[2]
    _check_shard("positions", s_l, s, n)
    head_sharded = _head_sharded(mesh, hkv)
    if head_sharded:
        _check_shard("kv heads", k_cache.shape[1], hkv, model_axis_size(mesh))
        q_l = _head_group(mesh, q, hkv, k_cache.shape[1])
    else:
        q_l = q.contiguous()
    part = seq_slice_partial(q_l, k_cache, v_cache, cache_len,
                             dp_rank(mesh), logit_cap=logit_cap,
                             k_scale=k_scale, v_scale=v_scale)
    out = combine_partials([part], Reduce(dp_group(mesh)))
    out = out.reshape(b, q_l.shape[1], 1, dh)
    if head_sharded:
        out = all_gather_cat(out, model_group(mesh), dim=1)
    return out.to(q.dtype)


def seq_sharded_decode_attn_fn(mesh, *, seq_len: int,
                               kv_heads: int | None = None):
    """An ``attn_fn`` for ``models.transformer.lm_decode_step`` over
    caches of ``seq_len`` positions whose sequence is cut over the dp
    ranks (``lm_cache_shardings(..., seq_sharded=True)``): it routes
    through ``sharded_decode_attention_seq``. A caller with a window
    (the reference's dense fallback) gets the dense kernel on the slices
    all-gathered back to the whole cache."""

    def attn_fn(q, k_cache, v_cache, cache_len, *, window=None,
                logit_cap=None, k_scale=None, v_scale=None):
        if window is None:
            return sharded_decode_attention_seq(
                mesh, q, k_cache, v_cache, cache_len, seq_len=seq_len,
                kv_heads=kv_heads, logit_cap=logit_cap, k_scale=k_scale,
                v_scale=v_scale)
        if k_cache.shape[2] != seq_len:
            group = dp_group(mesh)
            k_cache, v_cache = (all_gather_cat(t, group, dim=2)
                                for t in (k_cache, v_cache))
            if k_scale is not None:
                k_scale, v_scale = (all_gather_cat(t, group, dim=2)
                                    for t in (k_scale, v_scale))
        return sharded_decode_attention(mesh, q, k_cache, v_cache, cache_len,
                                        kv_heads=kv_heads, window=window,
                                        logit_cap=logit_cap, k_scale=k_scale,
                                        v_scale=v_scale)

    return attn_fn
