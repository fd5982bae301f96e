"""LM-family transformer, the prefill, training and decode paths (port of
``LMConfig``, the forward, ``lm_loss`` and the decode step of
``repro/models/transformer.py``) for gemma2-style alternating local /
global layers.

``LM`` is an ``nn.Module`` whose weights keep the reference's layout
(``x @ W`` with ``W`` shaped [d_in, d_out]). The reference stacks the
local and the global layers as ``[n_layers / 2, ...]`` trees and scans
over (local, global) pairs; here ``LM.layers`` lists the layers in the
order they run, local first in each pair. ``load_reference_lm_params``
carries a reference ``lm_init`` tree into the module and
``load_reference_opt_state`` a reference AdamW state into the port's.
Every layer's attention is ``kernels.flash_attention.flash_attention_bhsd``:
the flash kernels on the card, their plain twins on the CPU, with the
kernels' backward under autograd. With ``cfg.remat`` each (local, global)
pair is recomputed in the backward (``torch.utils.checkpoint``), as the
reference's ``jax.checkpoint(pair)``.

Decode (``lm_decode_step``) runs one token a batch row through every
layer against a KV cache (``make_cache``: the reference's dict, ``local``
/ ``global`` stacked ``[n_layers / 2, B, Hkv, S, dh]``, int8 with float32
scales when ``cfg.kv_cache_dtype`` is ``"int8"``, else bf16, whatever
``cfg.dtype`` is). A local layer's cache is a ring of ``min(window,
max_len)`` positions. The cache is updated in place, with device-side
index writes only, so a decode step can be captured as a CUDA graph; its
attention is ``kernels.decode_attention.decode_attention`` (the kernel on
the card, the plain twin on the CPU).

Branches gemma2 does not take raise ``NotImplementedError``: MoE blocks,
the unrolled ``blocks_list`` and stacked ``blocks`` layouts (configs
without ``local_global``) and ``qkv_bias`` come with the LM configs of
ROADMAP.md A.7.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.graph import resolve_device

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention_bhsd

from .attention import quantize_kv, rope
from .common import (cross_entropy, dense_init, embed_init, gelu_tanh,
                     glu_apply, glu_init, rms_norm, softcap)

_UNPORTED = ("is not ported yet (ROADMAP.md A.7: the LMConfig branches "
             "other than gemma2's)")


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 → d_model // n_heads
    moe_experts: int = 0
    moe_top_k: int = 0
    qkv_bias: bool = False
    local_global: bool = False  # gemma2 alternating local/global
    sliding_window: int = 4096
    attn_logit_cap: float | None = None
    final_logit_cap: float | None = None
    rope_theta: float = 10000.0
    norm_zero_centered: bool = False
    post_norm: bool = False
    tied_embed: bool = False
    embed_scale: bool = False  # gemma2 multiplies by sqrt(d)
    dtype: torch.dtype = torch.float32
    remat: bool = False
    kv_cache_dtype: str = "bf16"  # "bf16" | "int8"
    kv_block: int = 512
    train_layout: str = "tp"
    scan_layers: bool = True

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0


def _check_ported(cfg: LMConfig) -> None:
    if cfg.is_moe:
        raise NotImplementedError(f"MoE blocks ({cfg.name}) {_UNPORTED}")
    if cfg.qkv_bias:
        raise NotImplementedError(f"qkv_bias ({cfg.name}) {_UNPORTED}")
    if not cfg.local_global:
        layout = "stacked 'blocks'" if cfg.scan_layers else "'blocks_list'"
        raise NotImplementedError(
            f"the {layout} layer layout ({cfg.name}) {_UNPORTED}")


def _norm(cfg: LMConfig, device) -> nn.Parameter:
    fill = torch.zeros if cfg.norm_zero_centered else torch.ones
    return nn.Parameter(fill((cfg.d_model,), dtype=cfg.dtype, device=device))


class Block(nn.Module):
    """One pre-norm block (``_block_init``'s tree, ``mlp`` flattened)."""

    def __init__(self, cfg: LMConfig, generator: torch.Generator, device):
        super().__init__()
        d, dh, dt = cfg.d_model, cfg.dh, cfg.dtype

        def dense(a, b):
            return nn.Parameter(dense_init(generator, a, b, dt, device))

        self.wq = dense(d, cfg.n_heads * dh)
        self.wk = dense(d, cfg.n_kv_heads * dh)
        self.wv = dense(d, cfg.n_kv_heads * dh)
        self.wo = dense(cfg.n_heads * dh, d)
        self.ln_attn = _norm(cfg, device)
        self.ln_mlp = _norm(cfg, device)
        if cfg.post_norm:
            self.ln_post_attn = _norm(cfg, device)
            self.ln_post_mlp = _norm(cfg, device)
        for name, w in glu_init(generator, d, cfg.d_ff, dt, device).items():
            setattr(self, name, nn.Parameter(w))


class LM(nn.Module):
    """The transformer of ``lm_init``: ``embed``, the layers in run order
    (local, global, local, ...), ``ln_final`` and, untied, ``lm_head``.

    Random init draws N(0, 1/d_in) weights and a N(0, 0.02²) embedding
    (the reference's scales) in float32 from one generator seeded with
    ``seed`` on ``device``, one tensor at a time, each cast to
    ``cfg.dtype`` at once: a full-width model never holds its weights in
    float32. The values depend on the device's generator (a missing card
    raises).
    """

    def __init__(self, cfg: LMConfig, seed: int = 0, device="cuda"):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        device = resolve_device(device)
        g = torch.Generator(device=device).manual_seed(seed)
        self.embed = nn.Parameter(embed_init(g, cfg.vocab, cfg.d_model,
                                             cfg.dtype, device))
        self.layers = nn.ModuleList(
            Block(cfg, g, device) for _ in range(2 * (cfg.n_layers // 2)))
        self.ln_final = _norm(cfg, device)
        self.lm_head = None if cfg.tied_embed else nn.Parameter(
            dense_init(g, cfg.d_model, cfg.vocab, cfg.dtype, device))

    def window(self, i: int) -> int | None:
        """Layer i's sliding window: local layers (even i) have one."""
        return self.cfg.sliding_window if i % 2 == 0 else None

    def forward(self, tokens: torch.Tensor):
        return lm_forward(self, tokens)


def reference_leaf(model: LM, tree, name: str) -> np.ndarray:
    """The array of the reference ``lm_init``-shaped tree ``tree``
    (``embed``, ``ln_final``, ``local`` / ``global`` stacked
    ``[n_layers / 2, ...]`` with the MLP under ``mlp``, ``lm_head`` when
    untied) that holds the port's parameter ``name``."""
    if "blocks" in tree or "blocks_list" in tree:
        raise NotImplementedError(f"the stacked layer layouts {_UNPORTED}")
    if ("lm_head" in tree) != (model.lm_head is not None):
        raise ValueError("lm_head presence differs")
    if not name.startswith("layers."):
        return np.asarray(tree[name])
    _, i, leaf = name.split(".")
    i = int(i)
    stack = tree["local" if i % 2 == 0 else "global"]
    if np.asarray(stack["wq"]).shape[0] != len(model.layers) // 2:
        raise ValueError("stack depth differs")
    src = stack["mlp"][leaf] if leaf.startswith("w_") else stack[leaf]
    return np.asarray(src)[i // 2]


def _put(dst: torch.Tensor, src) -> None:
    arr = torch.from_numpy(np.array(src, dtype=np.float32))
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(arr.shape)} != {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(arr.to(device=dst.device, dtype=dst.dtype))


def load_reference_lm_params(model: LM, params) -> LM:
    """Carry the reference's ``lm_init`` tree (arrays convertible by
    ``np.asarray``) into ``model``, in place; shapes must match exactly
    (same [d_in, d_out] layout)."""
    for name, p in model.named_parameters():
        _put(p, reference_leaf(model, params, name))
    return model


def load_reference_opt_state(model: LM, state: dict, ref_state) -> dict:
    """Carry a reference ``adamw_init`` / ``adamw_update`` state (``m`` and
    ``v`` trees shaped like ``lm_init``'s, ``step``; arrays convertible by
    ``np.asarray``) into the port's AdamW ``state`` of ``model``
    (``train.optim.adamw_init``), in place; returns ``state``."""
    for name, _ in model.named_parameters():
        for key in ("m", "v"):
            _put(state[key][name], reference_leaf(model, ref_state[key], name))
    state["step"].fill_(int(np.asarray(ref_state["step"])))
    return state


# ------------------------------------------------------------------ forward
def _attn(cfg: LMConfig, p: Block, x, positions, *, window=None):
    b, s, _ = x.shape
    dh = cfg.dh
    q = (x @ p.wq).reshape(b, s, cfg.n_heads, dh).transpose(1, 2)
    k = (x @ p.wk).reshape(b, s, cfg.n_kv_heads, dh).transpose(1, 2)
    v = (x @ p.wv).reshape(b, s, cfg.n_kv_heads, dh).transpose(1, 2)
    q = rope(q, positions[None, None, :], cfg.rope_theta)
    k = rope(k, positions[None, None, :], cfg.rope_theta)
    o = flash_attention_bhsd(q, k, v.contiguous(), causal=True,
                            window=window, logit_cap=cfg.attn_logit_cap,
                            kv_block=min(cfg.kv_block, s))
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * dh)
    return o @ p.wo, k, v


def _block(cfg: LMConfig, p: Block, x, positions, *, window=None):
    zc = cfg.norm_zero_centered
    h, _, _ = _attn(cfg, p, rms_norm(x, p.ln_attn, zero_centered=zc),
                    positions, window=window)
    if cfg.post_norm:
        h = rms_norm(h, p.ln_post_attn, zero_centered=zc)
    x = x + h
    z = rms_norm(x, p.ln_mlp, zero_centered=zc)
    act = gelu_tanh if cfg.name.startswith("gemma") else F.silu
    y = glu_apply(p.w_gate, p.w_in, p.w_out, z, act=act)
    if cfg.post_norm:
        y = rms_norm(y, p.ln_post_mlp, zero_centered=zc)
    return x + y


def _pair(model: LM, i: int, x, positions):
    """Layers i and i + 1, a (local, global) pair: the reference's scan
    body ``pair``."""
    for j in (i, i + 1):
        x = _block(model.cfg, model.layers[j], x, positions,
                   window=model.window(j))
    return x


def lm_trunk(model: LM, tokens: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] → (hidden [B, S, d] after the final norm, aux loss).
    With ``cfg.remat`` and autograd on, each pair keeps only its input
    and is recomputed in the backward."""
    cfg = model.cfg
    s = tokens.shape[1]
    x = model.embed[tokens.to(torch.int64)].to(cfg.dtype)
    if cfg.embed_scale:
        # the reference rounds √d to the model dtype (60.0 in bf16 at 3584)
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype)
    positions = torch.arange(s, device=tokens.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(0, len(model.layers), 2):
        x = (checkpoint(_pair, model, i, x, positions, use_reentrant=False)
             if remat else _pair(model, i, x, positions))
    x = rms_norm(x, model.ln_final, zero_centered=cfg.norm_zero_centered)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def lm_head_logits(model: LM, x: torch.Tensor) -> torch.Tensor:
    head = model.embed.T if model.cfg.tied_embed else model.lm_head
    return softcap(x @ head.to(x.dtype), model.cfg.final_logit_cap)


def lm_forward(model: LM, tokens: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] → (logits [B, S, V], aux loss)."""
    x, aux = lm_trunk(model, tokens)
    return lm_head_logits(model, x), aux


def lm_loss(model: LM, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy (+ 0.01 × the MoE aux loss, 0 here)."""
    logits, aux = lm_forward(model, tokens)
    loss = cross_entropy(logits[:, :-1], tokens[:, 1:])
    return loss + 0.01 * aux


@torch.no_grad()
def lm_prefill(model: LM, tokens: torch.Tensor) -> torch.Tensor:
    """Prefill: the trunk over the prompt, the head on the last position
    only ([B, V] logits), with no autograd record."""
    x, _ = lm_trunk(model, tokens)
    return lm_head_logits(model, x[:, -1])


# -------------------------------------------------------------------- decode
def make_cache(cfg: LMConfig, batch: int, max_len: int,
               device="cuda") -> dict:
    """Zeroed KV cache, the reference's dict: ``{"local": ..., "global":
    ...}``, each ``{"k", "v"}`` [n_layers / 2, batch, Hkv, length, dh]
    (int8 with float32 ``"k_scale"``, ``"v_scale"`` [..., length, 1] when
    ``cfg.kv_cache_dtype`` is ``"int8"``, else bf16); a local layer's
    length is ``min(sliding_window, max_len)`` (a ring), a global layer's
    ``max_len``."""
    _check_ported(cfg)
    dev = resolve_device(device)
    int8 = cfg.kv_cache_dtype == "int8"
    qdt = torch.int8 if int8 else torch.bfloat16

    def kv(length):
        shape = (cfg.n_layers // 2, batch, cfg.n_kv_heads, length, cfg.dh)
        c = {"k": torch.zeros(shape, dtype=qdt, device=dev),
             "v": torch.zeros(shape, dtype=qdt, device=dev)}
        if int8:
            for name in ("k_scale", "v_scale"):
                c[name] = torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                      device=dev)
        return c

    return {"local": kv(min(cfg.sliding_window, max_len)),
            "global": kv(max_len)}


def layer_cache(cache: dict, i: int) -> dict:
    """Layer i's views of ``cache`` (layer i runs in stack ``local`` for
    even i, ``global`` for odd i, at depth i // 2)."""
    stack = cache["local" if i % 2 == 0 else "global"]
    return {name: t[i // 2] for name, t in stack.items()}


def _cache_insert(cfg: LMConfig, layer_cache: dict, k, v, pos) -> None:
    """Write one token's k, v [B, Hkv, 1, dh] at ``pos`` into the layer's
    cache views, in place: at ``pos % length`` (a ring when the cache is
    shorter than the positions). ``pos`` is a scalar (every row at one
    position) or a [B] tensor (a position a row): row b is written at its
    own slot by one index write on device indices (no host read, so it can
    be captured). int8 caches store ``quantize_kv``'s values and scales,
    bf16 caches ``k.to(bfloat16)``, whatever the model's dtype."""
    length = layer_cache["k"].shape[-2]
    if cfg.kv_cache_dtype == "int8":
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        updates = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        updates = {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
    if not torch.is_tensor(pos):
        for name, u in updates.items():
            layer_cache[name][:, :, pos % length] = u[:, :, 0]
        return
    rows = torch.arange(k.shape[0], device=k.device)
    slot = (pos.reshape(-1) % length).to(torch.int64).expand(k.shape[0])
    for name, u in updates.items():
        layer_cache[name][rows, :, slot] = u[:, :, 0]


def _decode_block(cfg: LMConfig, p: Block, x, layer_cache: dict, pos):
    """One token through one block: x [B, 1, d]; ``pos`` a scalar or a [B]
    tensor. The new k, v are inserted first; attention then reads the
    ring's extent, ``min(pos + 1, length)`` positions (the window is the
    ring's length, so no window is passed)."""
    b = x.shape[0]
    dh, zc = cfg.dh, cfg.norm_zero_centered
    z = rms_norm(x, p.ln_attn, zero_centered=zc)
    q = (z @ p.wq).reshape(b, 1, cfg.n_heads, dh).transpose(1, 2)
    k = (z @ p.wk).reshape(b, 1, cfg.n_kv_heads, dh).transpose(1, 2)
    v = (z @ p.wv).reshape(b, 1, cfg.n_kv_heads, dh).transpose(1, 2)
    # [1] (a scalar position broadcasts over B) or [B]
    if torch.is_tensor(pos):
        posv = pos.to(torch.int32).reshape(-1)
    else:
        posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = rope(q, posv[:, None, None], cfg.rope_theta)
    k = rope(k, posv[:, None, None], cfg.rope_theta)
    _cache_insert(cfg, layer_cache, k, v, pos)
    length = layer_cache["k"].shape[-2]
    eff_len = torch.clamp(posv + 1, max=length).expand(b).contiguous()
    o = decode_attention(q, layer_cache["k"], layer_cache["v"], eff_len,
                         window=None, logit_cap=cfg.attn_logit_cap,
                         k_scale=layer_cache.get("k_scale"),
                         v_scale=layer_cache.get("v_scale"))
    h = o.transpose(1, 2).reshape(b, 1, cfg.n_heads * dh) @ p.wo
    if cfg.post_norm:
        h = rms_norm(h, p.ln_post_attn, zero_centered=zc)
    x = x + h
    z = rms_norm(x, p.ln_mlp, zero_centered=zc)
    act = gelu_tanh if cfg.name.startswith("gemma") else F.silu
    y = glu_apply(p.w_gate, p.w_in, p.w_out, z, act=act)
    if cfg.post_norm:
        y = rms_norm(y, p.ln_post_mlp, zero_centered=zc)
    return x + y


@torch.no_grad()
def lm_decode_step(model: LM, cache: dict, tokens: torch.Tensor, pos, *,
                   return_logits: bool = False):
    """One greedy decode step: tokens [B, 1] int32 at ``pos`` (a scalar,
    every row at one position, or a [B] int32 tensor, a position a row:
    the continuous batcher's form). Updates ``cache`` in place and returns
    the next tokens [B, 1] int32 (the first maximal logit), with
    ``return_logits`` also the logits [B, V] in the model's dtype."""
    cfg = model.cfg
    x = model.embed[tokens[:, 0].to(torch.int64)][:, None, :].to(cfg.dtype)
    if cfg.embed_scale:
        # √d rounded to the model dtype, made on the device (no host copy)
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=cfg.dtype,
                           device=x.device)
    for i, layer in enumerate(model.layers):
        x = _decode_block(cfg, layer, x, layer_cache(cache, i), pos)
    x = rms_norm(x, model.ln_final, zero_centered=cfg.norm_zero_centered)
    logits = lm_head_logits(model, x[:, -1])
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    return (nxt, logits) if return_logits else nxt
