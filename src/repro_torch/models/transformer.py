"""LM-family transformer, the prefill, training and decode paths (port of
``LMConfig``, the forward, ``lm_loss`` and the decode step of
``repro/models/transformer.py``): dense GQA / MHA blocks, MoE blocks
(``models.moe``), ``qkv_bias``, and gemma2-style alternating local /
global layers.

``LM`` is an ``nn.Module`` whose weights keep the reference's layout
(``x @ W`` with ``W`` shaped [d_in, d_out]). ``LM.layers`` lists the
layers in the order they run, whatever tree the reference keeps them
in: gemma2's ``local`` / ``global`` stacks of ``[n_layers / 2, ...]``
(scanned as (local, global) pairs, local first), the stacked ``blocks``
tree of ``[n_layers, ...]`` (``scan_layers=True``) or the unrolled
``blocks_list`` (``scan_layers=False``). A block holds its gated MLP's
``w_gate``, ``w_in``, ``w_out``, or under MoE a ``moe`` submodule
(``router``, ``w_gate``, ``w_in``, ``w_out``), and with ``qkv_bias``
the biases ``bq``, ``bk``, ``bv``. ``load_reference_lm_params`` carries
a reference ``lm_init`` tree of any of the three layouts into the
module and ``load_reference_opt_state`` a reference AdamW state into the
port's. Every layer's attention is
``kernels.flash_attention.flash_attention_bhsd``: the flash kernels on
the card, their plain twins on the CPU, with the kernels' backward under
autograd. With ``cfg.remat`` each (local, global) pair, or each layer of
the other layouts, is recomputed in the backward
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``.
Only gemma2's local layers have a sliding window. ``lm_trunk`` returns
the sum of the MoE layers' aux losses (0 for dense models).

Decode (``lm_decode_step``) runs one token a batch row through every
layer against a KV cache (``make_cache``: the reference's dict, ``local``
/ ``global`` stacked ``[n_layers / 2, B, Hkv, S, dh]`` for gemma2,
``blocks`` stacked ``[n_layers, B, Hkv, S, dh]`` otherwise; int8 with
float32 scales when ``cfg.kv_cache_dtype`` is ``"int8"``, else bf16,
whatever ``cfg.dtype`` is). A local layer's cache is a ring of
``min(window, max_len)`` positions. The cache is updated in place, with
device-side index writes only, so a decode step can be captured as a
CUDA graph; its attention is ``kernels.decode_attention.decode_attention``
(the kernel on the card, the plain twin on the CPU). On a mesh a rank may
hold a shard of a cache stack (``CacheShard``: a slice of its positions
and of its KV heads); the insert then writes only the positions the rank
owns, and the stack's ``attn_fn`` (``dist.collectives
.seq_sharded_decode_attn_fn``) combines the ranks' slices.

Under MoE the forward routes through ``models.moe.moe_apply_local`` (a
data-parallel rank's tokens are its own capacity group; ``moe_apply``
with no mesh), the decode step through ``moe_apply``, as the reference.
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
                     glu_apply, glu_init, rms_norm, seeded_generator,
                     softcap)
from .moe import moe_apply, moe_apply_local, moe_init


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

    def padded(self, model_axis: int) -> "LMConfig":
        """The reference's Megatron-style padding, so that every dim cut
        over a model axis of ``model_axis`` divides it: MHA pads heads and
        kv heads together; GQA pads kv up to the axis and heads to a
        multiple of the padded kv; the vocabulary to a multiple of the
        axis; dh stays."""
        def up(x, m):
            return -(-x // m) * m
        if self.n_kv_heads == self.n_heads:
            nh = nkv = up(self.n_heads, model_axis)
        else:
            nkv = up(self.n_kv_heads, model_axis)
            nh = up(up(self.n_heads, model_axis), nkv)
        return dataclasses.replace(
            self, vocab=up(self.vocab, model_axis), n_kv_heads=nkv,
            n_heads=nh, head_dim=self.dh)


def _norm(cfg: LMConfig, device) -> nn.Parameter:
    fill = torch.zeros if cfg.norm_zero_centered else torch.ones
    return nn.Parameter(fill((cfg.d_model,), dtype=cfg.dtype, device=device))


class MoE(nn.Module):
    """A block's MoE weights (``moe_init``'s tree)."""

    def __init__(self, cfg: LMConfig, generator: torch.Generator, device):
        super().__init__()
        for name, w in moe_init(generator, cfg.d_model, cfg.d_ff,
                                cfg.moe_experts, cfg.dtype, device).items():
            setattr(self, name, nn.Parameter(w))


class Block(nn.Module):
    """One pre-norm block (``_block_init``'s tree, ``mlp`` flattened;
    ``moe`` a submodule)."""

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
        if cfg.qkv_bias:
            for name, n in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                            ("bv", cfg.n_kv_heads)):
                setattr(self, name, nn.Parameter(torch.zeros(
                    (n * dh,), dtype=dt, device=device)))
        if cfg.post_norm:
            self.ln_post_attn = _norm(cfg, device)
            self.ln_post_mlp = _norm(cfg, device)
        if cfg.is_moe:
            self.moe = MoE(cfg, generator, device)
        else:
            for name, w in glu_init(generator, d, cfg.d_ff, dt,
                                    device).items():
                setattr(self, name, nn.Parameter(w))


class LM(nn.Module):
    """The transformer of ``lm_init``: ``embed``, the layers in run order
    (gemma2: local, global, local, ...), ``ln_final`` and, untied,
    ``lm_head``.

    Random init draws N(0, 1/d_in) weights and a N(0, 0.02²) embedding
    (the reference's scales) in float32 from one generator seeded with
    ``seed`` on ``device``, one tensor at a time, each cast to
    ``cfg.dtype`` at once: a full-width model never holds its weights in
    float32. The values depend on the device's generator (a missing card
    raises).
    """

    def __init__(self, cfg: LMConfig, seed: int = 0, device="cuda"):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        g = seeded_generator(seed, device)
        self.embed = nn.Parameter(embed_init(g, cfg.vocab, cfg.d_model,
                                             cfg.dtype, device))
        # gemma2 runs n_layers // 2 (local, global) pairs
        depth = 2 * (cfg.n_layers // 2) if cfg.local_global else cfg.n_layers
        self.layers = nn.ModuleList(
            Block(cfg, g, device) for _ in range(depth))
        self.ln_final = _norm(cfg, device)
        self.lm_head = None if cfg.tied_embed else nn.Parameter(
            dense_init(g, cfg.d_model, cfg.vocab, cfg.dtype, device))

    def window(self, i: int) -> int | None:
        """Layer i's sliding window: gemma2's local layers (even i) have
        one, no other layer."""
        if self.cfg.local_global and i % 2 == 0:
            return self.cfg.sliding_window
        return None

    def forward(self, tokens: torch.Tensor):
        return lm_forward(self, tokens)


def _block_leaf(block_tree, path: list[str]):
    """The leaf of one block's tree (or of a stack of them) at the port's
    parameter path: ``moe.<name>`` under ``moe``, a dense block's
    ``w_gate`` / ``w_in`` / ``w_out`` under ``mlp``, the rest by name."""
    if path[0] == "moe":
        return block_tree["moe"][path[1]]
    if path[0].startswith("w_"):
        return block_tree["mlp"][path[0]]
    return block_tree[path[0]]


def reference_leaf(model: LM, tree, name: str) -> np.ndarray:
    """The array of the reference ``lm_init``-shaped tree ``tree``
    (``embed``, ``ln_final``, ``lm_head`` when untied, and the layers:
    ``local`` / ``global`` stacked ``[n_layers / 2, ...]``, ``blocks``
    stacked ``[n_layers, ...]`` or the list ``blocks_list``, each block
    with its MLP under ``mlp`` or ``moe``) that holds the port's
    parameter ``name``."""
    if ("lm_head" in tree) != (model.lm_head is not None):
        raise ValueError("lm_head presence differs")
    if not name.startswith("layers."):
        return np.asarray(tree[name])
    _, i, *path = name.split(".")
    i = int(i)
    n = len(model.layers)
    if "blocks_list" in tree:
        if len(tree["blocks_list"]) != n:
            raise ValueError("layer count differs")
        return np.asarray(_block_leaf(tree["blocks_list"][i], path))
    if "blocks" in tree:
        stack, depth, at = tree["blocks"], n, i
    else:
        stack = tree["local" if i % 2 == 0 else "global"]
        depth, at = n // 2, i // 2
    if np.asarray(stack["wq"]).shape[0] != depth:
        raise ValueError("stack depth differs")
    return np.asarray(_block_leaf(stack, path))[at]


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
def _qkv(cfg: LMConfig, p: Block, x):
    """The projections of x [B, S, d], with their biases under
    ``qkv_bias``: q [B, H, S, dh], k and v [B, Hkv, S, dh]."""
    b, s, _ = x.shape
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    return (q.reshape(b, s, cfg.n_heads, cfg.dh).transpose(1, 2),
            k.reshape(b, s, cfg.n_kv_heads, cfg.dh).transpose(1, 2),
            v.reshape(b, s, cfg.n_kv_heads, cfg.dh).transpose(1, 2))


def _mlp(cfg: LMConfig, p: Block, z, *, local: bool = True):
    """The block's MLP on z [B, S, d]: (y, the MoE aux loss or None).
    ``local`` routes MoE through ``moe_apply_local`` (the forward), else
    ``moe_apply`` (the decode step)."""
    if cfg.is_moe:
        b, s, d = z.shape
        moe = moe_apply_local if local else moe_apply
        y, aux = moe(p.moe, z.reshape(b * s, d), top_k=cfg.moe_top_k)
        return y.reshape(b, s, d), aux
    act = gelu_tanh if cfg.name.startswith("gemma") else F.silu
    return glu_apply(p.w_gate, p.w_in, p.w_out, z, act=act), None


def _attn(cfg: LMConfig, p: Block, x, positions, *, window=None):
    b, s, _ = x.shape
    dh = cfg.dh
    q, k, v = _qkv(cfg, p, x)
    q = rope(q, positions[None, None, :], cfg.rope_theta)
    k = rope(k, positions[None, None, :], cfg.rope_theta)
    o = flash_attention_bhsd(q, k, v.contiguous(), causal=True,
                            window=window, logit_cap=cfg.attn_logit_cap,
                            kv_block=min(cfg.kv_block, s))
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * dh)
    return o @ p.wo, k, v


def _block(cfg: LMConfig, p: Block, x, positions, *, window=None):
    """One block: (x out, the MoE aux loss or None)."""
    zc = cfg.norm_zero_centered
    h, _, _ = _attn(cfg, p, rms_norm(x, p.ln_attn, zero_centered=zc),
                    positions, window=window)
    if cfg.post_norm:
        h = rms_norm(h, p.ln_post_attn, zero_centered=zc)
    x = x + h
    y, aux = _mlp(cfg, p, rms_norm(x, p.ln_mlp, zero_centered=zc))
    if cfg.post_norm:
        y = rms_norm(y, p.ln_post_mlp, zero_centered=zc)
    return x + y, aux


def _span(model: LM, i: int, n: int, x, positions, aux):
    """Layers i .. i + n - 1 (the reference's scan body: a (local,
    global) pair, or one layer), with the aux losses added to ``aux``."""
    for j in range(i, i + n):
        x, a = _block(model.cfg, model.layers[j], x, positions,
                      window=model.window(j))
        if a is not None:
            aux = aux + a
    return x, aux


def lm_trunk(model: LM, tokens: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] → (hidden [B, S, d] after the final norm, the float32
    sum of the layers' MoE aux losses). With ``cfg.remat`` and autograd
    on, each scan body (a pair for gemma2, else a layer) keeps only its
    input and is recomputed in the backward."""
    cfg = model.cfg
    s = tokens.shape[1]
    x = model.embed[tokens.to(torch.int64)].to(cfg.dtype)
    if cfg.embed_scale:
        # the reference rounds √d to the model dtype (60.0 in bf16 at 3584)
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype)
    positions = torch.arange(s, device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    n = 2 if cfg.local_global else 1
    for i in range(0, len(model.layers), n):
        x, aux = (checkpoint(_span, model, i, n, x, positions, aux,
                             use_reentrant=False)
                  if remat else _span(model, i, n, x, positions, aux))
    x = rms_norm(x, model.ln_final, zero_centered=cfg.norm_zero_centered)
    return x, aux


def lm_head_logits(model: LM, x: torch.Tensor) -> torch.Tensor:
    head = model.embed.T if model.cfg.tied_embed else model.lm_head
    return softcap(x @ head.to(x.dtype), model.cfg.final_logit_cap)


def lm_forward(model: LM, tokens: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] → (logits [B, S, V], aux loss)."""
    x, aux = lm_trunk(model, tokens)
    return lm_head_logits(model, x), aux


def lm_loss(model: LM, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy (+ 0.01 × the MoE aux loss)."""
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
    """Zeroed KV cache, the reference's dict: for gemma2 ``{"local": ...,
    "global": ...}``, each ``{"k", "v"}`` [n_layers / 2, batch, Hkv,
    length, dh], a local layer's length ``min(sliding_window, max_len)``
    (a ring), a global layer's ``max_len``; otherwise ``{"blocks": ...}``
    of [n_layers, batch, Hkv, max_len, dh]. int8 with float32
    ``"k_scale"``, ``"v_scale"`` [..., length, 1] when
    ``cfg.kv_cache_dtype`` is ``"int8"``, else bf16."""
    dev = resolve_device(device)
    int8 = cfg.kv_cache_dtype == "int8"
    qdt = torch.int8 if int8 else torch.bfloat16

    def kv(depth, length):
        shape = (depth, batch, cfg.n_kv_heads, length, cfg.dh)
        c = {"k": torch.zeros(shape, dtype=qdt, device=dev),
             "v": torch.zeros(shape, dtype=qdt, device=dev)}
        if int8:
            for name in ("k_scale", "v_scale"):
                c[name] = torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                      device=dev)
        return c

    if not cfg.local_global:
        return {"blocks": kv(cfg.n_layers, max_len)}
    return {"local": kv(cfg.n_layers // 2, min(cfg.sliding_window, max_len)),
            "global": kv(cfg.n_layers // 2, max_len)}


def layer_stack(cache: dict, i: int) -> str:
    """The name of the cache stack that holds layer i."""
    if "blocks" in cache:
        return "blocks"
    return "local" if i % 2 == 0 else "global"


def layer_cache(cache: dict, i: int) -> dict:
    """Layer i's views of ``cache``: depth i of ``blocks``, or for gemma2
    depth i // 2 of ``local`` (even i) or ``global`` (odd i)."""
    depth = i if "blocks" in cache else i // 2
    return {name: t[depth] for name, t in cache[layer_stack(cache, i)]
            .items()}


@dataclasses.dataclass(frozen=True)
class CacheShard:
    """A rank's shard of one cache stack of ``length`` positions: the
    positions from ``pos0`` and the KV heads from ``head0`` (as many as
    its tensors hold), attended by ``attn_fn`` (``q, k, v, cache_len, *,
    window, logit_cap, k_scale, v_scale``; global lengths)."""
    length: int
    pos0: int
    head0: int
    attn_fn: object


def _cache_insert(cfg: LMConfig, layer_cache: dict, k, v, pos,
                  shard: CacheShard | None = None) -> None:
    """Write one token's k, v [B, Hkv, 1, dh] at ``pos`` into the layer's
    cache views, in place: at ``pos % length`` (a ring when the cache is
    shorter than the positions). ``pos`` is a scalar (every row at one
    position) or a [B] tensor (a position a row): row b is written at its
    own slot by one index write on device indices (no host read, so it can
    be captured). int8 caches store ``quantize_kv``'s values and scales,
    bf16 caches ``k.to(bfloat16)``, whatever the model's dtype. With a
    ``shard`` the views hold its positions and heads: a row's position is
    written only where the rank owns it (elsewhere the view keeps its
    values)."""
    if cfg.kv_cache_dtype == "int8":
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        updates = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        updates = {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
    if shard is not None:
        hkv_l, s_l = layer_cache["k"].shape[1], layer_cache["k"].shape[2]
        rows = torch.arange(k.shape[0], device=k.device)
        if torch.is_tensor(pos):
            posv = pos.reshape(-1).to(torch.int64).expand(k.shape[0])
        else:
            posv = torch.full((k.shape[0],), pos, dtype=torch.int64,
                              device=k.device)
        local = posv % shard.length - shard.pos0
        own = ((local >= 0) & (local < s_l))[:, None, None]
        at = torch.clamp(local, 0, s_l - 1)
        for name, u in updates.items():
            u = u[:, shard.head0:shard.head0 + hkv_l, 0]
            view = layer_cache[name]
            view[rows, :, at] = torch.where(own, u, view[rows, :, at])
        return
    length = layer_cache["k"].shape[-2]
    if not torch.is_tensor(pos):
        for name, u in updates.items():
            layer_cache[name][:, :, pos % length] = u[:, :, 0]
        return
    rows = torch.arange(k.shape[0], device=k.device)
    slot = (pos.reshape(-1) % length).to(torch.int64).expand(k.shape[0])
    for name, u in updates.items():
        layer_cache[name][rows, :, slot] = u[:, :, 0]


def _decode_block(cfg: LMConfig, p: Block, x, layer_cache: dict, pos,
                  shard: CacheShard | None = None):
    """One token through one block: x [B, 1, d]; ``pos`` a scalar or a [B]
    tensor. The new k, v are inserted first; attention then reads the
    ring's extent, ``min(pos + 1, length)`` positions (the window is the
    ring's length, so no window is passed); with a ``shard``, through its
    ``attn_fn``."""
    b = x.shape[0]
    dh, zc = cfg.dh, cfg.norm_zero_centered
    q, k, v = _qkv(cfg, p, rms_norm(x, p.ln_attn, zero_centered=zc))
    # [1] (a scalar position broadcasts over B) or [B]
    if torch.is_tensor(pos):
        posv = pos.to(torch.int32).reshape(-1)
    else:
        posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = rope(q, posv[:, None, None], cfg.rope_theta)
    k = rope(k, posv[:, None, None], cfg.rope_theta)
    _cache_insert(cfg, layer_cache, k, v, pos, shard)
    length = layer_cache["k"].shape[-2] if shard is None else shard.length
    eff_len = torch.clamp(posv + 1, max=length).expand(b).contiguous()
    attn = decode_attention if shard is None else shard.attn_fn
    o = attn(q, layer_cache["k"], layer_cache["v"], eff_len, window=None,
             logit_cap=cfg.attn_logit_cap,
             k_scale=layer_cache.get("k_scale"),
             v_scale=layer_cache.get("v_scale"))
    h = o.transpose(1, 2).reshape(b, 1, cfg.n_heads * dh) @ p.wo
    if cfg.post_norm:
        h = rms_norm(h, p.ln_post_attn, zero_centered=zc)
    x = x + h
    y, _ = _mlp(cfg, p, rms_norm(x, p.ln_mlp, zero_centered=zc),
                local=False)
    if cfg.post_norm:
        y = rms_norm(y, p.ln_post_mlp, zero_centered=zc)
    return x + y


@torch.no_grad()
def lm_decode_step(model: LM, cache: dict, tokens: torch.Tensor, pos, *,
                   return_logits: bool = False,
                   shards: dict[str, CacheShard] | None = None):
    """One greedy decode step: tokens [B, 1] int32 at ``pos`` (a scalar,
    every row at one position, or a [B] int32 tensor, a position a row:
    the continuous batcher's form). Updates ``cache`` in place and returns
    the next tokens [B, 1] int32 (the first maximal logit), with
    ``return_logits`` also the logits [B, V] in the model's dtype.
    ``shards`` maps a cache stack's name to the rank's ``CacheShard`` of
    it (a stack not named is whole)."""
    cfg = model.cfg
    x = model.embed[tokens[:, 0].to(torch.int64)][:, None, :].to(cfg.dtype)
    if cfg.embed_scale:
        # √d rounded to the model dtype, made on the device (no host copy)
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=cfg.dtype,
                           device=x.device)
    shards = shards or {}
    for i, layer in enumerate(model.layers):
        x = _decode_block(cfg, layer, x, layer_cache(cache, i), pos,
                          shards.get(layer_stack(cache, i)))
    x = rms_norm(x, model.ln_final, zero_centered=cfg.norm_zero_centered)
    logits = lm_head_logits(model, x[:, -1])
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    return (nxt, logits) if return_logits else nxt
