"""gemma2-9b [arXiv:2408.00118; hf]: 42L d3584 16H (GQA kv=8) d_ff=14336
vocab=256000; local(4096-window)/global alternating, logit softcaps,
zero-centered RMSNorm with post-norms, tied embeddings, head_dim=256."""
import torch

from repro_torch.models.transformer import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="gemma2-9b", n_layers=42, d_model=3584, n_heads=16,
        n_kv_heads=8, d_ff=14336, vocab=256000, head_dim=256,
        local_global=True, sliding_window=4096,
        attn_logit_cap=50.0, final_logit_cap=30.0,
        norm_zero_centered=True, post_norm=True, tied_embed=True,
        embed_scale=True, dtype=torch.bfloat16, remat=True,
        kv_cache_dtype="int8")


def smoke_config() -> LMConfig:
    return LMConfig(
        name="gemma2-9b-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
        local_global=True, sliding_window=8,
        attn_logit_cap=50.0, final_logit_cap=30.0,
        norm_zero_centered=True, post_norm=True, tied_embed=True,
        embed_scale=True, dtype=torch.float32)
