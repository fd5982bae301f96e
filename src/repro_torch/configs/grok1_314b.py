"""grok-1-314b [hf:xai-org/grok-1; unverified]: 64L d6144 48H (GQA kv=8)
d_ff=32768 vocab=131072, MoE 8 experts top-2."""
import torch

from repro_torch.models.transformer import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="grok-1-314b", n_layers=64, d_model=6144, n_heads=48,
        n_kv_heads=8, d_ff=32768, vocab=131072,
        moe_experts=8, moe_top_k=2, dtype=torch.bfloat16, remat=True,
        kv_cache_dtype="int8")


def smoke_config() -> LMConfig:
    return LMConfig(
        name="grok-1-314b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256, moe_experts=4, moe_top_k=2,
        dtype=torch.float32)
