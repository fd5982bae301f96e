"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]:
24L d1024 16H (GQA kv=8) d_ff=512/expert vocab=49155, MoE 32e top-8."""
import torch

from repro_torch.models.transformer import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="granite-moe-1b-a400m", n_layers=24, d_model=1024, n_heads=16,
        n_kv_heads=8, d_ff=512, vocab=49155,
        moe_experts=32, moe_top_k=8, tied_embed=True,
        dtype=torch.bfloat16, remat=True, kv_cache_dtype="bf16",
        train_layout="dp_only")


def smoke_config() -> LMConfig:
    return LMConfig(
        name="granite-moe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=32, vocab=256, moe_experts=8, moe_top_k=4,
        tied_embed=True, dtype=torch.float32)
