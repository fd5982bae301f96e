"""qwen1.5-32b [hf:Qwen/Qwen1.5-0.5B family; hf]: 64L d5120 40H (kv=40 MHA)
d_ff=27392 vocab=152064, QKV bias, an int8 KV cache."""
import torch

from repro_torch.models.transformer import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="qwen1.5-32b", n_layers=64, d_model=5120, n_heads=40,
        n_kv_heads=40, d_ff=27392, vocab=152064, qkv_bias=True,
        rope_theta=1e6, dtype=torch.bfloat16, remat=True,
        kv_cache_dtype="int8")


def smoke_config() -> LMConfig:
    return LMConfig(
        name="qwen1.5-32b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=160, vocab=256, qkv_bias=True,
        dtype=torch.float32, kv_cache_dtype="int8")
