"""codeqwen1.5-7b [hf:Qwen/CodeQwen1.5-7B; hf]: 32L d4096 32H (kv=32 MHA)
d_ff=13440 vocab=92416, qwen1.5 arch (QKV bias)."""
import torch

from repro_torch.models.transformer import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="codeqwen1.5-7b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=32, d_ff=13440, vocab=92416, qkv_bias=True,
        rope_theta=1e6, dtype=torch.bfloat16, remat=True,
        kv_cache_dtype="bf16")


def smoke_config() -> LMConfig:
    # head width 12: the flash kernels are not built for it, so this
    # config runs on the CPU (the kernels' plain twins) only
    return LMConfig(
        name="codeqwen1.5-7b-smoke", n_layers=2, d_model=48, n_heads=4,
        n_kv_heads=4, d_ff=96, vocab=128, qkv_bias=True,
        dtype=torch.float32)
