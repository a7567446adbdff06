"""Qwen2.5-32B: dense GQA with QKV bias.

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064
[hf:Qwen/Qwen2.5-0.5B family config; hf].
"""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2_5_32b",
        family="dense",
        n_layers=64,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=27_648,
        vocab_size=152_064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        ffn_act="swiglu",
        source="hf:Qwen/Qwen2.5-32B; hf",
    )


def smoke() -> ArchConfig:
    return config().with_overrides(
        name="qwen2_5_32b_smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=192, vocab_size=512,
    )
