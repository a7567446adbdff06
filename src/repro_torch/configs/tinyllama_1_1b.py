"""TinyLlama-1.1B: llama2-architecture small model.

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000 [arXiv:2401.02385; hf].
"""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="tinyllama_1_1b",
        family="dense",
        n_layers=22,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        d_ff=5632,
        vocab_size=32_000,
        ffn_act="swiglu",
        source="arXiv:2401.02385; hf",
    )


def smoke() -> ArchConfig:
    return config().with_overrides(
        name="tinyllama_1_1b_smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=160, vocab_size=256,
    )
