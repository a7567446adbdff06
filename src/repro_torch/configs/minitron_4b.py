"""Minitron-4B: pruned Nemotron (squared-ReLU FFN, GQA).

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000
[arXiv:2407.14679; hf].
"""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="minitron_4b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_ff=9216,
        vocab_size=256_000,
        ffn_act="squared_relu",
        source="arXiv:2407.14679; hf",
    )


def smoke() -> ArchConfig:
    return config().with_overrides(
        name="minitron_4b_smoke", n_layers=2, d_model=96, n_heads=6,
        n_kv_heads=2, d_ff=288, vocab_size=512,
    )
