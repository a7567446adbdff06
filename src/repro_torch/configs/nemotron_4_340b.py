"""Nemotron-4-340B: dense GQA with squared-ReLU FFN.

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000
[arXiv:2402.16819; unverified].
"""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="nemotron_4_340b",
        family="dense",
        n_layers=96,
        d_model=18_432,
        n_heads=96,
        n_kv_heads=8,
        d_ff=73_728,
        vocab_size=256_000,
        ffn_act="squared_relu",
        source="arXiv:2402.16819; unverified",
    )


def smoke() -> ArchConfig:
    return config().with_overrides(
        name="nemotron_4_340b_smoke", n_layers=2, d_model=96, n_heads=6,
        n_kv_heads=2, d_ff=384, vocab_size=512,
    )
