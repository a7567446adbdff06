"""MusicGen-Large: decoder-only transformer over EnCodec tokens.

48L d_model=2048 32H (GQA kv=32, i.e. full MHA) d_ff=8192 vocab=2048
[arXiv:2306.05284; hf]. The EnCodec frontend is a stub: input_specs()
provides precomputed frame embeddings (DESIGN.md §Arch-applicability).
"""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="musicgen_large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=2048,
        ffn_act="gelu",          # MusicGen uses standard transformer FFN
        frontend="audio_frames",
        frontend_dim=128,        # EnCodec latent frame dim (stub)
        source="arXiv:2306.05284; hf",
    )


def smoke() -> ArchConfig:
    return config().with_overrides(
        name="musicgen_large_smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=256, vocab_size=128, frontend_dim=16,
    )
