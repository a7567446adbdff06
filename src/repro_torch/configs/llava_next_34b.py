"""LLaVA-NeXT-34B: VLM backbone (anyres tiling frontend is a stub).

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000
[hf:llava-hf/llava-v1.6 family; unverified]. The vision tower + anyres patch
projection is stubbed: input_specs() provides precomputed patch embeddings.
"""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="llava_next_34b",
        family="vlm",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=20_480,
        vocab_size=64_000,
        rope_theta=5_000_000.0,
        ffn_act="swiglu",
        frontend="vision_patches",
        frontend_dim=1152,    # SigLIP-style patch embedding dim (stub)
        source="hf:llava-hf/llava-v1.6-34b; unverified",
    )


def smoke() -> ArchConfig:
    return config().with_overrides(
        name="llava_next_34b_smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=192, vocab_size=512, frontend_dim=32,
    )
