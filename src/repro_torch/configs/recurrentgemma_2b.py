"""RecurrentGemma-2B (Griffin): RG-LRU recurrent blocks + local attention, 1:2.

26L d_model=2560 10H (GQA kv=1, MQA) d_ff=7680 vocab=256000
[arXiv:2402.19427; hf]. Pattern: (recurrent, recurrent, local_attn) cycled.
Sub-quadratic -> runs the long_500k shape.
"""

from repro_torch.configs.base import ArchConfig, SSMConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma_2b",
        family="hybrid",
        n_layers=26,          # 26 blocks: pattern cycles rglru,rglru,local
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        d_ff=7680,
        vocab_size=256_000,
        ffn_act="swiglu",     # GeGLU in the paper; gated family
        block_pattern=("rglru", "rglru", "local_attn"),
        local_window=2048,
        ssm=SSMConfig(state_dim=0, head_dim=0, conv_width=4),  # conv width for rec block
        source="arXiv:2402.19427; hf",
    )


def smoke() -> ArchConfig:
    return config().with_overrides(
        name="recurrentgemma_2b_smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=1, d_ff=192, vocab_size=256, local_window=32,
    )
