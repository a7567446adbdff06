"""Llama-4-Scout-17B-16E: MoE top-1 with shared expert, interleaved MoE
layers, early fusion.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].
"""

from repro_torch.configs.base import ArchConfig, MoEConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="llama4_scout_17b_a16e",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=8192,            # dense-layer / shared-path FFN width
        vocab_size=202_048,
        rope_theta=500_000.0,
        ffn_act="swiglu",
        moe=MoEConfig(
            num_experts=16,
            top_k=1,
            d_ff_expert=8192,
            n_shared=1,
            d_ff_shared=8192,
            moe_layer_start=0,
            moe_layer_period=1,   # every layer is MoE in Scout
            capacity_factor=1.25,
        ),
        source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
    )


def smoke() -> ArchConfig:
    return config().with_overrides(
        name="llama4_scout_smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=512,
        # generous smoke capacity: see deepseek smoke config note
        moe=MoEConfig(num_experts=4, top_k=1, d_ff_expert=128, n_shared=1,
                      d_ff_shared=128, capacity_factor=8.0),
    )
