"""DeepSeek-V3-671B: MLA attention + fine-grained MoE (1 shared + 256 routed
top-8) + MTP.

61L d_model=7168 128H (MLA) d_ff(expert)=2048 vocab=129280, first 3 layers
dense (d_ff=18432) [arXiv:2412.19437; hf].
"""

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek_v3_671b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,       # MLA: per-head latent expansion
        d_ff=18_432,          # dense-layer FFN width (first 3 layers)
        vocab_size=129_280,
        attn_type="mla",
        mla=MLAConfig(
            q_lora_rank=1536,
            kv_lora_rank=512,
            rope_head_dim=64,
            nope_head_dim=128,
            v_head_dim=128,
        ),
        ffn_act="swiglu",
        moe=MoEConfig(
            num_experts=256,
            top_k=8,
            d_ff_expert=2048,
            n_shared=1,
            d_ff_shared=2048,
            moe_layer_start=3,     # layers 0-2 are dense
            capacity_factor=1.25,
        ),
        mtp_heads=1,
        source="arXiv:2412.19437; hf",
    )


def smoke() -> ArchConfig:
    return config().with_overrides(
        name="deepseek_v3_671b_smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=192, vocab_size=512,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, rope_head_dim=8,
                      nope_head_dim=16, v_head_dim=16),
        # generous capacity so smoke-scale token counts never overflow
        # (capacity drops are train-path-only semantics; the prefill/decode
        # consistency tests need drop-free routing at tiny T)
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64, n_shared=1,
                      d_ff_shared=64, moe_layer_start=1, capacity_factor=8.0),
    )
