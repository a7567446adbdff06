"""Mamba2-1.3B: attention-free SSM with state-space duality (SSD).

48L d_model=2048 vocab=50280, ssm_state=128 [arXiv:2405.21060; unverified].
Sub-quadratic -> runs the long_500k shape. Mamba2 blocks replace both
attention and FFN (d_ff=0 per the assignment).
"""

from repro_torch.configs.base import ArchConfig, SSMConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="mamba2_1_3b",
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=64,           # SSD heads: expand*d_model / head_dim
        n_kv_heads=0,
        d_ff=0,               # attention-free, FFN-free (SSD block only)
        vocab_size=50_280,
        attn_type="none",
        block_pattern=("ssd",),
        ssm=SSMConfig(state_dim=128, head_dim=64, n_groups=1, conv_width=4,
                      expand=2, chunk=128),
        source="arXiv:2405.21060; unverified",
    )


def smoke() -> ArchConfig:
    return config().with_overrides(
        name="mamba2_1_3b_smoke", n_layers=2, d_model=64, n_heads=4,
        vocab_size=256,
        ssm=SSMConfig(state_dim=16, head_dim=32, n_groups=1, conv_width=4,
                      expand=2, chunk=16),
    )
