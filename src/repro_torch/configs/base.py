"""Config schema for the model zoo + the assigned input-shape grid.

The port's copy of `repro.configs.base`, field for field: the configs are
data, and both packages must describe the same models.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, replace


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # shared (always-on) experts
    d_ff_shared: int = 0         # hidden dim of the shared expert(s)
    moe_layer_start: int = 0     # first MoE layer (earlier layers are dense)
    moe_layer_period: int = 1    # every k-th layer is MoE (llama4 interleave)
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128         # N
    head_dim: int = 64           # P
    n_groups: int = 1            # G (B/C groups)
    conv_width: int = 4
    expand: int = 2
    chunk: int = 128             # SSD chunk length


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None  # None -> d_model // n_heads
    attn_type: str = "gqa"       # gqa | mla | none
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    ffn_act: str = "swiglu"      # swiglu | squared_relu | gelu
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    # per-layer block pattern, cycled: e.g. ("rglru", "rglru", "local_attn")
    block_pattern: tuple[str, ...] = ("attn",)
    local_window: int = 2048
    frontend: str | None = None  # audio_frames | vision_patches | None
    frontend_dim: int = 0        # embedding dim provided by the stub frontend
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    mtp_heads: int = 0           # multi-token-prediction aux heads (DeepSeek)
    source: str = ""             # provenance note

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """True when no block attends to unbounded context (long_500k gate)."""
        return all(b in ("rglru", "ssd", "local_attn") for b in self.block_pattern)

    def param_count(self) -> int:
        """Total parameters (analytic; cross-checked by tests)."""
        from repro_torch.models.params import count_params

        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.params import count_params

        return count_params(self, active_only=True)

    def with_overrides(self, **kw) -> "ArchConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = [
    "musicgen_large",
    "tinyllama_1_1b",
    "qwen2_5_32b",
    "nemotron_4_340b",
    "minitron_4b",
    "recurrentgemma_2b",
    "deepseek_v3_671b",
    "llama4_scout_17b_a16e",
    "mamba2_1_3b",
    "llava_next_34b",
]


def get_arch(name: str, smoke: bool = False) -> ArchConfig:
    """Load an architecture config by id (dashes/dots tolerated)."""
    mod_name = name.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.smoke() if smoke else mod.config()


def list_archs() -> list[str]:
    return list(ARCH_IDS)


def cells(include_skips: bool = False):
    """All (arch, shape) dry-run cells; long_500k only for sub-quadratic."""
    out = []
    for arch_id in ARCH_IDS:
        cfg = get_arch(arch_id)
        for shape in SHAPES.values():
            skip = shape.name == "long_500k" and not cfg.sub_quadratic
            if skip and not include_skips:
                continue
            out.append((arch_id, shape.name, skip))
    return out
