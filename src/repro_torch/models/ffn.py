"""Channel mixers: the dense FFN variants (plain PyTorch).

Counterpart of `repro.models.ffn`'s dense part: `_act` and `ffn_forward`
without explicit tensor parallelism (one card). The expert-parallel MoE
(`moe_forward`, `_moe_decode_gather`) waits for ROADMAP queue 1 item 11(b).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import rmsnorm


def _act(cfg: ArchConfig, gate_or_pre: torch.Tensor, pre: torch.Tensor | None = None):
    if cfg.ffn_act == "swiglu":
        return F.silu(gate_or_pre) * pre
    if cfg.ffn_act == "squared_relu":
        r = F.relu(gate_or_pre)
        return r * r
    if cfg.ffn_act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(gate_or_pre, approximate="tanh")
    raise ValueError(cfg.ffn_act)


def ffn_forward(params: dict, x: torch.Tensor, cfg: ArchConfig, rt=None) -> torch.Tensor:
    """Pre-norm dense FFN: rmsnorm, up (and gate) projection, activation,
    down projection. rt is taken for the reference's signature; one card
    has no tensor-parallel form (`Runtime` refuses explicit_tp)."""
    del rt
    h = rmsnorm(x, params["ln"], cfg.norm_eps)
    pre = torch.einsum("bsd,df->bsf", h, params["wi"])
    if cfg.ffn_act == "swiglu":
        act = _act(cfg, torch.einsum("bsd,df->bsf", h, params["wg"]), pre)
    else:
        act = _act(cfg, pre)
    return torch.einsum("bsf,fd->bsd", act, params["wo"])
