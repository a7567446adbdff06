"""Parameter specs: shapes + logical sharding axes for every architecture.

Counterpart of `repro.models.params`. The spec tree is the single source of
truth used by
  * init_params (real initialization, from a `torch.Generator`),
  * the analytic parameter counts (cross-checked against the reference's in
    the tests),
  * `lm_params_from_reference`'s layout (`repro_torch.convert`).

Every block kind's specs are here (GQA, local attention, MLA, FFN, MoE,
RG-LRU and SSD), and `models.model` runs each of them.

Logical axis vocabulary (the reference maps it onto a mesh; on one card it
names dims and nothing more):
  vocab, embed, heads, kv, head, ff, experts, eff, inner, state, layers, lora
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig

VOCAB_PAD_MULTIPLE = 128


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    logical: tuple[str | None, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"        # normal | zeros | ones | lru_lambda | ssd_alog | ssd_dt
    fan_in_axes: tuple[int, ...] = (0,)  # axes whose product is fan-in

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes {self.logical} differ in rank")


def padded_vocab(cfg: ArchConfig) -> int:
    v = cfg.vocab_size
    return ((v + VOCAB_PAD_MULTIPLE - 1) // VOCAB_PAD_MULTIPLE) * VOCAB_PAD_MULTIPLE


# ---------------------------------------------------------------------------
# layer plan: RLE segments of identical layer kinds (stacked units)
# ---------------------------------------------------------------------------


def layer_kind(cfg: ArchConfig, i: int) -> str:
    """'mixer+channel' kind string for layer i."""
    pattern = cfg.block_pattern
    mixer = pattern[i % len(pattern)]
    if mixer == "attn":
        mixer = cfg.attn_type  # gqa | mla
    if mixer in ("ssd",):
        return mixer  # ssd blocks have no separate channel mixer
    channel = "ffn"
    if cfg.moe is not None:
        m = cfg.moe
        if i >= m.moe_layer_start and (i - m.moe_layer_start) % m.moe_layer_period == 0:
            channel = "moe"
    return f"{mixer}+{channel}"


def layer_plan(cfg: ArchConfig) -> list[tuple[tuple[str, ...], int]]:
    """[(unit_kinds, repeats), ...] — each segment stacks `repeats` copies of
    the `unit_kinds` block sequence."""
    kinds = [layer_kind(cfg, i) for i in range(cfg.n_layers)]
    period = len(cfg.block_pattern)
    segments: list[tuple[tuple[str, ...], int]] = []
    i = 0
    while i < len(kinds):
        best_unit, best_cover = (kinds[i],), 1
        for p in {1, period}:
            unit = tuple(kinds[i : i + p])
            if len(unit) < p:
                continue
            r = 1
            while kinds[i + r * p : i + (r + 1) * p] == list(unit):
                r += 1
            if r * p > best_cover:
                best_unit, best_cover = unit, r * p
        segments.append((best_unit, best_cover // len(best_unit)))
        i += best_cover
    return segments


# ---------------------------------------------------------------------------
# per-block specs
# ---------------------------------------------------------------------------


def _attn_specs(cfg: ArchConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    s = {
        "ln": ParamSpec((d,), ("embed",), init="ones"),
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head")),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv", "head")),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv", "head")),
        "wo": ParamSpec((h, hd, d), ("heads", "head", "embed"), fan_in_axes=(0, 1)),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((h, hd), ("heads", "head"), init="zeros")
        s["bk"] = ParamSpec((kv, hd), ("kv", "head"), init="zeros")
        s["bv"] = ParamSpec((kv, hd), ("kv", "head"), init="zeros")
    return s


def _mla_specs(cfg: ArchConfig) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.nope_head_dim + m.rope_head_dim
    return {
        "ln": ParamSpec((d,), ("embed",), init="ones"),
        "wq_a": ParamSpec((d, m.q_lora_rank), ("embed", "lora")),
        "q_norm": ParamSpec((m.q_lora_rank,), ("lora",), init="ones"),
        "wq_b": ParamSpec((m.q_lora_rank, h, qk), ("lora", "heads", "head")),
        "wkv_a": ParamSpec((d, m.kv_lora_rank + m.rope_head_dim), ("embed", "lora")),
        "kv_norm": ParamSpec((m.kv_lora_rank,), ("lora",), init="ones"),
        "wk_b": ParamSpec((m.kv_lora_rank, h, m.nope_head_dim), ("lora", "heads", "head")),
        "wv_b": ParamSpec((m.kv_lora_rank, h, m.v_head_dim), ("lora", "heads", "head")),
        "wo": ParamSpec((h, m.v_head_dim, d), ("heads", "head", "embed"), fan_in_axes=(0, 1)),
    }


def _ffn_specs(cfg: ArchConfig, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    s = {
        "ln": ParamSpec((d,), ("embed",), init="ones"),
        "wi": ParamSpec((d, f), ("embed", "ff")),
        "wo": ParamSpec((f, d), ("ff", "embed")),
    }
    if cfg.ffn_act == "swiglu":
        s["wg"] = ParamSpec((d, f), ("embed", "ff"))
    return s


def _moe_specs(cfg: ArchConfig) -> dict:
    m = cfg.moe
    d, e, fe = cfg.d_model, m.num_experts, m.d_ff_expert
    s = {
        "ln": ParamSpec((d,), ("embed",), init="ones"),
        "router": ParamSpec((d, e), ("embed", None), dtype=torch.float32),
        "w_in": ParamSpec((e, d, fe), ("experts", "embed", "eff")),
        "w_out": ParamSpec((e, fe, d), ("experts", "eff", "embed"), fan_in_axes=(1,)),
    }
    if cfg.ffn_act == "swiglu":
        s["w_gate"] = ParamSpec((e, d, fe), ("experts", "embed", "eff"))
    if m.n_shared:
        fs = m.d_ff_shared * m.n_shared
        s["ws_in"] = ParamSpec((d, fs), ("embed", "ff"))
        s["ws_out"] = ParamSpec((fs, d), ("ff", "embed"))
        if cfg.ffn_act == "swiglu":
            s["ws_gate"] = ParamSpec((d, fs), ("embed", "ff"))
    return s


def _rglru_specs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    conv_w = cfg.ssm.conv_width if cfg.ssm else 4
    f32 = torch.float32
    return {
        "ln": ParamSpec((d,), ("embed",), init="ones"),
        "w_x": ParamSpec((d, d), ("embed", "inner")),
        "w_gate": ParamSpec((d, d), ("embed", "inner")),
        "conv": ParamSpec((conv_w, d), (None, "inner"), init="normal"),
        "lam": ParamSpec((d,), ("inner",), init="lru_lambda", dtype=f32),
        "wa": ParamSpec((d,), ("inner",), init="zeros", dtype=f32),
        "ba": ParamSpec((d,), ("inner",), init="zeros", dtype=f32),
        "wi_g": ParamSpec((d,), ("inner",), init="zeros", dtype=f32),
        "bi_g": ParamSpec((d,), ("inner",), init="zeros", dtype=f32),
        "w_out": ParamSpec((d, d), ("inner", "embed")),
    }


def _ssd_specs(cfg: ArchConfig) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    h = d_in // s.head_dim
    gn = s.n_groups * s.state_dim
    conv_dim = d_in + 2 * gn
    f32 = torch.float32
    return {
        "ln": ParamSpec((d,), ("embed",), init="ones"),
        # in_proj packs [z(d_in), x(d_in), B(gn), C(gn), dt(h)]
        "w_in": ParamSpec((d, 2 * d_in + 2 * gn + h), ("embed", "inner")),
        "conv": ParamSpec((s.conv_width, conv_dim), (None, "inner")),
        "a_log": ParamSpec((h,), (None,), init="ssd_alog", dtype=f32),
        "dt_bias": ParamSpec((h,), (None,), init="ssd_dt", dtype=f32),
        "skip_d": ParamSpec((h,), (None,), init="ones", dtype=f32),
        "gnorm": ParamSpec((d_in,), ("inner",), init="ones"),
        "w_out": ParamSpec((d_in, d), ("inner", "embed")),
    }


_MIXER_SPECS = {
    "gqa": _attn_specs,
    "local_attn": _attn_specs,
    "mla": _mla_specs,
    "rglru": _rglru_specs,
    "ssd": _ssd_specs,
}


def block_specs(cfg: ArchConfig, kind: str) -> dict:
    """Spec tree for one layer of the given kind ('mixer+channel' or 'ssd')."""
    if kind == "ssd":
        return {"mixer": _ssd_specs(cfg)}
    mixer, channel = kind.split("+")
    out = {"mixer": _MIXER_SPECS[mixer](cfg)}
    if channel == "ffn":
        out["channel"] = _ffn_specs(cfg)
    elif channel == "moe":
        out["channel"] = _moe_specs(cfg)
    return out


def _stack(spec: ParamSpec, n: int) -> ParamSpec:
    return ParamSpec(
        (n, *spec.shape), ("layers", *spec.logical), spec.dtype, spec.init,
        tuple(a + 1 for a in spec.fan_in_axes),
    )


def param_specs(cfg: ArchConfig) -> dict:
    """Full spec tree: embedding, segments (stacked), final norm, head."""
    d = cfg.d_model
    v = padded_vocab(cfg)
    specs: dict = {
        "embed": ParamSpec((v, d), ("vocab", "embed"), fan_in_axes=(1,)),
        "final_norm": ParamSpec((d,), ("embed",), init="ones"),
    }
    if cfg.frontend:
        specs["frontend_proj"] = ParamSpec((cfg.frontend_dim, d), (None, "embed"))
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, v), ("embed", "vocab"))
    if cfg.mtp_heads:
        specs["mtp_head"] = ParamSpec((d, v), ("embed", "vocab"))
    segs = []
    for unit, repeats in layer_plan(cfg):
        blocks = [_map_specs(lambda s, r=repeats: _stack(s, r), block_specs(cfg, kind))
                  for kind in unit]
        segs.append({"kinds": unit, "repeats": repeats, "blocks": blocks})
    specs["segments"] = segs
    return specs


# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------


def _uniform(shape, lo: float, hi: float, generator: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return u * (hi - lo) + lo


def _init_leaf(spec: ParamSpec, generator: torch.Generator, device) -> torch.Tensor:
    """One leaf, by the reference's rule for its `init` (`_init_leaf`); the
    draws come from `generator`, on `device`."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "lru_lambda":
        # Griffin: a = sigmoid(Lambda) with a^c in [0.9, 0.999]
        a_c = _uniform(spec.shape, 0.9, 0.999, generator, device) ** (1.0 / 8.0)
        return torch.log(a_c / (1 - a_c)).to(spec.dtype)
    if spec.init == "ssd_alog":
        return torch.log(_uniform(spec.shape, 1.0, 16.0, generator, device)).to(spec.dtype)
    if spec.init == "ssd_dt":
        u = _uniform(spec.shape, 1e-3, 1e-1, generator, device)
        # inverse softplus
        return (u + torch.log(-torch.expm1(-u))).to(spec.dtype)
    fan_in = int(np.prod([spec.shape[a] for a in spec.fan_in_axes]))
    std = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(spec.shape, generator=generator, device=device, dtype=torch.float32)
    return w.mul_(std).to(spec.dtype)


def _map_specs(fn, specs):
    """Maps fn over the spec tree's leaves (segments hold dicts with the
    non-spec keys `kinds` and `repeats`, which the result drops)."""
    if isinstance(specs, ParamSpec):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items() if k not in ("kinds", "repeats")}
    if isinstance(specs, list):
        return [_map_specs(fn, v) for v in specs]
    raise TypeError(type(specs))


def init_params(cfg: ArchConfig, generator: torch.Generator, dtype=torch.bfloat16,
                device="cuda") -> dict:
    """Random parameters for cfg: every bf16 leaf of the spec tree in
    `dtype`, the f32 ones in f32. The draws come from `generator` (a
    torch.Generator on `device`) in the spec tree's order; they cannot equal
    `jax.random`'s, so parity with the reference runs on weights carried
    across (`repro_torch.convert.lm_params_from_reference`)."""

    def mk(spec: ParamSpec):
        if spec.dtype == torch.bfloat16:
            spec = ParamSpec(spec.shape, spec.logical, dtype, spec.init, spec.fan_in_axes)
        return _init_leaf(spec, generator, device)

    return _map_specs(mk, param_specs(cfg))


def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    """Analytic parameter count from the spec tree. With active_only, MoE
    expert params count only top_k/num_experts of routed experts (6*N_active
    roofline convention)."""
    specs = param_specs(cfg)
    total = 0

    def add(path_is_expert: bool, s: ParamSpec):
        n = int(np.prod(s.shape))
        if active_only and path_is_expert and cfg.moe:
            n = int(n * cfg.moe.top_k / cfg.moe.num_experts)
        return n

    def walk(tree, expert=False):
        nonlocal total
        if isinstance(tree, ParamSpec):
            total += add(expert, tree)
            return
        if isinstance(tree, dict):
            for k, v in tree.items():
                if k in ("kinds", "repeats"):
                    continue
                walk(v, expert or k in ("w_in", "w_out", "w_gate"))
            return
        if isinstance(tree, list):
            for v in tree:
                walk(v)

    walk(specs)
    return total
