"""Channel mixers: the dense FFN variants and the capacity MoE (plain
PyTorch).

Counterpart of `repro.models.ffn` on one card: `ffn_forward` without
explicit tensor parallelism, and `moe_forward` as the body of the
reference's `shard_map` with one rank: every expert is local (e_loc = E),
the FSDP all-gathers are the identity and so is the psum over 'model'.

Capacity semantics: each expert takes at most `_capacity(t)` of the routes
to it, the highest combine weights first; the overflow drops. Ties (with
top-1 routing every weight is exactly 1.0) go to the lowest token index, as
`jax.lax.top_k` breaks them, through a stable descending sort; the router's
top-k over experts is chosen the same way. `moe_dropped` gives the dropped
(token, expert) routes of the same selection.
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


def _shared_expert(params: dict, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    pre = torch.einsum("bsd,df->bsf", h, params["ws_in"])
    if cfg.ffn_act == "swiglu":
        act = _act(cfg, torch.einsum("bsd,df->bsf", h, params["ws_gate"]), pre)
    else:
        act = _act(cfg, pre)
    return torch.einsum("bsf,fd->bsd", act, params["ws_out"])


def _capacity(t: int, cfg: ArchConfig) -> int:
    """Routes an expert takes for t tokens: t * top_k / E * capacity_factor,
    rounded up to a multiple of 8 (at least 8), at most t."""
    m = cfg.moe
    c = int(t * m.top_k / m.num_experts * m.capacity_factor)
    c = max(8, (c + 7) // 8 * 8)
    return min(t, c)


def _top(x: torch.Tensor, k: int):
    """The k largest of each row of x (values, indices), equal values in
    index order: `jax.lax.top_k`'s choice and order, which torch.topk does
    not promise."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(router: torch.Tensor, xt: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The router's combine weights (t, E) in f32: softmax over experts, the
    top_k renormalised to sum to 1, 0 for the experts not chosen."""
    m = cfg.moe
    probs = torch.softmax(torch.einsum("td,de->te", xt.float(), router), dim=-1)
    vals, ids = _top(probs, m.top_k)
    vals = vals / torch.clamp_min(vals.sum(-1, keepdim=True), 1e-9)
    return torch.zeros_like(probs).scatter_(1, ids, vals)


def _select(gate: torch.Tensor, cap: int):
    """Each expert's kept routes: (top_gate, top_idx), both (E, cap). A slot
    with top_gate <= 0 is padding (fewer than cap routes reached it)."""
    return _top(torch.where(gate > 0, gate, -1.0).T, cap)


def moe_dropped(params: dict, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """(t, E) bool: the routes of h's t = B * S tokens (h the normed input,
    (B, S, d)) that `moe_forward`'s capacity drops: routed to an expert that
    kept `_capacity(t)` routes of higher weight, or of equal weight and a
    lower token index. Its sum is the number of dropped (token, expert)
    pairs."""
    xt = h.reshape(-1, h.shape[-1])
    gate = _route(params["router"], xt, cfg)
    top_gate, top_idx = _select(gate, _capacity(xt.shape[0], cfg))
    kept = torch.zeros_like(gate, dtype=torch.bool)
    e_ids = torch.arange(gate.shape[1], device=gate.device)[:, None].expand_as(top_idx)
    kept[top_idx[top_gate > 0], e_ids[top_gate > 0]] = True
    return (gate > 0) & ~kept


def moe_forward(params: dict, x: torch.Tensor, cfg: ArchConfig, rt=None) -> torch.Tensor:
    """Capacity MoE (+ the shared experts), pre-norm. x: (B, S, d).

    The reference's `shard_map` body with one rank: route every token
    (`_route`), keep each expert's top `_capacity(B * S)` routes
    (`_select`), run the experts as batched products over (E, cap) gathered
    tokens, weight each output by its gate (padding slots by 0) and
    scatter-add into the tokens' rows (`index_add_`, in the outputs' dtype).
    rt is taken for the signature: `rt.moe_decode_gather` (the
    weights-stationary decode, `_moe_decode_gather`) runs only with dp_size >
    1, never on one card, so it changes nothing here; its port comes with
    the mesh (ROADMAP queue 1 item 11(c))."""
    del rt
    m = cfg.moe
    h = rmsnorm(x, params["ln"], cfg.norm_eps)
    b, s, d = h.shape
    t = b * s
    xt = h.reshape(t, d)
    top_gate, top_idx = _select(_route(params["router"], xt, cfg), _capacity(t, cfg))
    e, cap = top_idx.shape
    xe = xt[top_idx.reshape(-1)].reshape(e, cap, d)
    pre = torch.einsum("ecd,edf->ecf", xe, params["w_in"])
    if cfg.ffn_act == "swiglu":
        act = F.silu(torch.einsum("ecd,edf->ecf", xe, params["w_gate"])) * pre
    else:
        act = _act(cfg, pre)
    ye = torch.einsum("ecf,efd->ecd", act, params["w_out"])
    w_comb = torch.where(top_gate > 0, top_gate, 0.0).to(ye.dtype)
    ye = ye * w_comb[:, :, None]
    out = torch.zeros((t, d), dtype=ye.dtype, device=ye.device).index_add_(
        0, top_idx.reshape(-1), ye.reshape(-1, d)).reshape(b, s, d)
    if m.n_shared:
        out = out + _shared_expert(params, h, cfg)
    return out
