"""Channel mixers: the dense FFN variants and the capacity MoE (plain
PyTorch), off a mesh and on one.

Counterpart of `repro.models.ffn`. Off a mesh (`Runtime.mesh` None),
`moe_forward` is the body of the reference's `shard_map` with one rank:
every expert is local (e_loc = E), the FSDP all-gathers are the identity
and so is the psum over 'model'. On a mesh it is that body on this rank's
shards (`_moe_mesh`): the rank routes its own batch rows, with the
capacity of its dp shard's tokens (`_capacity(max(b * s // dp_size, 1))`,
so routes drop per dp shard, as in the reference); it keeps e_loc = E /
tp_size experts, whose weights are gathered over dp (ZeRO-3), and the
scatter is summed over 'model'. `_moe_decode_gather` is the reference's
weights-stationary decode: the tokens travel, the weights stay.

Capacity semantics: each expert takes at most `_capacity(t)` of the routes
to it, the highest combine weights first; the overflow drops. Ties (with
top-1 routing every weight is exactly 1.0) go to the lowest token index, as
`jax.lax.top_k` breaks them, through a stable descending sort; the router's
top-k over experts is chosen the same way. `moe_dropped` gives the dropped
(token, expert) routes of the same selection.

The dense FFN and the shared experts split over 'ff' on a mesh whose
'model' ranks divide it (`dist.tp`'s column and row products: this rank's
f columns, the down product summed over 'model'), as GSPMD splits them
under the reference's specs.

Weights come as full tensors (off a mesh) or as DTensors
(`dist.sharding.distribute_params`), whose shards each path takes as it
needs them (`dist.sharding.at_use`, `full`, `dist.tp.model_slice`).
Gradients cross the collectives by `dist.comm`'s rules.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import comm
from repro_torch.dist.sharding import P, at_use, full, is_dtensor, placements, tp_split, window
from repro_torch.dist.tp import col_matmul_ffn, model_slice, row_matmul_ffn
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


def _dense(params: dict, h: torch.Tensor, cfg: ArchConfig, rt, keys: tuple) -> torch.Tensor:
    """The up (and gate) projection, activation and down projection of the
    normed input h, under keys (up, gate, down). On a mesh whose 'model'
    ranks divide f (and under rt.explicit_tp) the products are
    `dist.tp`'s, on this rank's f columns; otherwise the plain products
    on the whole weights, gathered at use."""
    up, gate, down = keys
    f = params[up].shape[-1]
    if rt is not None and rt.distributed and (rt.explicit_tp or tp_split(rt, f)):
        pre = col_matmul_ffn(h, params[up], rt)
        if cfg.ffn_act == "swiglu":
            act = _act(cfg, col_matmul_ffn(h, params[gate], rt), pre)
        else:
            act = _act(cfg, pre)
        return row_matmul_ffn(act, params[down], rt)
    pre = torch.einsum("bsd,df->bsf", h, at_use(params[up], rt))
    if cfg.ffn_act == "swiglu":
        act = _act(cfg, torch.einsum("bsd,df->bsf", h, at_use(params[gate], rt)), pre)
    else:
        act = _act(cfg, pre)
    return torch.einsum("bsf,fd->bsd", act, at_use(params[down], rt))


def ffn_forward(params: dict, x: torch.Tensor, cfg: ArchConfig, rt=None) -> torch.Tensor:
    """Pre-norm dense FFN: rmsnorm, up (and gate) projection, activation,
    down projection; split over 'ff' on a mesh (`_dense`; reference
    `ffn.py:48`)."""
    h = rmsnorm(x, at_use(params["ln"], rt), cfg.norm_eps)
    return _dense(params, h, cfg, rt, ("wi", "wg", "wo"))


def _shared_expert(params: dict, h: torch.Tensor, cfg: ArchConfig, rt=None) -> torch.Tensor:
    return _dense(params, h, cfg, rt, ("ws_in", "ws_gate", "ws_out"))


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
    pairs. On a mesh, h is one dp shard's rows: its drops are the mesh
    body's for that shard."""
    xt = h.reshape(-1, h.shape[-1])
    gate = _route(full(params["router"]), xt, cfg)
    top_gate, top_idx = _select(gate, _capacity(xt.shape[0], cfg))
    kept = torch.zeros_like(gate, dtype=torch.bool)
    e_ids = torch.arange(gate.shape[1], device=gate.device)[:, None].expand_as(top_idx)
    kept[top_idx[top_gate > 0], e_ids[top_gate > 0]] = True
    return (gate > 0) & ~kept


def _experts(params: dict, cfg: ArchConfig, xe_in: torch.Tensor, pre_sum=None):
    """The expert FFNs on gathered tokens xe_in (e_loc, cap, d): the up
    (and gate) products, each passed through pre_sum when given, the
    activation, and the down product -> (e_loc, cap, d_out)."""
    def up(w):
        y = torch.einsum("ecd,edf->ecf", xe_in, w)
        return y if pre_sum is None else pre_sum(y)

    pre = up(params["w_in"])
    if cfg.ffn_act == "swiglu":
        act = F.silu(up(params["w_gate"])) * pre
    else:
        act = _act(cfg, pre)
    return torch.einsum("ecf,efd->ecd", act, params["w_out"])


def _combine(ye: torch.Tensor, top_gate: torch.Tensor, top_idx: torch.Tensor, t: int):
    """Each expert output weighted by its gate (padding slots by 0) and
    scatter-added into its token's row (`index_add_`, in ye's dtype)."""
    w_comb = torch.where(top_gate > 0, top_gate, 0.0).to(ye.dtype)
    ye = ye * w_comb[:, :, None]
    return torch.zeros((t, ye.shape[-1]), dtype=ye.dtype, device=ye.device).index_add_(
        0, top_idx.reshape(-1), ye.reshape(-1, ye.shape[-1]))


def _moe_local(params: dict, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The body with one rank: every expert, capacity `_capacity(B * S)`."""
    b, s, d = h.shape
    t = b * s
    xt = h.reshape(t, d)
    top_gate, top_idx = _select(_route(params["router"], xt, cfg), _capacity(t, cfg))
    e, cap = top_idx.shape
    ye = _experts(params, cfg, xt[top_idx.reshape(-1)].reshape(e, cap, d))
    return _combine(ye, top_gate, top_idx, t).reshape(b, s, d)


def _expert_block(w, rt, spec: P) -> torch.Tensor:
    """This rank's block of an expert weight under `spec`: a DTensor placed
    so gives its local shard (no collective), any other is taken whole
    (`full`) and sliced, as a view of a full tensor."""
    if is_dtensor(w) and tuple(w.placements) == placements(spec, rt.mesh):
        return w.to_local()
    w = at_use(w, rt)
    return w[window(tuple(w.shape), spec, rt)]


def _e_loc(cfg: ArchConfig, rt) -> int:
    e = cfg.moe.num_experts
    if e % rt.tp_size:
        raise ValueError(f"{e} experts do not divide over {rt.tp_size} 'model' ranks")
    return e // rt.tp_size


def _moe_mesh(params: dict, h: torch.Tensor, cfg: ArchConfig, rt) -> torch.Tensor:
    """The reference's expert-parallel `shard_map` body (:164-230) on this
    rank: its batch rows h (B_loc, S, d) routed by the full router, capacity
    `_capacity(B_loc * S)` per local expert, this 'model' rank's e_loc
    experts with their d gathered over dp, the scatter summed over 'model'.
    Under full_dp (no 'model' split) every expert is local and nothing is
    summed."""
    b, s, d = h.shape
    t = b * s
    tp = (rt.tp_axis,)
    split = not rt.full_dp
    xt = h.reshape(t, d)
    router = at_use(params["router"], rt)
    if split:
        xt, router = comm.copy_to(xt, rt, tp), comm.copy_to(router, rt, tp)
    e_loc = _e_loc(cfg, rt)
    lo = rt.tp_rank * e_loc
    gate = _route(router, xt, cfg)[:, lo:lo + e_loc]
    top_gate, top_idx = _select(gate, _capacity(max(t, 1), cfg))
    cap = top_idx.shape[1]
    w = {k: model_slice(params[k], rt, 0) for k in ("w_in", "w_gate", "w_out") if k in params}
    ye = _experts(w, cfg, xt[top_idx.reshape(-1)].reshape(e_loc, cap, d))
    out = _combine(ye, top_gate, top_idx, t)
    if split:
        out = comm.reduce_from(out, rt, tp)
    return out.reshape(b, s, d)


def _moe_decode_gather(params: dict, h: torch.Tensor, cfg: ArchConfig, rt) -> torch.Tensor:
    """Weights-stationary decode MoE (reference :79-161). h: this rank's
    normed rows (B_loc, 1, d). The tokens are all-gathered over dp; this
    rank applies its (e_loc, d / dp, f) weight shards, the d contraction
    completed by a sum over dp; the capacity is the decode's generous
    min(t, max(16, int(t * top_k / E * max(cf, 2)) + 8)); the (t, d / dp)
    partial outputs are summed over 'model' and return to the batch layout
    by one all-to-all over dp. No weight moves. The shared experts are the
    caller's (`moe_forward`)."""
    m = cfg.moe
    b, s, d = h.shape
    dp, tp = rt.dp_axes, (rt.tp_axis,)
    n_dp = rt.dp_size
    if d % n_dp:
        raise ValueError(f"d_model {d} does not divide over {n_dp} dp ranks")
    x = comm.gather_grad(comm.copy_to(h, rt, tp), rt, dp, 0)
    t = x.shape[0]
    xt = x.reshape(t, d)
    e_loc = _e_loc(cfg, rt)
    lo = rt.tp_rank * e_loc
    router = comm.copy_to(at_use(params["router"], rt), rt, tp)
    gate = _route(router, xt, cfg)[:, lo:lo + e_loc]
    cap = min(t, max(16, int(t * m.top_k / m.num_experts * max(m.capacity_factor, 2.0)) + 8))
    top_gate, top_idx = _select(gate, cap)
    dps = dp if len(dp) > 1 else dp[0]
    w = {k: _expert_block(params[k], rt, P(rt.tp_axis, dps, None))
         for k in ("w_in", "w_gate") if k in params}
    w["w_out"] = _expert_block(params["w_out"], rt, P(rt.tp_axis, None, dps))
    d_loc = d // n_dp
    xe = xt[top_idx.reshape(-1)].reshape(e_loc, cap, d)
    xe_loc = xe[:, :, rt.dp_rank * d_loc:(rt.dp_rank + 1) * d_loc]
    ye = _experts(w, cfg, xe_loc, pre_sum=lambda y: comm.sum_grad(y, rt, dp))
    out = comm.reduce_from(_combine(ye, top_gate, top_idx, t), rt, tp)   # (t, d_loc)
    # (t, d_loc) -> (t_loc, d): one all-to-all, blocks indexed by d slice
    ex = comm.all_to_all(out.reshape(n_dp, t // n_dp, d_loc), rt, dp)
    return ex.movedim(0, 1).reshape(t // n_dp, 1, d)


def moe_forward(params: dict, x: torch.Tensor, cfg: ArchConfig, rt=None) -> torch.Tensor:
    """Capacity MoE (+ the shared experts), pre-norm. x: (B, S, d), this
    rank's batch rows on a mesh.

    Off a mesh: route every token (`_route`), keep each expert's top
    `_capacity(B * S)` routes (`_select`), run the experts as batched
    products over (E, cap) gathered tokens, weight each output by its gate
    and scatter-add into the tokens' rows. On a mesh, `_moe_mesh`; with
    rt.moe_decode_gather, a decode step (S == 1) and dp_size > 1,
    `_moe_decode_gather` (reference :169)."""
    m = cfg.moe
    h = rmsnorm(x, at_use(params["ln"], rt), cfg.norm_eps)
    if rt is None or not rt.distributed:
        out = _moe_local(params, h, cfg)
    elif rt.moe_decode_gather and h.shape[1] == 1 and rt.dp_size > 1:
        out = _moe_decode_gather(params, h, cfg, rt)
    else:
        out = _moe_mesh(params, h, cfg, rt)
    if m.n_shared:
        out = out + _shared_expert(params, h, cfg, rt)
    return out
