"""Recurrent sequence mixers: RG-LRU (Griffin / RecurrentGemma) and Mamba2
SSD (plain PyTorch).

Counterpart of `repro.models.recurrent`:
  * RG-LRU scans the (log-decay, input) pairs with a log-depth inclusive
    (Hillis–Steele) scan over the sequence, the reference's
    `jax.lax.associative_scan` with its `combine`; log-space decays in f32;
  * SSD is the chunked state-space-duality algorithm (Mamba2 §6): the
    quadratic intra-chunk products, then a loop over chunks for the linear
    inter-chunk state recurrence. Chunk length = cfg.ssm.chunk. Each of the
    reference's three-operand einsums is written as two products, so no
    (B, nc, Q, Q, H, P) intermediate is formed.

Precision follows the reference: the gates, decays and states in f32;
`l_mat`, `tail_decay` and `in_decay` rounded to the activations' dtype and
the incoming states to C's before the products, which take f32 inputs and
accumulate in f32 (its `preferred_element_type=jnp.float32`).

Decode carries O(1) state: (B, d) for RG-LRU, (B, H, N, P) for SSD, plus
the (conv_width - 1)-row convolution tails.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import rmsnorm

RGLRU_C = 8.0  # Griffin's recurrence-gate temperature


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, tail: torch.Tensor | None = None):
    """Depthwise causal conv. x: (B, S, C), w: (W, C), tail: (B, W-1, C) (the
    previous W-1 inputs; zeros when None). The W shifted products are summed
    in the reference's order, i = 0 first. Returns (out, the last W-1 rows
    of [tail, x])."""
    width = w.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    xp = torch.cat([tail, x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i:i + s, :] * w[i][None, None, :] for i in range(width))
    new_tail = xp[:, -(width - 1):, :] if width > 1 else tail
    return out, new_tail


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def _rglru_gates(params: dict, u: torch.Tensor):
    """Per-channel (diagonal) gates -> (log_a, beta-scaled input), in f32."""
    u32 = u.float()
    r = torch.sigmoid(params["wa"] * u32 + params["ba"])
    i = torch.sigmoid(params["wi_g"] * u32 + params["bi_g"])
    log_a = RGLRU_C * r * F.logsigmoid(params["lam"].float())
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return log_a, beta * (i * u32)


def _linear_scan(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = exp(log_a_t) * h_{t-1} + b_t along dim 1 from h_{-1} = 0, as a
    log-depth inclusive scan of the pairs under the reference's `combine`:
    (la1, b1) then (la2, b2) -> (la1 + la2, exp(la2) * b1 + b2)."""
    s = log_a.shape[1]
    d = 1
    while d < s:
        log_a, b = (torch.cat([log_a[:, :d], log_a[:, :-d] + log_a[:, d:]], dim=1),
                    torch.cat([b[:, :d], torch.exp(log_a[:, d:]) * b[:, :-d] + b[:, d:]], dim=1))
        d *= 2
    return b


def _rglru_in(params: dict, x: torch.Tensor, cfg: ArchConfig, conv_tail):
    h = rmsnorm(x, params["ln"], cfg.norm_eps)
    # jax.nn.gelu defaults to the tanh approximation
    gate = F.gelu(torch.einsum("bsd,de->bse", h, params["w_gate"]), approximate="tanh")
    u = torch.einsum("bsd,de->bse", h, params["w_x"])
    u, new_tail = causal_conv1d(u, params["conv"], conv_tail)
    return gate, u, new_tail


def rglru_forward(params: dict, x: torch.Tensor, cfg: ArchConfig, state=None, conv_tail=None):
    """Griffin recurrent block over a sequence, from a carried f32 state
    (B, d) and conv tail when given. Returns (out, (h_last, conv_tail))."""
    gate, u, new_tail = _rglru_in(params, x, cfg, conv_tail)
    log_a, b = _rglru_gates(params, u)
    if state is not None:
        # fold the carried state into the first step: b_0 += a_0 * h_prev
        b = torch.cat([b[:, :1] + torch.exp(log_a[:, :1]) * state[:, None], b[:, 1:]], dim=1)
    hs = _linear_scan(log_a, b)
    out = torch.einsum("bse,ed->bsd", (gate.float() * hs).to(x.dtype), params["w_out"])
    return out, (hs[:, -1, :], new_tail)


def rglru_decode(params: dict, x: torch.Tensor, state: torch.Tensor, conv_tail: torch.Tensor,
                 cfg: ArchConfig):
    """One RG-LRU step. x (B, 1, d); state (B, d) f32; conv_tail (B, W-1, d).
    Returns (out (B, 1, d), (new_state, new_tail))."""
    gate, u, new_tail = _rglru_in(params, x, cfg, conv_tail)
    log_a, b = _rglru_gates(params, u)
    h_new = torch.exp(log_a[:, 0]) * state + b[:, 0]
    out = (gate[:, 0].float() * h_new).to(x.dtype)
    out = torch.einsum("be,ed->bd", out, params["w_out"])[:, None, :]
    return out, (h_new, new_tail)


# ---------------------------------------------------------------------------
# Mamba2 SSD
# ---------------------------------------------------------------------------


def _ssd_project(params: dict, x: torch.Tensor, cfg: ArchConfig, conv_tail=None):
    """in_proj, the causal conv and SiLU over [x, B, C], and dt: (z, xs, B,
    C, dt (f32), new_tail, n_heads)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    gn = s.n_groups * s.state_dim
    n_heads = d_in // s.head_dim
    h = rmsnorm(x, params["ln"], cfg.norm_eps)
    proj = torch.einsum("bsd,de->bse", h, params["w_in"])
    z = proj[..., :d_in]
    conv_in = proj[..., d_in:d_in + d_in + 2 * gn]
    dt_raw = proj[..., -n_heads:]
    conv_out, new_tail = causal_conv1d(conv_in, params["conv"], conv_tail)
    conv_out = F.silu(conv_out)
    xs = conv_out[..., :d_in]
    b_ = conv_out[..., d_in:d_in + gn]
    c_ = conv_out[..., d_in + gn:]
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    return z, xs, b_, c_, dt, new_tail, n_heads


def _ssd_out(params: dict, y: torch.Tensor, z: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The gated RMS norm and out_proj of the heads' outputs y (..., H * P)."""
    y = rmsnorm(y * F.silu(z), params["gnorm"], cfg.norm_eps)
    return torch.einsum("...e,ed->...d", y, params["w_out"])


def ssd_forward(params: dict, x: torch.Tensor, cfg: ArchConfig, state=None, conv_tail=None):
    """Chunked SSD over a sequence, from a carried f32 state (B, H, N, P)
    and conv tail when given. Returns (out, (ssm_state, conv_tail)).

    Shapes: x (B, S, d); H = expand * d / P heads; state N; one group (B and
    C shared across heads), as the reference's products assume. S must
    divide by the chunk min(cfg.ssm.chunk, S)."""
    s = cfg.ssm
    b, seq, _ = x.shape
    z, xs, b_, c_, dt, new_tail, nh = _ssd_project(params, x, cfg, conv_tail)
    p, n, g = s.head_dim, s.state_dim, s.n_groups
    q = min(s.chunk, seq)
    if seq % q:
        raise ValueError(f"sequence length {seq} does not divide by the chunk {q}")
    nc = seq // q
    act = x.dtype

    xh = xs.reshape(b, nc, q, nh, p)
    bh = b_.reshape(b, nc, q, g, n)
    ch = c_.reshape(b, nc, q, g, n)
    if g == 1:
        bh, ch = bh[..., 0, :], ch[..., 0, :]  # (B, nc, Q, N) shared across heads
    dtc = dt.reshape(b, nc, q, nh)
    a = -torch.exp(params["a_log"].float())      # (H,)
    da = dtc * a                                  # (B, nc, Q, H) log-decay
    cum = torch.cumsum(da, dim=2)                 # inclusive
    xdt = xh * dtc[..., None]                     # f32

    # intra-chunk (quadratic): scores_ij = C_i . B_j * exp(cum_i - cum_j), i >= j
    scores = torch.einsum("bcin,bcjn->bcij", ch, bh)
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # (B, nc, Qi, Qj, H)
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()[None, None, :, :, None]
    # exp of -inf above the diagonal: 0 there, and a zero gradient (the
    # reference's where(tri, exp(decay), 0) has exp(decay) overflow there)
    l_mat = torch.exp(torch.where(tri, decay, -torch.inf)).to(scores.dtype)
    w_ij = scores.float()[..., None] * l_mat.float()            # (B, nc, Qi, Qj, H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w_ij, xdt)

    # chunk states: S_c = sum_j exp(cum_last - cum_j) B_j (dt_j x_j)^T
    tail_decay = torch.exp(cum[:, :, -1:, :] - cum).to(bh.dtype)  # (B, nc, Q, H)
    s_c = torch.einsum("bcjn,bcjhp->bchnp", bh.float(), tail_decay.float()[..., None] * xdt)

    # inter-chunk recurrence over nc (linear)
    chunk_decay = torch.exp(cum[:, :, -1, :])                   # (B, nc, H)
    carry = (state.float() if state is not None
             else torch.zeros((b, nh, n, p), dtype=torch.float32, device=x.device))
    incoming = []
    for c in range(nc):
        incoming.append(carry)   # the state entering chunk c
        carry = carry * chunk_decay[:, c, :, None, None] + s_c[:, c]
    incoming = torch.stack(incoming, dim=1).to(ch.dtype)       # (B, nc, H, N, P)

    in_decay = torch.exp(cum).to(ch.dtype)                      # (B, nc, Q, H)
    y_inter = (torch.einsum("bcin,bchnp->bcihp", ch.float(), incoming.float())
               * in_decay.float()[..., None])

    y = (y_intra + y_inter).to(act).reshape(b, seq, nh, p)
    y = y + xh.reshape(b, seq, nh, p) * params["skip_d"][None, None, :, None].to(act)
    out = _ssd_out(params, y.reshape(b, seq, nh * p), z, cfg)
    return out, (carry, new_tail)


def ssd_decode(params: dict, x: torch.Tensor, state: torch.Tensor, conv_tail: torch.Tensor,
               cfg: ArchConfig):
    """One SSD recurrence step. x (B, 1, d); state (B, H, N, P) f32.
    Returns (out (B, 1, d), (new_state, new_tail))."""
    s = cfg.ssm
    b = x.shape[0]
    z, xs, b_, c_, dt, new_tail, nh = _ssd_project(params, x, cfg, conv_tail)
    p, n, g = s.head_dim, s.state_dim, s.n_groups
    xh = xs.reshape(b, 1, nh, p)[:, 0]
    bh = b_.reshape(b, 1, g, n)[:, 0, 0] if g == 1 else b_.reshape(b, g, n)
    ch = c_.reshape(b, 1, g, n)[:, 0, 0] if g == 1 else c_.reshape(b, g, n)
    dt0 = dt[:, 0]                                     # (B, H)
    a = -torch.exp(params["a_log"].float())
    decay = torch.exp(dt0 * a[None, :])                # (B, H)
    upd = bh.float()[:, None, :, None] * (xh.float() * dt0[..., None])[:, :, None, :]
    new_state = state * decay[..., None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", ch.float(), new_state)
    y = y.to(x.dtype) + xh * params["skip_d"][None, :, None].to(x.dtype)
    out = _ssd_out(params, y.reshape(b, nh * p), z[:, 0], cfg)[:, None, :]
    return out, (new_state, new_tail)
