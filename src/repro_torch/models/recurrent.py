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

On a mesh (an `rt` with more than one 'model' rank) RG-LRU splits by
channels and SSD by heads where the ranks divide them (`_rglru_weights`,
`_ssd_weights`): the states and RG-LRU's tail hold this rank's part, and
the SSD's packed conv tail is gathered whole for a decode step.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import comm
from repro_torch.dist.sharding import at_use, tp_split
from repro_torch.dist.tp import body_weights, split_out
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


def _rglru_weights(params: dict, x: torch.Tensor, cfg: ArchConfig, rt):
    """(weights at use, x, split): split over 'model' by channels when they
    divide (w_x, w_gate and conv this rank's columns, the gates' vectors
    its entries, w_out its rows; the norm whole), else every weight
    gathered whole. The diagonal scan is channel-local."""
    split = tp_split(rt, cfg.d_model)
    keep = {"w_x": 1, "w_gate": 1, "conv": 1, "lam": 0, "wa": 0, "ba": 0, "wi_g": 0,
            "bi_g": 0, "w_out": 0}
    return (*body_weights(params, x, rt, split, keep), split)


def _rglru_in(params: dict, x: torch.Tensor, cfg: ArchConfig, conv_tail):
    h = rmsnorm(x, params["ln"], cfg.norm_eps)
    # jax.nn.gelu defaults to the tanh approximation
    gate = F.gelu(torch.einsum("bsd,de->bse", h, params["w_gate"]), approximate="tanh")
    u = torch.einsum("bsd,de->bse", h, params["w_x"])
    u, new_tail = causal_conv1d(u, params["conv"], conv_tail)
    return gate, u, new_tail


def rglru_forward(params: dict, x: torch.Tensor, cfg: ArchConfig, state=None, conv_tail=None,
                  rt=None):
    """Griffin recurrent block over a sequence, from a carried f32 state
    (B, d) and conv tail when given. Returns (out, (h_last, conv_tail)):
    on a mesh split over channels (`_rglru_weights`), this 'model' rank's
    channels of the state and the tail."""
    params, x, split = _rglru_weights(params, x, cfg, rt)
    gate, u, new_tail = _rglru_in(params, x, cfg, conv_tail)
    log_a, b = _rglru_gates(params, u)
    if state is not None:
        # fold the carried state into the first step: b_0 += a_0 * h_prev
        b = torch.cat([b[:, :1] + torch.exp(log_a[:, :1]) * state[:, None], b[:, 1:]], dim=1)
    hs = _linear_scan(log_a, b)
    out = torch.einsum("bse,ed->bsd", (gate.float() * hs).to(x.dtype), params["w_out"])
    return split_out(out, rt, split), (hs[:, -1, :], new_tail)


def rglru_decode(params: dict, x: torch.Tensor, state: torch.Tensor, conv_tail: torch.Tensor,
                 cfg: ArchConfig, rt=None):
    """One RG-LRU step. x (B, 1, d); state (B, d) f32; conv_tail (B, W-1, d)
    (on a mesh split over channels, this rank's channels of both).
    Returns (out (B, 1, d), (new_state, new_tail))."""
    params, x, split = _rglru_weights(params, x, cfg, rt)
    gate, u, new_tail = _rglru_in(params, x, cfg, conv_tail)
    log_a, b = _rglru_gates(params, u)
    h_new = torch.exp(log_a[:, 0]) * state + b[:, 0]
    out = (gate[:, 0].float() * h_new).to(x.dtype)
    out = torch.einsum("be,ed->bd", out, params["w_out"])[:, None, :]
    return split_out(out, rt, split), (h_new, new_tail)


# ---------------------------------------------------------------------------
# Mamba2 SSD
# ---------------------------------------------------------------------------


class _SSDLayout:
    """Which heads a call computes: all of them (rt None), or this 'model'
    rank's contiguous 1 / tp_size (`ssd_split`). On a split, the columns
    of this rank's heads and of the shared B and C in the packed in_proj
    [z, x, B, C, dt] (`proj_cols`), in the packed conv [x, B, C]
    (`conv_cols`), and of its z (`z_cols`)."""

    def __init__(self, cfg: ArchConfig, rt=None, device=None):
        s = cfg.ssm
        self.d_in = s.expand * cfg.d_model
        self.gn = s.n_groups * s.state_dim
        self.n_heads = self.d_in // s.head_dim
        self.rt = rt
        if rt is None:
            self.lo, self.nh = 0, self.n_heads
            return
        self.nh = self.n_heads // rt.tp_size
        self.lo = rt.tp_rank * self.nh
        d_in, gn, p = self.d_in, self.gn, s.head_dim
        ar = functools.partial(torch.arange, device=device)
        self.z_cols = ar(self.lo * p, (self.lo + self.nh) * p)
        self.conv_cols = torch.cat([self.z_cols, ar(d_in, d_in + 2 * gn)])
        dt0 = 2 * d_in + 2 * gn + self.lo
        self.proj_cols = torch.cat([self.z_cols, d_in + self.conv_cols, ar(dt0, dt0 + self.nh)])


def ssd_split(rt, cfg: ArchConfig) -> bool:
    """Whether the SSD splits over 'model' by heads (they divide)."""
    s = cfg.ssm
    return tp_split(rt, s.expand * cfg.d_model // s.head_dim)


def _ssd_weights(params: dict, x: torch.Tensor, cfg: ArchConfig, rt):
    """(weights at use, x, layout): split over 'model' by heads when they
    divide. in_proj and conv pack [z, x, B, C, dt] and [x, B, C] on one
    'inner' dim, whose contiguous window on a rank is not its heads: they
    are gathered over 'model' at use (their gradient reduce-scattered
    back), and `_SSDLayout`'s columns pick this rank's heads' and the
    shared B and C; the gated norm's weight and out_proj's rows are this
    rank's heads' channels; a_log, dt_bias and skip_d are whole and
    sliced."""
    if not ssd_split(rt, cfg):
        return {k: at_use(v, rt) for k, v in params.items()}, x, _SSDLayout(cfg)
    w, x = body_weights(params, x, rt, True, {"gnorm": 0, "w_out": 0})
    lay = _SSDLayout(cfg, rt, x.device)
    for k in ("a_log", "dt_bias", "skip_d"):
        w[k] = w[k][lay.lo:lay.lo + lay.nh]
    return w, x, lay


def _ssd_split_proj(params: dict, h: torch.Tensor, lay: _SSDLayout, conv_tail):
    """(z, conv_in, dt_raw, conv weight, new whole tail) for lay's heads.
    All heads: the one projection. Split: in a sequence pass (conv_tail
    None) only this rank's columns are projected; for one token (conv_tail
    the whole tail, gathered) every column is, so that the new tail comes
    out whole."""
    d_in, gn, nh = lay.d_in, lay.gn, lay.nh
    if lay.rt is not None and conv_tail is None:
        proj = torch.einsum("bsd,de->bse", h, params["w_in"][:, lay.proj_cols])
        d_loc = lay.z_cols.numel()
        return (proj[..., :d_loc], proj[..., d_loc:d_loc + d_loc + 2 * gn], proj[..., -nh:],
                params["conv"][:, lay.conv_cols], None)
    proj = torch.einsum("bsd,de->bse", h, params["w_in"])
    conv_in = proj[..., d_in:d_in + d_in + 2 * gn]
    if lay.rt is None:
        return proj[..., :d_in], conv_in, proj[..., -nh:], params["conv"], None
    whole = torch.cat([conv_tail, conv_in], dim=1)[:, -conv_tail.shape[1]:]
    dt0 = 2 * d_in + 2 * gn + lay.lo
    return (proj[..., lay.z_cols], conv_in[..., lay.conv_cols], proj[..., dt0:dt0 + nh],
            params["conv"][:, lay.conv_cols], whole)


def _ssd_project(params: dict, x: torch.Tensor, cfg: ArchConfig, conv_tail=None,
                 lay: _SSDLayout | None = None):
    """in_proj, the causal conv and SiLU over [x, B, C], and dt: (z, xs, B,
    C, dt (f32), new_tail, n_heads), of lay's heads (all by default). On a
    split, the new tail is the whole conv input's (None in a sequence
    pass: `ssd_tail` makes a cache window's)."""
    lay = lay or _SSDLayout(cfg)
    gn = lay.gn
    h = rmsnorm(x, params["ln"], cfg.norm_eps)
    z, conv_in, dt_raw, conv_w, whole = _ssd_split_proj(params, h, lay, conv_tail)
    d_loc = z.shape[-1]
    if conv_tail is not None and lay.rt is not None:
        conv_tail = conv_tail[..., lay.conv_cols]
    conv_out, new_tail = causal_conv1d(conv_in, conv_w, conv_tail)
    conv_out = F.silu(conv_out)
    xs = conv_out[..., :d_loc]
    b_ = conv_out[..., d_loc:d_loc + gn]
    c_ = conv_out[..., d_loc + gn:]
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    if lay.rt is not None:
        new_tail = whole
    return z, xs, b_, c_, dt, new_tail, lay.nh


def ssd_tail(params: dict, x: torch.Tensor, cfg: ArchConfig, cols: slice) -> torch.Tensor:
    """The conv tail after a sequence pass from a zero tail: the last W - 1
    rows of the conv input, restricted to the packed [x, B, C] columns
    `cols` (a 'model' rank's window of a split cache), zero-padded in
    front when the sequence is shorter. params as `_ssd_weights` gives
    them (in_proj whole)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    w = s.conv_width - 1
    h = rmsnorm(x[:, -w:], params["ln"], cfg.norm_eps)
    rows = torch.einsum("bsd,de->bse", h, params["w_in"][:, d_in + cols.start:d_in + cols.stop])
    if rows.shape[1] < w:
        rows = torch.cat([rows.new_zeros((rows.shape[0], w - rows.shape[1], rows.shape[2])),
                          rows], dim=1)
    return rows


def _ssd_out(params: dict, y: torch.Tensor, z: torch.Tensor, cfg: ArchConfig,
             lay: _SSDLayout | None = None) -> torch.Tensor:
    """The gated RMS norm and out_proj of the heads' outputs y (..., H * P).
    On a split, the norm's mean square spans every 'model' rank's heads
    (`comm.sum_grad`) and out_proj's partial sums are summed over 'model'."""
    if lay is None or lay.rt is None:
        y = rmsnorm(y * F.silu(z), params["gnorm"], cfg.norm_eps)
        return torch.einsum("...e,ed->...d", y, params["w_out"])
    rt = lay.rt
    g = y * F.silu(z)
    g32 = g.float()
    ss = comm.sum_grad((g32 * g32).sum(dim=-1, keepdim=True), rt, (rt.tp_axis,))
    y = (g32 * torch.rsqrt(ss / lay.d_in + cfg.norm_eps)).to(g.dtype) * params["gnorm"]
    return comm.reduce_from(torch.einsum("...e,ed->...d", y, params["w_out"]), rt,
                            (rt.tp_axis,))


def ssd_forward(params: dict, x: torch.Tensor, cfg: ArchConfig, state=None, conv_tail=None,
                rt=None, tail_cols: slice | None = None):
    """Chunked SSD over a sequence, from a carried f32 state (B, H, N, P)
    and conv tail when given. Returns (out, (ssm_state, conv_tail)).

    Shapes: x (B, S, d); H = expand * d / P heads; state N; one group (B and
    C shared across heads), as the reference's products assume. S must
    divide by the chunk min(cfg.ssm.chunk, S). On a mesh split by heads
    (`_ssd_weights`) the state is this 'model' rank's heads', and the tail
    is the packed columns tail_cols of the whole one (`ssd_tail`; None
    when tail_cols is)."""
    s = cfg.ssm
    b, seq, _ = x.shape
    params, x, lay = _ssd_weights(params, x, cfg, rt)
    z, xs, b_, c_, dt, new_tail, nh = _ssd_project(params, x, cfg, conv_tail, lay)
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
    out = _ssd_out(params, y.reshape(b, seq, nh * p), z, cfg, lay)
    if lay.rt is not None and tail_cols is not None:
        new_tail = ssd_tail(params, x, cfg, tail_cols)
    return out, (carry, new_tail)


def ssd_decode(params: dict, x: torch.Tensor, state: torch.Tensor, conv_tail: torch.Tensor,
               cfg: ArchConfig, rt=None):
    """One SSD recurrence step. x (B, 1, d); state (B, H, N, P) f32 (on a
    mesh split by heads, this 'model' rank's heads; the conv tail whole,
    and the new tail comes back whole). Returns (out (B, 1, d),
    (new_state, new_tail))."""
    s = cfg.ssm
    b = x.shape[0]
    params, x, lay = _ssd_weights(params, x, cfg, rt)
    z, xs, b_, c_, dt, new_tail, nh = _ssd_project(params, x, cfg, conv_tail, lay)
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
    out = _ssd_out(params, y.reshape(b, nh * p), z[:, 0], cfg, lay)[:, None, :]
    return out, (new_state, new_tail)
