"""Plain PyTorch versions of the hand-written kernels.

Each kernel in `kernels/csrc/` has its plain version here, with the same
semantics: the wrappers in `kernels/lp_distance.py` run these for tensors
that lie on the CPU, and `chip_smoke.py` holds each kernel against its
plain version on the card. Like the kernels they take p as a Python float
or a (B,) per-row tensor.
"""

from __future__ import annotations

import torch

from repro_torch.core.lp_ops import (
    BOUND_SLACK,
    is_static_p,
    lp_entry_bound,
    lp_root,
    lp_suffix_bound,
    pow_from_abs,
)
from repro_torch.core.metrics import as_p_vec, pairwise_lp, rowwise_lp


def _valid_and_rows(ids: torch.Tensor, x: torch.Tensor):
    n = x.shape[0]
    ids = ids.long()
    valid = (ids >= 0) & (ids < n)
    return valid, x[ids.clamp(0, n - 1)]


def pairwise_lp_ref(q: torch.Tensor, x: torch.Tensor, p) -> torch.Tensor:
    """Root-free all-pairs sum |q_b - x_j|^p: q (B, d), x (N, d) -> (B, N) f32.

    Rows under p = 2 take the product identity |q|^2 + |x|^2 - 2 q.x,
    clamped at 0, as the kernel and the reference do.
    """
    return pairwise_lp(q, x, p, root=False)


def rowwise_lp_ref(q: torch.Tensor, c: torch.Tensor, p) -> torch.Tensor:
    """Root-free sum |q_b - c_bj|^p for pre-gathered rows c (B, C, d) -> (B, C) f32.

    p = 2 rows sum the squared differences directly, as the kernel does.
    """
    return rowwise_lp(q, c, p, root=False)


def lp_topk_ref(q: torch.Tensor, c: torch.Tensor, p: float, k: int, root: bool = True):
    """The k nearest of each query's own candidate rows c (B, C, d) under one
    scalar p -> (dists (B, k) f32, indices into the block (B, k) int32).

    Rowwise root-free distances, then a stable sort, so ties go to the lower
    index; the root is applied to the k kept.
    """
    sd, order = torch.sort(rowwise_lp(q, c, p, root=False), dim=1, stable=True)
    sd = sd[:, :k]
    return (lp_root(sd, p) if root else sd), order[:, :k].to(torch.int32)


def gather_lp_ref(q: torch.Tensor, ids: torch.Tensor, x: torch.Tensor, p) -> torch.Tensor:
    """Root-free sum |q_b - x_id|^p for ids (B, C) -> (B, C) f32.

    Ids outside [0, n) are padding and score +inf.
    """
    valid, rows = _valid_and_rows(ids, x)
    d = rowwise_lp(q, rows, p, root=False)
    return torch.where(valid, d, torch.inf)


def gather_lp_abandon_ref(
    q: torch.Tensor,       # (B, d) f32
    ids: torch.Tensor,     # (B, C) int; out-of-range = padding
    x: torch.Tensor,       # (n, d) f32
    thresh: torch.Tensor,  # (B,) abandon bound, power-sum space
    sb: torch.Tensor,      # (B, C) base-metric power sums (0 = no bound)
    p,                     # Python float or (B,) f32
    base_p: float,
    block_d: int,
):
    """Blocked early-abandoning scan -> (dists (B, C), nd (B, C) int32).

    Same block order, bounds and outputs as the kernel: a candidate dies
    when its partial sum, or partial sum plus the suffix bound, exceeds the
    row's threshold, or at entry when the entry bound does; dead and
    padding candidates score +inf and `nd` counts the dimensions scanned
    while alive. This version computes every block and then masks.
    """
    n, d = x.shape
    if d % block_d:
        raise ValueError(f"block_d={block_d} does not divide d={d}")
    valid, rows = _valid_and_rows(ids, x)
    diff = rows - q[:, None, :]                        # (B, C, d)
    if is_static_p(p):
        p_blk = p_row = float(p)
    else:
        p = torch.broadcast_to(as_p_vec(p, q.device), (q.shape[0],))
        p_blk = p[:, None, None]
        p_row = p[:, None]
    thr = thresh[:, None]
    lb = lp_entry_bound(sb, base_p, p_row, d)
    alive = valid & (lb <= thr)
    s = torch.zeros_like(sb)
    sbase = torch.zeros_like(sb)
    nd = torch.zeros(sb.shape, dtype=torch.int32, device=sb.device)
    for b in range(d // block_d):
        a = torch.abs(diff[..., b * block_d:(b + 1) * block_d])
        bs = torch.sum(pow_from_abs(a, p_blk), dim=-1)
        bb = torch.sum(a if base_p == 1.0 else a * a, dim=-1)
        s = torch.where(alive, s + bs, s)
        sbase = torch.where(alive, sbase + bb, sbase)
        nd = nd + torch.where(alive, block_d, 0).to(torch.int32)
        dead = s > thr
        d_rem = d - (b + 1) * block_d
        if d_rem > 0:
            rem = lp_suffix_bound(sb - sbase, base_p, p_row, float(d_rem))
            dead = dead | (s + rem > thr)
        alive = alive & ~dead
    return torch.where(alive, s, torch.inf), nd


def gather_lp_screen_ref(
    q: torch.Tensor,       # (B, d) f32, band (permuted) coordinate order
    ids: torch.Tensor,     # (B, C) int; out-of-range = padding
    codes: torch.Tensor,   # (n, d) int8 band rows
    scale: torch.Tensor,   # (d,) f32 dequantisation scales
    radius: torch.Tensor,  # (d,) f32 largest dequantisation errors
    thresh: torch.Tensor,  # (B,) screen bound, power-sum space
    sb: torch.Tensor,      # (B, C) base-metric power sums (0 = no bound)
    p,                     # Python float or (B,) f32
    base_p: float,
    block_d: int,
):
    """Blocked compressed-band screen -> (keep (B, C) bool, nd (B, C) int32).

    Same block order, bounds and outputs as the kernel: it accumulates the
    certified lower terms max(|q_j - x^_j| - r_j, 0)^p and, for the suffix
    bound, the upper terms |q_j - x^_j| + r_j, and kills a candidate when
    the running bound, deflated by BOUND_SLACK, exceeds the row's
    threshold (or at entry when the entry bound does). Padding never
    survives; `nd` counts the band dimensions scanned while alive. This
    version computes every block and then masks.
    """
    n, d = codes.shape
    if d % block_d:
        raise ValueError(f"block_d={block_d} does not divide d={d}")
    valid = (ids >= 0) & (ids < n)
    xh = codes[ids.long().clamp(0, n - 1)].to(torch.float32) * scale   # (B, C, d)
    a0 = torch.abs(xh - q[:, None, :])
    al = torch.clamp_min(a0 - radius, 0.0)
    au = a0 + radius
    if is_static_p(p):
        p_blk = p_row = float(p)
    else:
        p = torch.broadcast_to(as_p_vec(p, q.device), (q.shape[0],))
        p_blk = p[:, None, None]
        p_row = p[:, None]
    thr = thresh[:, None]
    alive = valid & (lp_entry_bound(sb, base_p, p_row, d) <= thr)
    s = torch.zeros_like(sb)
    sbase = torch.zeros_like(sb)
    nd = torch.zeros(sb.shape, dtype=torch.int32, device=sb.device)
    deflate = 1.0 - BOUND_SLACK
    for b in range(d // block_d):
        blk = slice(b * block_d, (b + 1) * block_d)
        bs = torch.sum(pow_from_abs(al[..., blk], p_blk), dim=-1)
        ub = au[..., blk]
        bb = torch.sum(ub if base_p == 1.0 else ub * ub, dim=-1)
        s = torch.where(alive, s + bs, s)
        sbase = torch.where(alive, sbase + bb, sbase)
        nd = nd + torch.where(alive, block_d, 0).to(torch.int32)
        dead = s * deflate > thr
        d_rem = d - (b + 1) * block_d
        if d_rem > 0:
            rem = lp_suffix_bound(sb - sbase, base_p, p_row, float(d_rem))
            dead = dead | ((s + rem) * deflate > thr)
        alive = alive & ~dead
    return alive, nd
