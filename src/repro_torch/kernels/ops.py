"""Exact-Lp scoring for the query path and the bulk builder.

Counterpart of the dispatchers in `repro.kernels.ops`. The reference pads
and tiles for the TPU's VMEM; here the kernels take any (B, C), so these
functions only normalise p, pick the abandon block width and apply the
outer root. Each takes the reference's parameters in the reference's
order; `interpret`, `block_b` and `block_c` (its Pallas dispatch override
and VMEM tiles) are taken and ignored. Device dispatch lives in the wrappers of `kernels.lp_distance`
(CUDA -> kernel, CPU -> plain version), looked up at call time.
"""

from __future__ import annotations

import torch

from repro_torch.core.lp_ops import is_static_p, lp_root
from repro_torch.core.metrics import as_p_vec
from repro_torch.kernels import lp_distance as _k


def _p_arg(p, b: int, device):
    """A float, or a (B,) float32 tensor on `device` ((1,) broadcasts)."""
    if is_static_p(p):
        return float(p)
    return torch.broadcast_to(as_p_vec(p, device), (b,))


def _root(d: torch.Tensor, p):
    return lp_root(d, p if is_static_p(p) else p[:, None])


def lp_gather_distance(q: torch.Tensor, ids: torch.Tensor, x: torch.Tensor, p,
                       root: bool = False, interpret: bool | None = None,
                       block_b: int | None = None, block_c: int | None = None) -> torch.Tensor:
    """Exact-Lp distances for per-query candidate id blocks -> (B, C) f32.

    ids (B, C): ids outside [0, n) are padding and score +inf. ids may also
    be 1-D (C,): every query scores the same rows, which are gathered once
    and scored by the pairwise kernel (p = 2 rows on the product identity).
    p: a Python float, or a (B,) tensor scoring row i under p[i].
    """
    p = _p_arg(p, q.shape[0], q.device)
    if ids.ndim == 1:
        n = x.shape[0]
        ids = ids.long()
        valid = (ids >= 0) & (ids < n)
        d = _k.pairwise_lp(q, x[ids.clamp(0, n - 1)], p)
        d = torch.where(valid[None, :], d, torch.inf)
    else:
        d = _k.gather_lp(q, ids, x, p)
    return _root(d, p) if root else d


def lp_gather_distance_multi(q: torch.Tensor, ids: torch.Tensor, x: torch.Tensor,
                             ps: tuple[float, ...]) -> torch.Tensor:
    """Root-free power sums of per-query candidate id blocks under one or two
    static p, from one read of each row -> (P, B, C) f32; plane i has
    `lp_gather_distance`'s bits at ps[i]. ids (B, C) outside [0, n) are
    padding and score +inf. The bulk builder's shared scoring pass."""
    return _k.gather_lp_multi(q, ids, x, ps)


def lp_rowwise_distance(q: torch.Tensor, c: torch.Tensor, p, root: bool = True):
    """Rowwise Lp distances q (B, d) x pre-gathered c (B, C, d) -> (B, C) f32,
    through the rowwise kernel (the counterpart of `pallas_rowwise_lp`).
    p: a float, or a (B,) tensor ((1,) broadcasts) scoring row i under p[i]."""
    p = _p_arg(p, q.shape[0], q.device)
    d = _k.rowwise_lp(q, c, p)
    return _root(d, p) if root else d


def lp_pairwise_distance(q: torch.Tensor, x: torch.Tensor, p, root: bool = False,
                         interpret: bool | None = None):
    """All-pairs Lp distances q (B, d) x x (N, d) -> (B, N) f32, through the
    pairwise kernel. p: a float, or a (B,) tensor scoring row i under p[i]."""
    p = _p_arg(p, q.shape[0], q.device)
    d = _k.pairwise_lp(q, x, p)
    return _root(d, p) if root else d


def pick_abandon_block_d(d: int) -> int:
    """Dimension-block width of the early-abandoning scan: the reference's
    choice (32, else 16, else 8 when it divides d, else one full block),
    since the scanned-dimension counts depend on it."""
    for bd in (32, 16, 8):
        if d % bd == 0:
            return bd
    return d


def lp_gather_abandon(q: torch.Tensor, ids: torch.Tensor, x: torch.Tensor,
                      thresh: torch.Tensor, sb: torch.Tensor, p, base_p: float = 1.0,
                      root: bool = False, interpret: bool | None = None,
                      block_b: int | None = None, block_c: int | None = None,
                      block_d: int | None = None):
    """Early-abandoning exact-Lp scoring (DESIGN.md §8) -> (dists, nd).

    thresh (B,): per-row bound in power-sum space (+inf = no abandonment,
    -inf = skip the row); sb (B, C): base-metric power sums of the
    candidates (0 disables the bounds), in the metric named by base_p.
    Abandoned and padding candidates score +inf; nd (B, C) int32 counts the
    dimensions scanned.
    """
    p = _p_arg(p, q.shape[0], q.device)
    bd = block_d or pick_abandon_block_d(q.shape[1])
    out, nd = _k.gather_lp_abandon(q, ids, x, thresh, sb, p, float(base_p), bd)
    return (_root(out, p) if root else out), nd


def lp_gather_screen(q: torch.Tensor, ids: torch.Tensor, codes: torch.Tensor,
                     scale: torch.Tensor, radius: torch.Tensor, thresh: torch.Tensor,
                     sb: torch.Tensor, p, base_p: float = 1.0, interpret: bool | None = None,
                     block_b: int | None = None, block_c: int | None = None,
                     block_d: int | None = None):
    """Compressed-band candidate screen (DESIGN.md §10) -> (keep, nd).

    q (B, d) in the band's coordinate order (Q[:, band.perm]); thresh (B,)
    per-row bound in power-sum space (-inf screens out the row, +inf keeps
    every valid candidate); sb (B, C) the candidates' base-metric power
    sums (0 disables the bounds). keep (B, C) bool marks the candidates
    whose f32 rows the exact rescore must gather; nd (B, C) int32 counts
    the band dimensions scanned.
    """
    p = _p_arg(p, q.shape[0], q.device)
    bd = block_d or pick_abandon_block_d(q.shape[1])
    return _k.gather_lp_screen(q, ids, codes, scale, radius, thresh, sb, p, float(base_p), bd)
