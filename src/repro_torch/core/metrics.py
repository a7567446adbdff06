"""Lp distance computation under universal p (paper §2.1).

Counterpart of `repro.core.metrics`: plain PyTorch distances that the
search loops, the plain kernel versions and the tests use, the base-index
selection rule, and the analytic op-cost model behind `modeled_query_cost`
(a model of relative per-element cost, not a measurement of any device).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.lp_ops import abs_pow, is_static_p, lp_root

# p-values whose Lp distance evaluates without transcendentals.
BASIC_PS = (1.0, 2.0)
# p-values that need only a sqrt on top of basic arithmetic.
SQRT_PS = (0.5, 1.5)


def as_p_vec(p, device=None) -> torch.Tensor:
    """A per-row p as a float32 tensor of shape (B,) ((1,) for one value)."""
    p = torch.as_tensor(p, dtype=torch.float32, device=device)
    return p[None] if p.ndim == 0 else p


def _p_last(p):
    """Scalar p as-is; per-row (B,) p with a trailing axis for (B, ..., d)."""
    return p if is_static_p(p) else p[..., None]


def lp_distance(x: torch.Tensor, y: torch.Tensor, p, root: bool = True) -> torch.Tensor:
    """Lp distance between broadcast-compatible tensors along the last axis.

    p: Python float, or a tensor broadcastable to the result shape. With
    root=False returns sum(|x-y|^p), which orders the same and is cheaper.
    """
    if not is_static_p(p):
        p = as_p_vec(p, x.device)
    s = torch.sum(abs_pow(x - y, _p_last(p)), dim=-1)
    return lp_root(s, p) if root else s


def pairwise_lp(q: torch.Tensor, x: torch.Tensor, p, root: bool = True) -> torch.Tensor:
    """All-pairs Lp distances: q (B, d) vs x (N, d) -> (B, N) f32.

    p = 2 (scalar, and rows of a per-row p equal to 2) uses the product
    identity ||q||^2 + ||x||^2 - 2 q.x, clamped at 0, as the reference does.
    """
    if is_static_p(p):
        p = float(p)
        if p == 2.0:
            s = _l2_identity(q, x)
            return torch.sqrt(s) if root else s
        s = torch.sum(abs_pow(q[:, None, :] - x[None, :, :], p), dim=-1)
        return lp_root(s, p) if root else s
    p = torch.broadcast_to(as_p_vec(p, q.device), (q.shape[0],))
    s = torch.sum(abs_pow(q[:, None, :] - x[None, :, :], p[:, None, None]), dim=-1)
    s = torch.where(p[:, None] == 2.0, _l2_identity(q, x), s)
    return lp_root(s, p[:, None]) if root else s


def _l2_identity(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    qq = torch.sum(q * q, dim=-1)
    xx = torch.sum(x * x, dim=-1)
    return torch.clamp_min(qq[:, None] + xx[None, :] - 2.0 * (q @ x.T), 0.0)


def rowwise_lp(q: torch.Tensor, c: torch.Tensor, p, root: bool = True) -> torch.Tensor:
    """Per-row candidate distances: q (B, d) vs c (B, C, d) -> (B, C).

    Row i is scored under p (a float) or p[i] (a (B,) tensor).
    """
    if is_static_p(p):
        s = torch.sum(abs_pow(q[:, None, :] - c, p), dim=-1)
        return lp_root(s, p) if root else s
    p = torch.broadcast_to(as_p_vec(p, q.device), (q.shape[0],))
    s = torch.sum(abs_pow(q[:, None, :] - c, p[:, None, None]), dim=-1)
    return lp_root(s, p[:, None]) if root else s


def base_metric_for(p, cutoff: float = 1.4):
    """U-HNSW base-index selection rule (paper Alg. 1 line 3): G1 iff p <= cutoff.

    Scalar p -> 1.0 / 2.0; array p -> a same-shape float32 array, the
    two-way G1/G2 partition of a mixed-p batch.
    """
    if torch.is_tensor(p):
        p = p.detach().cpu().numpy()
    pa = np.asarray(p, dtype=np.float32)
    # NaN must fail too, so phrase the check as "all inside"
    if not np.all((pa >= 0.5) & (pa <= 2.0)):
        raise ValueError(f"p={p} outside the supported universal range [0.5, 2]")
    if pa.ndim == 0:
        return 1.0 if float(pa) <= cutoff else 2.0
    return np.where(pa <= cutoff, np.float32(1.0), np.float32(2.0))


def numpy_lp(q, x, p: float, root: bool = True):
    """NumPy oracle used by tests."""
    diff = np.abs(np.asarray(q)[..., None, :] - np.asarray(x)[None, :, :])
    s = (diff**p).sum(axis=-1)
    return s ** (1.0 / p) if root else s


# ---------------------------------------------------------------------------
# Analytic op-cost model (the shape of paper Fig. 1), in relative cost units
# per element: basic ALU ops cost 1, a transcendental 7, and the p = 2
# product identity amortises its multiply-add 64x. The weights are the
# reference package's; they model relative cost and measure nothing.
# ---------------------------------------------------------------------------

VPU_BASIC = 1.0
VPU_TRANSCENDENTAL = 7.0
MXU_SPEEDUP = 64.0


def lp_op_cost_per_element(p: float, use_mxu: bool = True) -> float:
    """Modelled per-element cost of |x-y|^p summation; at p = 2 the
    multiply-add is amortised by the product identity when use_mxu."""
    if p == 2.0:
        return VPU_BASIC + 2.0 * VPU_BASIC / (MXU_SPEEDUP if use_mxu else 1.0)
    if p == 1.0:
        return 3.0 * VPU_BASIC
    if p in SQRT_PS:
        extra = VPU_BASIC if p == 1.5 else 0.0
        return 3.0 * VPU_BASIC + VPU_TRANSCENDENTAL + extra
    return 4.0 * VPU_BASIC + 2.0 * VPU_TRANSCENDENTAL


def lp_distance_cost_model(p: float, d: int, use_mxu: bool = True) -> float:
    """Modelled cost of one d-dim Lp distance (root included)."""
    root_cost = 0.0 if p == 1.0 else VPU_TRANSCENDENTAL
    return lp_op_cost_per_element(p, use_mxu=use_mxu) * d + root_cost


def transcendental_op_count(p: float, d: int) -> int:
    """Transcendental operations of one d-dim Lp distance (root excluded)."""
    if p in BASIC_PS:
        return 0
    if p in SQRT_PS:
        return d
    return 2 * d   # log and exp per element
