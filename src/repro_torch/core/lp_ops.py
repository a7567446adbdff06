"""The cheap-op-sequence table for |diff|^p and s^(1/p) (paper §2.1).

Counterpart of `repro.core.lp_ops`: one table of per-p-family op sequences,
shared by the plain metrics (`repro_torch.core.metrics`), the plain kernel
versions (`repro_torch.kernels.ref`) and, written out again in CUDA, the
kernels under `repro_torch/kernels/csrc/`.

`p` is either

  * a Python float (or a 0-d numpy scalar) — only that p's op sequence is
    evaluated; or
  * a float32 tensor broadcastable against the data — every family's op
    sequence is evaluated elementwise and `torch.where` selects per element,
    so the value produced for a given p carries the same bits as the
    scalar form at that p (a select returns the chosen operand unchanged).

Divisions by p always divide by a tensor on the data's device, so the
scalar and the per-row form perform the same IEEE division (PyTorch would
otherwise turn a division by a host scalar into a multiplication by its
reciprocal on CUDA, which rounds differently).
"""

from __future__ import annotations

import numpy as np
import torch

# Guard for log(0) in the general-p transcendental path.
EPS = 1e-30
# Deflation of the early-abandon lower bounds (see `lp_entry_bound`).
BOUND_SLACK = 1e-3


def is_static_p(p) -> bool:
    """True when p is one host scalar for the whole call (Python int/float
    or a 0-d numpy value); tensors, including 0-d ones, take the per-row
    path."""
    if isinstance(p, bool):
        return False
    if isinstance(p, (int, float)):
        return True
    return isinstance(p, (np.generic, np.ndarray)) and np.ndim(p) == 0


def pow_from_abs(a: torch.Tensor, p) -> torch.Tensor:
    """a^p elementwise for a >= 0, cheapest op sequence per p family."""
    if is_static_p(p):
        p = float(p)
        if p == 1.0:
            return a
        if p == 2.0:
            return a * a
        if p == 0.5:
            return torch.sqrt(a)
        if p == 1.5:
            return a * torch.sqrt(a)
        safe = torch.clamp_min(a, EPS)
        return torch.where(a == 0, 0.0, torch.exp(p * torch.log(safe)))
    safe = torch.clamp_min(a, EPS)
    out = torch.where(a == 0, 0.0, torch.exp(p * torch.log(safe)))
    out = torch.where(p == 1.0, a, out)
    out = torch.where(p == 2.0, a * a, out)
    out = torch.where(p == 0.5, torch.sqrt(a), out)
    out = torch.where(p == 1.5, a * torch.sqrt(a), out)
    return out


def abs_pow(diff: torch.Tensor, p) -> torch.Tensor:
    """|diff|^p elementwise (scalar or per-element p)."""
    if is_static_p(p) and float(p) == 2.0:
        return diff * diff  # the abs is bit-neutral for a square
    return pow_from_abs(torch.abs(diff), p)


def _runtime_p(p, like: torch.Tensor) -> torch.Tensor:
    """p as a float32 tensor broadcast to `like` (a true runtime divisor)."""
    if is_static_p(p):
        return like.new_full((), float(p)).expand_as(like)
    return torch.broadcast_to(p.to(like.dtype), like.shape)


def lp_root(s: torch.Tensor, p) -> torch.Tensor:
    """s^(1/p) elementwise: the outer root of the Lp norm."""
    if is_static_p(p):
        p = float(p)
        if p == 1.0:
            return s
        if p == 2.0:
            return torch.sqrt(s)
        if p == 0.5:
            return s * s
        safe = torch.clamp_min(s, EPS)
        return torch.where(s == 0, 0.0,
                           torch.exp(torch.log(safe) / _runtime_p(p, s)))
    safe = torch.clamp_min(s, EPS)
    out = torch.where(s == 0, 0.0, torch.exp(torch.log(safe) / _runtime_p(p, s)))
    out = torch.where(p == 1.0, s, out)
    out = torch.where(p == 2.0, torch.sqrt(s), out)
    out = torch.where(p == 0.5, s * s, out)
    return out


# ---------------------------------------------------------------------------
# Early-abandoning verification bounds (DESIGN.md §8).
#
# Lower bounds on a candidate's final root-free power sum, from the
# base-metric distance Sb the beam already paid for:
#   base L1:  sum|v|^p >= S1^p            for p <= 1
#             sum|v|^p >= d^(1-p) * S1^p  for p >  1
#   base L2:  sum|v|^p >= S2^(p/2)        for p <= 2
# The suffix bound applies the same inequality to the unscanned dimensions
# and the base mass left in them. Both are deflated by BOUND_SLACK so f32
# rounding never lifts a bound above the true value.
# ---------------------------------------------------------------------------


def _safe_pow(x: torch.Tensor, e) -> torch.Tensor:
    """x^e for x >= 0 via exp(e*log x), with x <= 0 -> 0."""
    safe = torch.clamp_min(x, EPS)
    return torch.where(x <= 0, 0.0, torch.exp(e * torch.log(safe)))


def lp_entry_bound(sb: torch.Tensor, base_p: float, p, d) -> torch.Tensor:
    """Lower bound on sum|q-x|^p from the base power sum `sb` over d dims.

    base_p is 1.0 or 2.0; p is a Python float or a tensor broadcastable to
    sb; d is a number or a tensor. sb = 0 disables the bound.
    """
    sb = torch.clamp_min(sb, 0.0)
    if base_p == 1.0:
        lb = _safe_pow(sb, p)
        if torch.is_tensor(d):
            dd = torch.clamp_min(d.to(torch.float32), 1.0)
        else:
            dd = sb.new_full((), max(float(d), 1.0))
        if is_static_p(p):
            if float(p) > 1.0:
                lb = lb * _safe_pow(dd, 1.0 - float(p))
        else:
            lb = torch.where(p > 1.0, lb * _safe_pow(dd, 1.0 - p), lb)
    else:
        lb = _safe_pow(sb, float(p) / 2.0 if is_static_p(p) else p * 0.5)
    return lb * (1.0 - BOUND_SLACK)


def lp_suffix_bound(r: torch.Tensor, base_p: float, p, d_rem) -> torch.Tensor:
    """Lower bound on the unscanned suffix's power sum from its remaining
    base mass r over d_rem dims: the entry bound applied to the suffix."""
    return lp_entry_bound(r, base_p, p, d_rem)
