"""Compressed storage band with certified Lp lower bounds (DESIGN.md §10).

Counterpart of `repro.index.compressed`. An int8 replica of the corpus with
per-coordinate scales admits exact per-coordinate error radii

    radius_j >= |x_j - x^_j|   for every row x,   x^_j = scale_j * code_j,

so |q_j - x_j| >= max(|q_j - x^_j| - radius_j, 0) coordinate by coordinate,
and the power sum of those terms is a certified lower bound on the true f32
power sum. The two-band verification (`core.uhnsw`, compressed_band=True)
screens candidates against the running k-th best with this bound (the
`gather_lp_screen` kernel) and gathers f32 rows only for the survivors.

Coordinates are stored in energy order (decreasing variance), so the mass
comes first and the screen and the suffix bounds kill after fewer blocks.
The quantisation is symmetric per coordinate (codes in [-127, 127]); the
radii are the exact f32 maxima of the dequantisation error. The band is
built in NumPy on the host, as the reference builds it, so the same corpus
gives the same bytes in both packages; its tensors land on the corpus's
device (a host array's on the card, unless the caller asks for the CPU).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.lp_ops import is_static_p, pow_from_abs


@dataclass(frozen=True)
class CompressedBand:
    """Device-resident int8 replica of a frozen corpus, in energy order.

    codes (n, d) int8: band coordinate j is original coordinate perm[j].
    scale (d,) f32: dequantisation scales, x^ = codes.float() * scale.
    radius (d,) f32: the largest dequantisation error of each coordinate.
    perm (d,) int64: band coordinate j = original coordinate perm[j];
    queries enter the screen as Q[:, perm].
    """

    codes: torch.Tensor
    scale: torch.Tensor
    radius: torch.Tensor
    perm: torch.Tensor

    @property
    def n(self) -> int:
        return int(self.codes.shape[0])

    @property
    def d(self) -> int:
        return int(self.codes.shape[1])

    def nbytes(self) -> int:
        """Band storage footprint (codes + scales + radii + perm), counted as
        the reference counts it: 4 bytes for each entry of perm."""
        return self.n * self.d + 3 * 4 * self.d


def _host(X) -> np.ndarray:
    if torch.is_tensor(X):
        X = X.detach().cpu().numpy()
    return np.asarray(X)


def energy_order(X) -> np.ndarray:
    """(d,) int32 permutation: coordinates by decreasing variance, ties in
    original order (a stable sort), computed on the host in float64."""
    var = np.var(np.asarray(_host(X), dtype=np.float64), axis=0)
    return np.argsort(-var, kind="stable").astype(np.int32)


def build_band(X, perm: np.ndarray | None = None, *, device=None) -> CompressedBand:
    """Quantises a frozen corpus into its compressed band.

    X: (n, d) f32 numpy array or tensor. perm: optional (d,) coordinate
    permutation, None for the energy order. device: where the band's
    tensors live; None keeps a tensor's band on the tensor's device and
    puts a host array's on "cuda" (pass device="cpu" for the CPU), as the
    reference's band is device-resident. Deterministic: the same X gives
    the same band.
    """
    if device is None:
        device = X.device if torch.is_tensor(X) else "cuda"
    Xh = np.ascontiguousarray(_host(X), dtype=np.float32)
    n, d = Xh.shape
    if perm is None:
        perm = energy_order(Xh)
    perm = np.asarray(perm, dtype=np.int32)
    if perm.shape != (d,):
        raise ValueError(f"perm has shape {perm.shape}, expected ({d},)")
    Xp = np.ascontiguousarray(Xh[:, perm])
    absmax = np.abs(Xp).max(axis=0) if n else np.zeros(d, np.float32)
    scale = (np.maximum(absmax, 1e-12) / 127.0).astype(np.float32)
    codes = np.clip(np.round(Xp / scale), -127, 127).astype(np.int8)
    # exact f32 radii over the same dequantisation the screen evaluates
    dequant = (codes.astype(np.float32) * scale).astype(np.float32)
    radius = (np.abs(Xp - dequant).max(axis=0) if n else np.zeros(d)).astype(np.float32)
    return CompressedBand(
        codes=torch.from_numpy(codes).to(device),
        scale=torch.from_numpy(scale).to(device),
        radius=torch.from_numpy(radius).to(device),
        perm=torch.from_numpy(perm.astype(np.int64)).to(device),
    )


def compressed_lower_bound(qp: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                           radius: torch.Tensor, p) -> torch.Tensor:
    """Certified lower bound on the f32 Lp power sum, full-dimension form.

    qp (B, d) queries in band order; codes (C, d) int8 band rows; scale,
    radius (d,). p: a float or a (B,) tensor. Returns (B, C) f32, the
    undeflated sum_j max(|q_j - x^_j| - r_j, 0)^p.
    """
    xh = codes.to(torch.float32) * scale[None, :]
    a = torch.clamp_min(torch.abs(qp[:, None, :] - xh[None, :, :]) - radius, 0.0)
    p_b = float(p) if is_static_p(p) else torch.as_tensor(p)[:, None, None]
    return torch.sum(pow_from_abs(a, p_b), dim=-1)
