"""U-HNSW (paper Algorithm 1): ANNS under universal Lp metrics.

Counterpart of `repro.core.uhnsw`. Query processing for (q, p):
  1. Candidate generation: G1 (L1) if p <= 1.4 else G2 (L2), beam search
     for the top-t candidates under the base metric (t = 300 by default).
  2. Verification: re-rank the candidates under exact Lp, popping batches of
     kappa and stopping a query once its running top-K is stable:
     |R_new ∩ R| / K >= tau (tau = 0.92 by default).

The verification loop steps every query together: a query that has
converged freezes its results and N_p, and the loop ends when all have
(or the candidates run out). With `abandon` (the default) each kappa batch
runs the early-abandoning kernel against the running k-th best; the first k
candidates are scored by the gather kernel. For p equal to the base metric
the beam's order is already exact and verification is skipped.
Two variants of the abandoning path (DESIGN.md §10): `compressed_band`
screens each kappa batch against an int8 replica of the corpus (the screen
kernel) and rescores only the survivors from f32 rows; `energy_perm` runs
the abandoning scan in energy coordinate order. Both return the ids of the
default path.

Builders (`UHNSW.build`): the sequential `incremental` (the default, as in
the reference), the shared-pass `bulk` (`core.bulk_build`) and the host
`bulk_host` (`core.build.build_hnsw_bulk`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import metrics
from repro_torch.core.build import HNSWGraph, build_hnsw, build_hnsw_bulk
from repro_torch.core.bulk_build import build_bulk_pair
from repro_torch.core.hnsw import GraphArrays, knn_search
from repro_torch.core.lp_ops import is_static_p, lp_root
from repro_torch.kernels.ops import lp_gather_abandon, lp_gather_distance, lp_gather_screen


@dataclass(frozen=True)
class UHNSWParams:
    """Query-time parameters (paper Algorithm 1 + §3.2).

    t: candidate set size fed to verification; tau: early-termination
    threshold (target recall + 0.02); kappa: verification batch size (None
    -> K // 2); cutoff: G1 serves p <= cutoff, G2 the rest, per query row;
    ef: beam width (None -> 2t); max_hops: cap on loop trips per layer;
    expand_width: W-way multi-expansion of the level-0 beam; interpret:
    taken at the reference's place (its Pallas dispatch override) and
    ignored, since the port's wrappers dispatch on the tensor's device;
    abandon: the
    early-abandoning verification (exact: same ids and distances as the
    full scan up to summation order); abandon_block_d: its dimension-block
    width (None -> `kernels.ops.pick_abandon_block_d`); compressed_band:
    with abandon, the two-band scan (int8 screen, f32 rescore of the
    survivors); energy_perm: with abandon and without the band, the
    abandoning scan in energy coordinate order.
    """

    t: int = 300
    tau: float = 0.92
    kappa: int | None = None
    cutoff: float = 1.4
    ef: int | None = None
    max_hops: int = 4096
    expand_width: int = 1
    interpret: bool | None = None   # the reference's kernel override; ignored
    abandon: bool = True
    abandon_block_d: int | None = None
    compressed_band: bool = False
    energy_perm: bool = False


class CandidateSet(NamedTuple):
    """Output of the candidate-generation stage (all on the device)."""

    ids: torch.Tensor         # (B, t) int32, ascending by base-metric distance
    base_dists: torch.Tensor  # (B, t) root-free base-metric power sums
    n_b: torch.Tensor         # (B,) base-metric evaluation counts (Eq. 1)
    hops: torch.Tensor        # (B,) level-0 loop trips
    base_p: float             # base metric of the candidates (1.0 = G1, 2.0 = G2)
    # cross-segment phase split (the sharded index's two_phase / round_robin
    # policies): probe = evaluations without a bound, spill = evaluations
    # under an inherited pruning bound; n_b == n_b_probe + n_b_spill. A
    # monolithic or independent search is all probe.
    n_b_probe: torch.Tensor | None = None   # (B,); None means n_b
    n_b_spill: torch.Tensor | float = 0.0
    n_cand_spill: torch.Tensor | float = 0.0  # (B,) spill-phase survivors
    # in the merged candidate list
    # degraded-coverage serving: the sharded index's NaN/inf guard raises a
    # row's flag where it masked a non-finite base distance
    poisoned: torch.Tensor | float = 0.0
    coverage_frac: float = 1.0  # served share of the corpus (host float)


class SearchStats(NamedTuple):
    n_b: torch.Tensor          # (B,) base-metric Q2D evaluation counts
    n_p: torch.Tensor          # (B,) Lp Q2D evaluation counts
    iterations: int            # verification loop iterations executed
    base_p: float | np.ndarray  # scalar for a one-p batch, (B,) for mixed p
    hops: torch.Tensor | int = 0
    n_dim_frac: torch.Tensor | float = 1.0  # (B,) share of the verification
    # dimension-work actually scanned (1.0 on the full-dimension paths),
    # counted over rows that had not converged, like N_p
    # cross-segment phase split (sharded index): n_b == n_b_probe +
    # n_b_spill; n_p_probe + n_p_spill is the graph-verify share of n_p
    # (the delta tier's exact scans are neither phase). None means "all
    # probe": n_b, n_p.
    n_b_probe: torch.Tensor | float | None = None
    n_b_spill: torch.Tensor | float = 0.0
    n_p_probe: torch.Tensor | float | None = None
    n_p_spill: torch.Tensor | float = 0.0
    n_f32_rows_frac: torch.Tensor | float = 1.0  # (B,) share of the verified
    # candidates whose f32 rows were gathered: below 1 only on the two-band
    # path, where f32 bytes = n_f32_rows_frac * n_p * 4d
    n_band_frac: torch.Tensor | float = 0.0  # (B,) int8 band dimensions the
    # screen scanned, over n_p * d (0 when no band is in play); bytes against
    # the f32-only path = n_f32_rows_frac + n_band_frac / 4
    # degraded-coverage serving (sharded index): the exact served share of
    # the corpus, and the NaN/inf guard's per-row flag. A monolithic search
    # reports 1.0, False and 0.
    coverage_frac: float = 1.0
    degraded: bool = False  # coverage_frac < 1.0
    poisoned: torch.Tensor | float = 0.0

    def phase_n_b(self):
        """(probe, spill) N_b split with the None default resolved."""
        probe = self.n_b if self.n_b_probe is None else self.n_b_probe
        return probe, self.n_b_spill

    def phase_n_p(self):
        """(probe, spill) N_p split with the None default resolved."""
        probe = self.n_p if self.n_p_probe is None else self.n_p_probe
        return probe, self.n_p_spill


def _sort_by_dist(d: torch.Tensor, ids: torch.Tensor):
    sd, order = torch.sort(d, dim=1, stable=True)
    return sd, ids.gather(1, order)


def _verify_impl(Q, cand_ids, X, p, k: int, kappa: int, tau: float):
    """Full-dimension verification (abandon=False)."""
    B, t = cand_ids.shape
    n_batches = max((t - k) // kappa, 0)
    p_col = p if is_static_p(p) else p[:, None]
    first = cand_ids[:, :k]
    r_dist, r_ids = _sort_by_dist(lp_gather_distance(Q, first, X, p), first)
    n_p = torch.full((B,), k, dtype=torch.int32, device=Q.device)
    done = torch.zeros(B, dtype=torch.bool, device=Q.device)
    i = 0
    while i < n_batches and not bool(done.all()):
        batch = cand_ids[:, k + i * kappa:k + (i + 1) * kappa]
        bd = lp_gather_distance(Q, batch, X, p)
        new_dist, new_ids = _sort_by_dist(torch.cat([r_dist, bd], 1),
                                          torch.cat([r_ids, batch], 1))
        r_ids, r_dist, done, n_p = _converge(r_ids, r_dist, new_ids[:, :k],
                                             new_dist[:, :k], done, n_p, k, kappa, tau)
        i += 1
    return r_ids, lp_root(r_dist, p_col), n_p, i


def _converge(r_ids, r_dist, new_ids, new_dist, done, n_p, k, kappa, tau):
    """One convergence step: rows not yet done take the merged top-k and
    stop once |R_new ∩ R| / K >= tau; done rows keep everything."""
    inter = (new_ids[:, :, None] == r_ids[:, None, :]).any(-1).sum(-1)
    newly_done = inter.to(torch.float32) / k >= tau
    keep = done[:, None]
    r_ids = torch.where(keep, r_ids, new_ids)
    r_dist = torch.where(keep, r_dist, new_dist)
    n_p = n_p + torch.where(done, 0, kappa).to(torch.int32)
    return r_ids, r_dist, done | newly_done, n_p


def _verify_abandon_impl(Q, cand_ids, cand_base, X, p, k: int, kappa: int, tau: float,
                         base_p: float, block_d: int | None, x_scan=None, perm=None):
    """Early-abandoning verification (DESIGN.md §8).

    Each kappa batch passes the running k-th best power sum to the
    abandoning kernel as the row's threshold (-inf for converged rows, which
    then load nothing); abandoned candidates come back +inf, so a stable
    sort of (R, batch) keeps exactly what the full scan keeps. Also returns
    n_dim_frac, the scanned share of the offered dimension-work.

    With (x_scan, perm), the energy-ordered view (energy_perm), the kappa
    batches scan Q[:, perm] against x_scan = X[:, perm]: Lp is separable,
    so only the summation order changes, while the mass comes first and
    the thresholds trip sooner. The first k stay on (Q, X).
    """
    Qs = Q if perm is None else Q[:, perm]
    Xs = X if x_scan is None else x_scan
    B, t = cand_ids.shape
    d = Q.shape[1]
    n_batches = max((t - k) // kappa, 0)
    p_col = p if is_static_p(p) else p[:, None]
    first = cand_ids[:, :k]
    r_dist, r_ids = _sort_by_dist(lp_gather_distance(Q, first, X, p), first)
    n_p = torch.full((B,), k, dtype=torch.int32, device=Q.device)
    ones = torch.ones(B, device=Q.device)
    if n_batches == 0:
        return r_ids, lp_root(r_dist, p_col), n_p, 0, ones
    dim_scan = ones * (k * d)
    done = torch.zeros(B, dtype=torch.bool, device=Q.device)
    i = 0
    while i < n_batches and not bool(done.all()):
        sl = slice(k + i * kappa, k + (i + 1) * kappa)
        batch = cand_ids[:, sl]
        thresh = torch.where(done, -torch.inf, r_dist[:, k - 1])
        bd, nd = lp_gather_abandon(Qs, batch, Xs, thresh, cand_base[:, sl], p,
                                   base_p=base_p, block_d=block_d)
        new_dist, new_ids = _sort_by_dist(torch.cat([r_dist, bd], 1),
                                          torch.cat([r_ids, batch], 1))
        dim_scan = dim_scan + torch.where(done, 0.0, nd.sum(1).to(torch.float32))
        r_ids, r_dist, done, n_p = _converge(r_ids, r_dist, new_ids[:, :k],
                                             new_dist[:, :k], done, n_p, k, kappa, tau)
        i += 1
    # n_p accrues kappa under the same mask as dim_scan: offered work = n_p * d
    return (r_ids, lp_root(r_dist, p_col), n_p, i,
            dim_scan / (n_p.to(torch.float32) * d))


def _verify_two_band_impl(Q, cand_ids, cand_base, X, band, p, k: int, kappa: int,
                          tau: float, base_p: float, block_d: int | None):
    """Two-band verification (DESIGN.md §10): int8 screen, then an exact
    f32 rescore of the survivors.

    The protocol of `_verify_abandon_impl`, but each kappa batch first goes
    through the band's screen: a candidate whose certified lower bound
    already exceeds the running k-th best can never enter R, so it is
    dropped before any f32 gather; the survivors are scored full-dimension
    from f32 rows by the gather kernel. Ids and dists therefore equal the
    abandon=False path. Returns (ids, rooted dists, n_p, iterations,
    n_dim_frac, n_f32_rows_frac, n_band_frac).
    """
    B, t = cand_ids.shape
    d = Q.shape[1]
    n_batches = max((t - k) // kappa, 0)
    p_col = p if is_static_p(p) else p[:, None]
    Qp = Q[:, band.perm]
    first = cand_ids[:, :k]
    r_dist, r_ids = _sort_by_dist(lp_gather_distance(Q, first, X, p), first)
    n_p = torch.full((B,), k, dtype=torch.int32, device=Q.device)
    ones = torch.ones(B, device=Q.device)
    zeros = torch.zeros(B, device=Q.device)
    if n_batches == 0:
        return r_ids, lp_root(r_dist, p_col), n_p, 0, ones, ones, zeros
    dim_scan = ones * (k * d)
    f32_rows = ones * k
    band_scan = zeros
    done = torch.zeros(B, dtype=torch.bool, device=Q.device)
    i = 0
    while i < n_batches and not bool(done.all()):
        sl = slice(k + i * kappa, k + (i + 1) * kappa)
        batch = cand_ids[:, sl]
        thresh = torch.where(done, -torch.inf, r_dist[:, k - 1])
        keep, nd8 = lp_gather_screen(Qp, batch, band.codes, band.scale, band.radius, thresh,
                                     cand_base[:, sl], p, base_p=base_p, block_d=block_d)
        # screened-out slots become padding: +inf without a gather
        bd = lp_gather_distance(Q, torch.where(keep, batch, -1), X, p)
        new_dist, new_ids = _sort_by_dist(torch.cat([r_dist, bd], 1),
                                          torch.cat([r_ids, batch], 1))
        n_kept = keep.sum(1).to(torch.float32)
        live = ~done
        dim_scan = dim_scan + torch.where(live, n_kept * d, 0.0)
        f32_rows = f32_rows + torch.where(live, n_kept, 0.0)
        band_scan = band_scan + torch.where(live, nd8.sum(1).to(torch.float32), 0.0)
        r_ids, r_dist, done, n_p = _converge(r_ids, r_dist, new_ids[:, :k],
                                             new_dist[:, :k], done, n_p, k, kappa, tau)
        i += 1
    n_p_f = n_p.to(torch.float32)
    return (r_ids, lp_root(r_dist, p_col), n_p, i, dim_scan / (n_p_f * d),
            f32_rows / n_p_f, band_scan / (n_p_f * d))


def verify_candidates(Q, cand_ids, X, p, k: int, kappa: int, tau: float,
                      interpret: bool | None = None, *,
                      cand_base=None, base_p: float = 1.0, abandon: bool = True,
                      block_d: int | None = None, band=None, x_scan=None, scan_perm=None):
    """Early-terminated exact-Lp re-ranking (Algorithm 1 lines 7-11).

    Returns (ids (B, k) int32, rooted dists (B, k) f32, n_p (B,) int32,
    iterations, n_dim_frac (B,) f32, n_f32_rows_frac (B,) f32,
    n_band_frac (B,) f32); the last two are 1 and 0 off the two-band path.
    p is a Python float, or a (B,) tensor re-ranking row i under p[i] (each
    row the same as the scalar call at its p). cand_base (the beam's
    base-metric power sums, metric base_p) enables the entry/suffix bounds
    of the abandoning scan; None disables them. With abandon, `band` (an
    `index.compressed.CompressedBand`) switches to the two-band scan, and
    (x_scan, scan_perm) run the abandoning scan in energy order instead.
    Candidate ids outside [0, n) are padding and score +inf. `interpret`
    is the reference's kernel override, taken at its place and ignored.
    """
    if not is_static_p(p):
        p = torch.broadcast_to(metrics.as_p_vec(p, Q.device), (Q.shape[0],))
    else:
        p = float(p)
    ones = torch.ones(Q.shape[0], device=Q.device)
    zeros = torch.zeros(Q.shape[0], device=Q.device)
    if abandon and cand_base is None:
        cand_base = torch.zeros(cand_ids.shape, device=Q.device)
    if abandon and band is not None:
        return _verify_two_band_impl(Q, cand_ids, cand_base, X, band, p, k, kappa, tau,
                                     float(base_p), block_d)
    if abandon:
        out = _verify_abandon_impl(Q, cand_ids, cand_base, X, p, k, kappa, tau,
                                   float(base_p), block_d, x_scan, scan_perm)
        return (*out, ones, zeros)
    ids, dists, n_p, iters = _verify_impl(Q, cand_ids, X, p, k, kappa, tau)
    return ids, dists, n_p, iters, ones, ones, zeros


def mask_base_rows(cand_ids, cand_dists, ids, dists, n_p, p_vec, base_p, k: int,
                   n_dim_frac=None, n_f32_frac=None, n_band_frac=None):
    """Per-row base-metric skip inside a mixed batch: rows whose p equals the
    base metric take the beam's own order (the values the scalar skip path
    gives) and report n_p = 0 and, when given, the skip path's counters
    (n_dim_frac and n_f32_frac 1, n_band_frac 0). Returns 3, 4 or 6 values
    by the counters given (the 6-value form needs all three)."""
    p = metrics.as_p_vec(p_vec, ids.device)
    is_base = p == base_p
    ids = torch.where(is_base[:, None], cand_ids[:, :k], ids)
    dists = torch.where(is_base[:, None], lp_root(cand_dists[:, :k], p[:, None]), dists)
    n_p = torch.where(is_base, 0, n_p).to(torch.int32)
    if n_dim_frac is None:
        return ids, dists, n_p
    frac = torch.where(is_base, 1.0, n_dim_frac)
    if n_f32_frac is None:
        return ids, dists, n_p, frac
    return (ids, dists, n_p, frac, torch.where(is_base, 1.0, n_f32_frac),
            torch.where(is_base, 0.0, n_band_frac))


def two_way_mixed_search(Q, p, k: int, cutoff: float, search_base_vec):
    """Mixed-p search: partition the batch two ways (G1 rows / G2 rows),
    run one per-row-p search on each side, scatter back to request order.

    search_base_vec(Q_sub (B', d), p_sub (B',) numpy f32, k, base_p) returns
    (ids, dists, n_p, iters, n_b, hops, n_dim_frac, n_f32_rows_frac,
    n_band_frac) for one side, optionally followed by the phase split
    (n_b_probe, n_b_spill, n_p_probe, n_p_spill), which the sharded index
    appends (absent: all probe), and a 14th element, the per-row poisoned
    flag (absent: all clean). Returns (ids (B, k), dists (B, k), SearchStats)
    with stats.base_p the (B,) host array of base metrics.
    """
    b = Q.shape[0]
    if torch.is_tensor(p):
        p = p.detach().cpu().numpy()
    p_arr = np.asarray(p, dtype=np.float32).reshape(-1)
    if p_arr.size == 1:
        p_arr = np.full(b, p_arr[0], dtype=np.float32)
    if p_arr.shape[0] != b:
        raise ValueError(f"p has {p_arr.shape[0]} rows for a batch of {b}")
    base = np.asarray(metrics.base_metric_for(p_arr, cutoff))
    dev = Q.device
    if b == 0:
        zi = torch.zeros((0,), dtype=torch.int32, device=dev)
        zf = torch.zeros((0,), device=dev)
        return (torch.zeros((0, k), dtype=torch.int32, device=dev),
                torch.zeros((0, k), device=dev),
                SearchStats(n_b=zi, n_p=zi, iterations=0, base_p=base, hops=zi,
                            n_dim_frac=zf, n_f32_rows_frac=zf, n_band_frac=zf))
    sels, parts, iters = [], [], 0
    for base_p in (1.0, 2.0):
        sel = np.flatnonzero(base == base_p)
        if sel.size == 0:
            continue
        res = search_base_vec(Q[torch.from_numpy(sel).to(dev)], p_arr[sel], k, base_p)
        s_ids, s_dists, s_np, s_it, s_nb, s_hops, s_frac, s_f32, s_band = res[:9]
        if len(res) > 9:
            phases = tuple(res[9:13])
        else:
            phases = (s_nb, torch.zeros_like(s_nb), s_np, torch.zeros_like(s_np))
        pois = res[13] if len(res) > 13 else torch.zeros_like(s_frac)
        sels.append(sel)
        parts.append((s_ids, s_dists, s_np, s_nb, s_hops, s_frac, s_f32, s_band, *phases,
                      pois))
        iters = max(iters, int(s_it))
    if len(parts) == 1:
        cols = parts[0]
    else:
        inv = np.empty(b, np.int64)
        inv[np.concatenate(sels)] = np.arange(b)
        inv = torch.from_numpy(inv).to(dev)
        cols = tuple(torch.cat(xs, 0)[inv] for xs in zip(*parts))
    ids, dists, n_p, n_b, hops, frac, f32f, bandf, nb_pr, nb_sp, np_pr, np_sp, pois = cols
    return ids, dists, SearchStats(n_b=n_b, n_p=n_p, iterations=iters, base_p=base,
                                   hops=hops, n_dim_frac=frac, n_b_probe=nb_pr,
                                   n_b_spill=nb_sp, n_p_probe=np_pr, n_p_spill=np_sp,
                                   n_f32_rows_frac=f32f, n_band_frac=bandf, poisoned=pois)


def modeled_query_cost(stats: SearchStats, p, d: int) -> dict:
    """T_query = N_b * T_b + N_p * (n_dim_frac * T_p) (paper Eq. 1 with the
    adaptive-T_p correction) under the op-cost model of `core.metrics`.
    p and stats.base_p may be scalars or (B,) arrays (batch means)."""
    if torch.is_tensor(p):
        p = p.detach().cpu().numpy()
    t_b = float(np.mean([metrics.lp_distance_cost_model(float(bp), d)
                         for bp in np.atleast_1d(stats.base_p)]))
    t_p = float(np.mean([metrics.lp_distance_cost_model(float(pp), d)
                         for pp in np.atleast_1d(np.asarray(p))]))
    n_b = float(torch.as_tensor(stats.n_b, dtype=torch.float64).mean())
    n_p_row = torch.as_tensor(stats.n_p, dtype=torch.float64).cpu().numpy()
    n_p = float(n_p_row.mean())
    frac_row = np.broadcast_to(
        torch.as_tensor(stats.n_dim_frac, dtype=torch.float64).cpu().numpy(), n_p_row.shape)
    # N_p-weighted per row: rows that skipped verification must not dilute it
    weighted = float(np.mean(n_p_row * frac_row))
    frac = weighted / n_p if n_p > 0 else 1.0
    return {"N_b": n_b, "N_p": n_p, "T_b": t_b, "T_p": t_p, "n_dim_frac": frac,
            "total": n_b * t_b + weighted * t_p}


class UHNSW:
    """The paper's index: two HNSW graphs, G1 under L1 and G2 under L2.

    `search(Q, p, k)`: batched ANNS-U-Lp (Algorithm 1). Q (B, d); p a Python
    float (one metric for the batch) or (B,) array (one per row). Returns
    (ids (B, k) int32, rooted dists (B, k) f32, SearchStats). Everything
    runs on the device of the graphs' data. Supported p range is [0.5, 2].
    """

    def __init__(self, g1: HNSWGraph, g2: HNSWGraph, params: UHNSWParams | None = None):
        if g1.metric_p != 1.0 or g2.metric_p != 2.0:
            raise ValueError("UHNSW needs G1 under L1 and G2 under L2")
        self.g1, self.g2 = g1, g2
        self.params = params or UHNSWParams()
        self.X = g1.data
        self.arrays1 = GraphArrays.from_graph(g1)
        self.arrays2 = GraphArrays.from_graph(g2)
        # verification-scan caches (DESIGN.md §10), built at first use and
        # deterministic from X: the int8 band and the energy-ordered view
        self._band = None
        self._scan_cache = None

    @property
    def dim(self) -> int:
        return int(self.X.shape[1])

    def compressed_band(self):
        """The int8 `CompressedBand` over X, built at first use."""
        if self._band is None:
            # imported here: repro_torch.index imports this module
            from repro_torch.index.compressed import build_band

            self._band = build_band(self.X)
        return self._band

    def _scan_view(self):
        """(x_scan, perm): the energy-ordered corpus view for energy_perm."""
        if self._scan_cache is None:
            from repro_torch.index.compressed import energy_order

            perm = torch.from_numpy(energy_order(self.X).astype(np.int64)).to(self.X.device)
            self._scan_cache = (self.X[:, perm].contiguous(), perm)
        return self._scan_cache

    def _verify_extras(self) -> dict:
        """The band or scan-view arguments of `verify_candidates` under the
        current params (none when both are off or abandon is)."""
        prm = self.params
        if not prm.abandon:
            return {}
        if prm.compressed_band:
            return {"band": self.compressed_band()}
        if prm.energy_perm:
            x_scan, perm = self._scan_view()
            return {"x_scan": x_scan, "scan_perm": perm}
        return {}

    @classmethod
    def build(cls, data, m: int = 32, ef_construction: int = 500, seed: int = 0,
              params: UHNSWParams | None = None, progress_every: int = 0,
              method: str = "incremental", *, device=None) -> "UHNSW":
        """Builds G1 under L1 and G2 under L2 and wraps them.

        method:
          * "incremental": the sequential insertion builder (`core.build.
            build_hnsw`; G1 from seed, G2 from seed + 1), ef_construction
            applies. About 30 ms a point on the host.
          * "bulk": the shared-pass builder (`core.bulk_build.
            build_bulk_pair`): both graphs from one candidate pass, dense
            steps and scoring on the device.
          * "bulk_host": the per-graph bulk builder (`core.build.
            build_hnsw_bulk`), dense steps on the device.
        ef_construction is ignored by both bulk methods. device: where the
        graphs and the data live (None: the tensor's device, or "cuda" for
        a numpy array).
        """
        if method == "bulk":
            g1, g2 = build_bulk_pair(data, m=m, seed=seed, progress_every=progress_every,
                                     device=device)
            return cls(g1, g2, params)
        if method == "bulk_host":
            g1 = build_hnsw_bulk(data, 1.0, m=m, seed=seed, progress_every=progress_every,
                                 device=device)
            g2 = build_hnsw_bulk(g1.data, 2.0, m=m, seed=seed + 1,
                                 progress_every=progress_every)
            return cls(g1, g2, params)
        if method != "incremental":
            raise ValueError(f"unknown build method {method!r} "
                             "(options: 'incremental', 'bulk', 'bulk_host')")
        g1 = build_hnsw(data, 1.0, m, ef_construction, seed, progress_every=progress_every,
                        device=device)
        g2 = build_hnsw(g1.data, 2.0, m, ef_construction, seed + 1,
                        progress_every=progress_every)
        return cls(g1, g2, params)

    def index_size_bytes(self, p_range_max: float = 2.0) -> int:
        """Index size without the data; G1 alone when only p <= 1 is served."""
        if p_range_max <= 1.0:
            return self.g1.index_size_bytes()
        return self.g1.index_size_bytes() + self.g2.index_size_bytes()

    def base_graph_for(self, p: float) -> tuple[GraphArrays, float]:
        """Scalar-p base-graph pick (paper Alg. 1 line 3): G1 iff p <= cutoff."""
        base = metrics.base_metric_for(p, self.params.cutoff)
        return (self.arrays1, 1.0) if base == 1.0 else (self.arrays2, 2.0)

    def _queries(self, Q) -> torch.Tensor:
        return torch.as_tensor(Q, dtype=torch.float32, device=self.X.device)

    def search(self, Q, p, k: int):
        """Batched ANNS-U-Lp query (Algorithm 1); see the class docstring.

        A mixed-p batch is partitioned two ways by base graph and each side
        runs one per-row-p search; each row's result equals the scalar call
        at its p.
        """
        Q = self._queries(Q)
        if is_static_p(p):
            _, base_p = self.base_graph_for(float(p))
            cands = self.search_stage_candidates(Q, base_p, k)
            return self.search_stage_finish(Q, cands, float(p), k)
        return two_way_mixed_search(Q, p, k, self.params.cutoff, self._search_base_vec)

    def search_stage_candidates(self, Q, base_p: float, k: int | None = None) -> CandidateSet:
        """Stage 1 of 2: base-metric candidate generation (Alg. 1 lines 1-6).

        k is taken for the signature of `ShardedUHNSW.search_stage_candidates`,
        which sizes its pruning bound with it; one graph has no use for it.
        """
        del k
        prm = self.params
        Q = self._queries(Q)
        arrays = self.arrays1 if base_p == 1.0 else self.arrays2
        ef = max(prm.ef or 2 * prm.t, prm.t)
        ids, dists, n_b, hops = knn_search(arrays, self.X, Q, ef=ef, t=prm.t,
                                           max_hops=prm.max_hops,
                                           expand_width=min(prm.expand_width, ef))
        return CandidateSet(ids=ids, base_dists=dists, n_b=n_b, hops=hops, base_p=base_p)

    def search_stage_finish(self, Q, cands: CandidateSet, p, k: int):
        """Stage 2 of 2: verification, or the skip when p is the base metric.

        p: a float (the skip path when it equals cands.base_p), or a (B,)
        array with the per-row skip. Returns (ids, dists, SearchStats).
        """
        prm = self.params
        Q = self._queries(Q)
        base_p = cands.base_p
        if is_static_p(p) and float(p) == base_p:
            ones = torch.ones(cands.n_b.shape, device=Q.device)
            return cands.ids[:, :k], lp_root(cands.base_dists[:, :k], float(p)), SearchStats(
                n_b=cands.n_b, n_p=torch.zeros_like(cands.n_b), iterations=0,
                base_p=base_p, hops=cands.hops, n_dim_frac=ones, n_f32_rows_frac=ones,
                n_band_frac=torch.zeros_like(ones))
        kappa = prm.kappa or max(k // 2, 1)
        if not is_static_p(p):
            p = metrics.as_p_vec(p, Q.device)
        ids, dists, n_p, iters, frac, f32f, bandf = verify_candidates(
            Q, cands.ids, self.X, p, k, kappa, prm.tau, cand_base=cands.base_dists,
            base_p=base_p, abandon=prm.abandon, block_d=prm.abandon_block_d,
            **self._verify_extras())
        if not is_static_p(p):
            ids, dists, n_p, frac, f32f, bandf = mask_base_rows(
                cands.ids, cands.base_dists, ids, dists, n_p, p, base_p, k,
                n_dim_frac=frac, n_f32_frac=f32f, n_band_frac=bandf)
        return ids, dists, SearchStats(n_b=cands.n_b, n_p=n_p, iterations=iters,
                                       base_p=base_p, hops=cands.hops, n_dim_frac=frac,
                                       n_f32_rows_frac=f32f, n_band_frac=bandf)

    def _search_base_vec(self, Q, p_vec, k: int, base_p: float):
        cands = self.search_stage_candidates(Q, base_p, k)
        ids, dists, st = self.search_stage_finish(Q, cands, p_vec, k)
        return (ids, dists, st.n_p, st.iterations, st.n_b, st.hops, st.n_dim_frac,
                st.n_f32_rows_frac, st.n_band_frac)

    def modeled_query_cost(self, stats: SearchStats, p, d: int) -> dict:
        return modeled_query_cost(stats, p, d)


def recall(pred_ids, true_ids) -> float:
    """Top-K recall |S* ∩ S| / K over the batch (paper §4.1.2); negative ids
    are padding and count on neither side."""
    pred = pred_ids.cpu().numpy() if torch.is_tensor(pred_ids) else np.asarray(pred_ids)
    true = true_ids.cpu().numpy() if torch.is_tensor(true_ids) else np.asarray(true_ids)
    valid_t = true >= 0
    eq = (true[:, :, None] == pred[:, None, :]) & valid_t[:, :, None] \
        & (pred >= 0)[:, None, :]
    return int(eq.any(-1).sum()) / max(int(valid_t.sum()), 1)
