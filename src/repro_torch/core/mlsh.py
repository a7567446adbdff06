"""MLSH baseline (Lu & Kudo 2021): mixed p-stable LSH for ANNS-U-Lp, p <= 1.

Counterpart of `repro.core.mlsh`. Two QALSH-style query-aware LSH indexes,
one built with Cauchy projections (p-stable for L1) and one with symmetric
0.5-stable projections (for L0.5). A query (q, p) uses the index whose base
metric is closer to p (cutoff 0.75, the midpoint), then performs QALSH
virtual rehashing: count collisions inside a window around the query's
projection in each hash table, verify frequent points with exact Lp, and
expand the search radius until enough verified candidates are found.

The projection vectors come from the reference's numpy generator, so they
are bit-equal to the reference's. The projections, the sorted tables and
the collision counts live on the data's device, and a batch of queries
runs its radius-doubling rounds together: each query keeps its own rounds
and its own candidate set, and leaves the batch once it has enough. The
exact Lp verification is plain torch (it is no kernel in the reference
either). The projections are float32 products as in the reference; a
device that sums them in another order than numpy can put a projection on
the other side of a window's edge, which moves one collision count by one
and can change N_p by a few points (heavy-tailed 0.5-stable projections
are the most exposed).

The paper compares against *idealized* MLSH — only the Q2D Lp distance cost
N_p * T_p is charged (§4.1.4). N_p is counted exactly; T_p comes from the
same op-cost model as U-HNSW's (`metrics.lp_distance_cost_model`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.metrics import lp_distance_cost_model

# candidate rows gathered at once by the exact verification (f32 elements)
VERIFY_ELEMS = 1 << 26


def sym_stable(alpha: float, size, rng: np.random.Generator) -> np.ndarray:
    """Symmetric alpha-stable samples via Chambers-Mallows-Stuck."""
    if alpha == 1.0:
        return rng.standard_cauchy(size).astype(np.float32)
    theta = rng.uniform(-np.pi / 2, np.pi / 2, size)
    w = rng.exponential(1.0, size)
    num = np.sin(alpha * theta)
    den = np.cos(theta) ** (1.0 / alpha)
    tail = (np.cos(theta * (1.0 - alpha)) / w) ** ((1.0 - alpha) / alpha)
    return (num / den * tail).astype(np.float32)


def _median(t: torch.Tensor) -> float:
    """numpy's median of a flat float32 tensor: the mean of the two middle
    values when the count is even."""
    v = torch.sort(t.reshape(-1)).values
    n = v.numel()
    if n % 2:
        return float(v[n // 2])
    return float((v[n // 2 - 1:n // 2 + 1].sum() / 2).item())


@dataclass
class _QalshIndex:
    """One query-aware p-stable LSH index (QALSH, Huang et al. 2017)."""

    p: float
    a: torch.Tensor            # (m, d) projection vectors
    proj_sorted: torch.Tensor  # (m, n) data projections, sorted per hash
    order: torch.Tensor        # (m, n) int32 argsort of projections per hash
    w: float                   # bucket width
    freq_threshold: int        # collision-count threshold l

    @classmethod
    def build(cls, data: torch.Tensor, p: float, m: int, seed: int, w: float | None = None,
              freq_frac: float = 0.5):
        """data (n, d) float32 on its device; the projection vectors from
        np.random.default_rng(seed), as the reference draws them. The sort
        of each table is stable; the reference's is not, which can only
        reorder equal projections and never changes a candidate set."""
        n, d = data.shape
        rng = np.random.default_rng(seed)
        a = torch.from_numpy(sym_stable(p, (m, d), rng)).to(data.device)
        proj = a @ data.T  # (m, n)
        proj_sorted, order = torch.sort(proj, dim=1, stable=True)
        if w is None:
            # scale-adaptive bucket width: median nn-projection gap times a
            # constant; QALSH uses w ~ 2.719 for L2 / 2.0 for L1 on unit data
            spread = _median(torch.abs(torch.diff(proj_sorted, dim=1)))
            w = float(np.float32(spread) * np.float32(64.0))
        return cls(p=p, a=a, proj_sorted=proj_sorted.contiguous(),
                   order=order.to(torch.int32), w=w,
                   freq_threshold=max(1, int(m * freq_frac)))

    def ranks(self) -> torch.Tensor:
        """(m, n) int32: each point's position in each sorted table (the
        inverse of `order`)."""
        m, n = self.order.shape
        pos = torch.arange(n, dtype=torch.int32, device=self.order.device).expand(m, n)
        return torch.empty_like(self.order).scatter_(1, self.order.long(), pos)

    def collision_counts(self, qp: torch.Tensor, radius: float,
                         ranks: torch.Tensor | None = None) -> torch.Tensor:
        """(B, n) int32: for each query projection row qp (B, m), how many of
        the m hash tables put each point inside the window of half-width
        w * radius / 2 around it: the points whose sorted positions lie in
        [searchsorted(left edge), searchsorted(right edge)). ranks: `ranks()`,
        if the caller has it."""
        half = self.w * radius / 2.0
        ranks = self.ranks() if ranks is None else ranks
        qt = qp.T.contiguous()
        lo = torch.searchsorted(self.proj_sorted, qt - half, side="left").to(torch.int32)
        hi = torch.searchsorted(self.proj_sorted, qt + half, side="right").to(torch.int32)
        counts = torch.zeros((qp.shape[0], ranks.shape[1]), dtype=torch.int32, device=qp.device)
        for i in range(ranks.shape[0]):
            r = ranks[i][None, :]
            counts += (r >= lo[i][:, None]) & (r < hi[i][:, None])
        return counts

    def candidates(self, q, radius: float) -> torch.Tensor:
        """Ids whose projection collides with q's in >= l of m hash tables."""
        q = torch.as_tensor(q, dtype=torch.float32, device=self.a.device)
        counts = self.collision_counts((q @ self.a.T)[None], radius)[0]
        return torch.nonzero(counts >= self.freq_threshold)[:, 0]


@dataclass
class MLSHStats:
    n_p: int               # exact Lp distance evaluations (the idealized cost)
    rounds: int            # virtual-rehashing rounds
    base_p: float          # which index served the query


class MLSH:
    """Two p-stable indexes (L1 + L0.5) with per-query index selection.

    data: (n, d) array or tensor; device: where the index lives and
    searches run (None: the tensor's own device, or "cuda" for an array).
    """

    def __init__(self, data, m: int = 32, seed: int = 0, cutoff: float = 0.75, *,
                 device=None):
        if device is None:
            device = data.device if torch.is_tensor(data) else "cuda"
        self.data = torch.as_tensor(data, dtype=torch.float32, device=device).contiguous()
        self.cutoff = cutoff
        self.idx1 = _QalshIndex.build(self.data, 1.0, m, seed)
        self.idx05 = _QalshIndex.build(self.data, 0.5, m, seed + 1)

    def index_size_bytes(self) -> int:
        total = 0
        for idx in (self.idx1, self.idx05):
            for t in (idx.proj_sorted, idx.order, idx.a):
                total += t.numel() * t.element_size()
        return total

    def _index_for(self, p: float) -> _QalshIndex:
        if not 0.5 <= p <= 1.0:
            raise ValueError("MLSH supports 0.5 <= p <= 1 only (paper §4.2)")
        return self.idx05 if p < self.cutoff else self.idx1

    def search_batch_stats(self, Q, p: float, k: int, cand_factor: float = 10.0,
                           max_rounds: int = 12):
        """Top-k under Lp for each row of Q (B, d) -> (ids (B, k) int64,
        dists (B, k) f32 rooted, [MLSHStats per row]). Each row runs the
        reference's rounds: the window doubles until the row's candidates
        reach `need` or max_rounds pass; a row left with fewer than k
        candidates verifies every point."""
        idx = self._index_for(p)
        Q = torch.as_tensor(Q, dtype=torch.float32, device=self.data.device)
        b, n = Q.shape[0], self.data.shape[0]
        need = int(min(max(cand_factor * k, 2 * k), n))
        qp = Q @ idx.a.T                                     # (B, m)
        hits = torch.zeros((b, n), dtype=torch.bool, device=Q.device)
        n_cand = torch.zeros(b, dtype=torch.int64, device=Q.device)
        rounds = torch.zeros(b, dtype=torch.int64, device=Q.device)
        active = torch.arange(b, device=Q.device)
        ranks = idx.ranks()
        radius, r = 1.0, 0
        while active.numel() and r < max_rounds:
            hit = idx.collision_counts(qp[active], radius, ranks) >= idx.freq_threshold
            hits[active] = hit
            n_cand[active] = hit.sum(dim=1)
            rounds[active] = r + 1
            active = active[n_cand[active] < need]
            radius *= 2.0
            r += 1
        hits[n_cand < k] = True           # degenerate fallback: verify everything
        ids, dists = self._verify(Q, hits, p, k)
        n_p = hits.sum(dim=1).tolist()
        stats = [MLSHStats(n_p=int(c), rounds=int(rd), base_p=idx.p)
                 for c, rd in zip(n_p, rounds.tolist())]
        return ids, dists, stats

    def _verify(self, Q: torch.Tensor, hits: torch.Tensor, p: float, k: int):
        """Exact Lp over each row's candidates (ascending ids), the k
        smallest by a stable sort (the reference's tie order) -> (ids,
        rooted dists). Rows go in groups whose padded candidate rows stay
        under VERIFY_ELEMS elements."""
        b, d = Q.shape
        counts = hits.sum(dim=1).tolist()
        ids_out = torch.empty((b, k), dtype=torch.int64, device=Q.device)
        d_out = torch.empty((b, k), dtype=torch.float32, device=Q.device)
        start = 0
        while start < b:
            width, stop = 0, start
            while stop < b and (stop == start or
                                (stop + 1 - start) * max(width, counts[stop]) * d <= VERIFY_ELEMS):
                width = max(width, counts[stop])
                stop += 1
            rows = hits[start:stop]
            # each row's candidate ids ascending, padded with n (sorts last)
            key = torch.where(rows, torch.arange(rows.shape[1], device=Q.device), rows.shape[1])
            cand = torch.sort(key, dim=1).values[:, :width]
            valid = cand < rows.shape[1]
            x = self.data[cand.clamp_max(rows.shape[1] - 1)]              # (g, width, d)
            s = (torch.abs(x - Q[start:stop, None, :]) ** p).sum(dim=-1)
            s = torch.where(valid, s, torch.inf)
            top_d, top = torch.sort(s, dim=1, stable=True)
            ids_out[start:stop] = torch.gather(cand, 1, top[:, :k])
            d_out[start:stop] = top_d[:, :k] ** (1.0 / p)
            start = stop
        return ids_out, d_out

    def search(self, q, p: float, k: int, cand_factor: float = 10.0, max_rounds: int = 12):
        """Top-k under Lp for one query. Returns (ids, dists, MLSHStats)."""
        q = torch.as_tensor(q, dtype=torch.float32, device=self.data.device)
        ids, dists, stats = self.search_batch_stats(q[None], p, k, cand_factor, max_rounds)
        return ids[0], dists[0], stats[0]

    def search_batch(self, Q, p: float, k: int):
        """(ids (B, k), rooted dists (B, k), N_p per row (B,) numpy)."""
        ids, dists, stats = self.search_batch_stats(Q, p, k)
        return ids, dists, np.array([s.n_p for s in stats])

    def idealized_query_cost(self, n_p: float, p: float, d: int) -> float:
        """Idealized MLSH cost = N_p * T_p (paper §4.1.4), same T_p model as
        U-HNSW's."""
        return float(n_p) * lp_distance_cost_model(p, d)
