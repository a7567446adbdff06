"""Batched beam search over a frozen HNSW graph.

Counterpart of `repro.core.hnsw`. Where the reference vmaps a per-query
`lax.while_loop`, every loop here steps all queries of the batch together
and carries a per-query active mask: a query whose own loop would have
ended keeps its state unchanged, so its results, N_b and hop count are what
its own loop would give.

  * upper layers: greedy descent (ef = 1), one batched loop per layer;
  * layer 0: ef-beam search with W-way multi-expansion, a per-query visited
    bitmask of 32-bit words, and the optional `thresh` admission cut.

Distances are base-metric (L1 / L2) power sums without the root, which
order the same. N_b counts every base-metric evaluation (paper Eq. 1).
There is no kernel of the reference on this path: it is plain PyTorch.
"""

from __future__ import annotations

import torch

from repro_torch.core.metrics import lp_distance, pairwise_lp


class GraphArrays:
    """Frozen device-resident HNSW topology; the padding sentinel is `n`.

    adj0 (n, m0) int64 level-0 neighbour ids; upper_adj[l-1] (n_l, m) int64
    global ids of level l; upper_g2l[l-1] (n,) int64 global -> local row of
    level l (-1 when absent); entry () int64, or (B,) int64 with one entry
    per query row (the folded segment stack of `index.sharded`).
    """

    def __init__(self, adj0, upper_adj, upper_g2l, entry, n: int, metric_p: float):
        self.adj0 = adj0
        self.upper_adj = tuple(upper_adj)
        self.upper_g2l = tuple(upper_g2l)
        self.entry = entry
        self.n = n
        self.metric_p = metric_p

    @classmethod
    def from_graph(cls, g) -> "GraphArrays":
        """Device topology of a built graph: a `core.build.HNSWGraph`'s
        adjacency repacked, or a `core.bulk_build.DeviceGraph`'s own
        `graph_arrays()` as it is."""
        if hasattr(g, "graph_arrays"):
            return g.graph_arrays()
        n = g.n

        def pad(a):
            a = a.to(torch.int64)
            return torch.where(a < 0, n, a)

        return cls(
            adj0=pad(g.adjacency[0]),
            upper_adj=[pad(a) for a in g.adjacency[1:]],
            upper_g2l=[a.to(torch.int64) for a in g.local_index[1:]],
            entry=torch.as_tensor(g.entry_point, dtype=torch.int64, device=g.data.device),
            n=n,
            metric_p=g.metric_p,
        )

    def pad_to(self, n_pad: int, n_levels: int, level_sizes: tuple[int, ...],
               upper_m: int | None = None) -> "GraphArrays":
        """Re-pad to a uniform shape so that segments can stack.

        Grows the node capacity to n_pad (sentinel n -> n_pad), the number
        of upper levels to n_levels and level l's rows to level_sizes[l].
        A missing level becomes one all-sentinel row that every node maps
        to, so a greedy hop there sees no valid neighbour and adds 0 to N_b.
        """
        if n_pad < self.n or n_levels < len(self.upper_adj):
            raise ValueError("pad_to can only grow the graph")
        old_n = self.n
        dev = self.adj0.device

        def repad(a, rows):
            a = torch.where(a == old_n, n_pad, a)
            out = torch.full((rows, a.shape[1]), n_pad, dtype=torch.int64, device=dev)
            out[: a.shape[0]] = a
            return out

        m = upper_m or (self.upper_adj[0].shape[1] if self.upper_adj
                        else self.adj0.shape[1])
        upper_adj, upper_g2l = [], []
        for l in range(n_levels):
            if l < len(self.upper_adj):
                upper_adj.append(repad(self.upper_adj[l], level_sizes[l]))
                g2l = torch.full((n_pad,), -1, dtype=torch.int64, device=dev)
                g2l[:old_n] = self.upper_g2l[l]
            else:
                upper_adj.append(torch.full((level_sizes[l], m), n_pad,
                                            dtype=torch.int64, device=dev))
                g2l = torch.zeros((n_pad,), dtype=torch.int64, device=dev)
            upper_g2l.append(g2l)
        return GraphArrays(repad(self.adj0, n_pad), upper_adj, upper_g2l,
                           self.entry, n_pad, self.metric_p)

    @staticmethod
    def stack(arrays: "list[GraphArrays]") -> "GraphArrays":
        """Stack same-shaped (pad_to'd) GraphArrays on a leading segment axis."""
        n, p = arrays[0].n, arrays[0].metric_p
        if any(a.n != n or a.metric_p != p for a in arrays):
            raise ValueError("stack needs graphs padded to one shape and one metric")
        levels = len(arrays[0].upper_adj)
        return GraphArrays(
            torch.stack([a.adj0 for a in arrays]),
            [torch.stack([a.upper_adj[l] for a in arrays]) for l in range(levels)],
            [torch.stack([a.upper_g2l[l] for a in arrays]) for l in range(levels)],
            torch.stack([a.entry for a in arrays]),
            n, p,
        )


def _base_dist(Q: torch.Tensor, rows: torch.Tensor, p: float) -> torch.Tensor:
    """Root-free base-metric distance of each query (B, d) to its rows (B, R, d)."""
    return lp_distance(Q[:, None, :], rows, p, root=False)


def _greedy_descend(Q, X, adj_l, g2l, ep, ep_dist, nb, p, max_hops):
    """Greedy ef=1 search on one upper layer. Returns (ep, ep_dist, nb)."""
    n = X.shape[0]
    go = torch.ones_like(ep, dtype=torch.bool)
    hops = torch.zeros_like(nb)
    while True:
        active = go & (hops < max_hops)
        if not bool(active.any()):
            return ep, ep_dist, nb
        nbrs = adj_l[g2l[ep]]                        # (B, m), pad = n
        valid = nbrs < n
        dv = _base_dist(Q, X[nbrs.clamp(max=n - 1)], p)
        dv = torch.where(valid, dv, torch.inf)
        dmin, j = torch.min(dv, dim=1)               # first occurrence of the min
        better = dmin < ep_dist
        ep = torch.where(active & better, nbrs.gather(1, j[:, None])[:, 0], ep)
        ep_dist = torch.where(active, torch.minimum(dmin, ep_dist), ep_dist)
        nb = nb + torch.where(active, valid.sum(1, dtype=torch.int32), 0)
        go = torch.where(active, better, go)
        hops = hops + active.to(hops.dtype)


def _greedy_descend_l0(Q, X, adj0, ep, ep_dist, nb, p, max_hops, thresh):
    """Greedy ef=1 descent on the level-0 adjacency before the admission cut.

    Used only with `thresh`: it walks downhill until the entry drops below
    the query's bound, so that a far-off entry whose neighbourhood lies
    entirely above the bound cannot strand the beam.
    """
    n = X.shape[0]
    go = ep_dist > thresh
    hops = torch.zeros_like(nb)
    while True:
        active = go & (hops < max_hops)
        if not bool(active.any()):
            return ep, ep_dist, nb
        nbrs = adj0[ep]
        valid = nbrs < n
        dv = _base_dist(Q, X[nbrs.clamp(max=n - 1)], p)
        dv = torch.where(valid, dv, torch.inf)
        dmin, j = torch.min(dv, dim=1)
        better = dmin < ep_dist
        d2 = torch.minimum(dmin, ep_dist)
        ep = torch.where(active & better, nbrs.gather(1, j[:, None])[:, 0], ep)
        ep_dist = torch.where(active, d2, ep_dist)
        nb = nb + torch.where(active, valid.sum(1, dtype=torch.int32), 0)
        go = torch.where(active, better & (d2 > thresh), go)
        hops = hops + active.to(hops.dtype)


def _bit_of(ids: torch.Tensor) -> torch.Tensor:
    return torch.bitwise_left_shift(torch.ones_like(ids), ids & 31)


def _beam_search_l0(Q, X, adj0, ep, ep_dist, nb, p, ef, max_hops, width=1, thresh=None):
    """Level-0 ef-beam search for the batch. Returns (ids, dists, nb, hops).

    Each hop expands the `width` (W) closest unexpanded beam entries of
    every active query: one gather of their W*m0 neighbours, a visited
    test-and-set on the bitmask, one base-metric distance block for the
    unseen ones and one stable sort to merge them into the beam. W = 1 is
    classic HNSW. With `thresh` (B,), a neighbour above its query's bound
    is counted in N_b and marked visited but never admitted to the beam.
    """
    B = Q.shape[0]
    n, m0 = X.shape[0], adj0.shape[1]
    dev = Q.device
    rows = torch.arange(B, device=dev)
    ids = torch.full((B, ef), n, dtype=torch.int64, device=dev)
    ids[:, 0] = ep
    dist = torch.full((B, ef), torch.inf, device=dev)
    dist[:, 0] = ep_dist
    # sentinel slots start "expanded" so they are never selected
    expd = torch.ones((B, ef), dtype=torch.bool, device=dev)
    expd[:, 0] = False
    # 32 visited bits per word, stored in int64 so that the test-and-set's
    # scatter-add of distinct bits never overflows
    visited = torch.zeros((B, (n + 31) // 32), dtype=torch.int64, device=dev)
    visited[rows, ep >> 5] = _bit_of(ep)
    hops = torch.zeros(B, dtype=torch.int32, device=dev)
    first = torch.ones((B, m0), dtype=torch.bool, device=dev)
    while True:
        open_ = ~expd & (ids < n)
        active = open_.any(1) & (hops < max_hops)
        if not bool(active.any()):
            break
        # 1. the W closest unexpanded entries (lowest index on ties)
        sel_key = torch.where(open_, dist, torch.inf)
        if width == 1:
            js = sel_key.argmin(1, keepdim=True)
        else:
            js = torch.sort(sel_key, dim=1, stable=True).indices[:, :width]
        sel_ok = torch.isfinite(sel_key.gather(1, js)) & active[:, None]
        expd = expd.scatter(1, js, active[:, None] | expd.gather(1, js))
        # 2. their neighbour lists; unselected slots contribute sentinels
        srcs = torch.where(sel_ok, ids.gather(1, js), n)
        nbrs = adj0[srcs.clamp(max=n - 1)]
        nbrs = torch.where(sel_ok[:, :, None], nbrs, n).reshape(B, -1)
        if width > 1:
            # the lists can share neighbours: sort + first-occurrence mask
            nbrs = torch.sort(nbrs, dim=1).values
            first = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                               nbrs[:, 1:] != nbrs[:, :-1]], dim=1)
        # 3. visited-bitmask test-and-set
        valid = nbrs < n
        safe = nbrs.clamp(max=n - 1)
        word = safe >> 5
        bit = _bit_of(safe)
        seen = (visited.gather(1, word) & bit) != 0
        new = valid & ~seen & first
        visited.scatter_add_(1, word, bit * new)
        # 4. base-metric distances of the unseen neighbours
        dv = _base_dist(Q, X[safe], p)
        dv = torch.where(new, dv, torch.inf)
        nb = nb + new.sum(1, dtype=torch.int32)
        if thresh is not None:
            dv = torch.where(dv <= thresh[:, None], dv, torch.inf)
        # 5. merge beam + frontier, keep the best ef; frontier entries join
        #    unexpanded unless their distance is inf
        all_dist = torch.cat([dist, dv], dim=1)
        sd, order = torch.sort(all_dist, dim=1, stable=True)
        order = order[:, :ef]
        keep = active[:, None]
        ids = torch.where(keep, torch.cat([ids, nbrs], 1).gather(1, order), ids)
        dist = torch.where(keep, sd[:, :ef], dist)
        expd = torch.where(keep, torch.cat([expd, torch.isinf(dv)], 1).gather(1, order), expd)
        hops = hops + active.to(torch.int32)
    return ids, dist, nb, hops


def _search_one(Q, X, arrays: GraphArrays, ef: int, max_hops: int, expand_width: int = 1,
                thresh=None):
    """The whole search for the batch (the reference's per-query `_search_one`,
    vmapped): greedy descent through the upper layers, top to bottom, then
    (with `thresh`) a greedy level-0 walk, then the level-0 beam."""
    p = arrays.metric_p
    ep = arrays.entry.expand(Q.shape[0]).clone()
    ep_dist = lp_distance(Q, X[ep], p, root=False)
    nb = torch.ones(Q.shape[0], dtype=torch.int32, device=Q.device)
    for adj_l, g2l in zip(reversed(arrays.upper_adj), reversed(arrays.upper_g2l)):
        ep, ep_dist, nb = _greedy_descend(Q, X, adj_l, g2l, ep, ep_dist, nb, p, max_hops)
    if thresh is not None:
        ep, ep_dist, nb = _greedy_descend_l0(Q, X, arrays.adj0, ep, ep_dist, nb, p,
                                             max_hops, thresh)
    return _beam_search_l0(Q, X, arrays.adj0, ep, ep_dist, nb, p, ef, max_hops,
                           width=expand_width, thresh=thresh)


def knn_search(arrays: GraphArrays, X: torch.Tensor, Q: torch.Tensor, ef: int, t: int,
               max_hops: int = 4096, expand_width: int = 1,
               thresh: torch.Tensor | None = None):
    """Batched t-NN search under the graph's base metric.

    Args:
      arrays: frozen topology (GraphArrays.from_graph), on X's device.
      X: (n, d) float32 corpus; Q: (B, d) float32 queries.
      ef: beam width (>= t); t: candidates returned per query.
      expand_width: W-way multi-expansion of the level-0 beam (1 = classic).
      thresh: optional (B,) per-query base-metric bounds (admission cut).

    Returns:
      ids (B, t) int32 sorted by base-metric distance; dists (B, t) root-free
      base-metric power sums; n_b (B,) int32 base-metric evaluations; hops
      (B,) int32 level-0 loop trips.
    """
    if ef < t:
        raise ValueError(f"ef={ef} must be >= t={t}")
    if not 1 <= expand_width <= ef:
        raise ValueError(f"expand_width must be in [1, ef]: got {expand_width}, ef={ef}")
    if thresh is not None:
        thresh = torch.as_tensor(thresh, dtype=torch.float32, device=Q.device)
    ids, dists, nb, hops = _search_one(Q, X, arrays, ef, max_hops, expand_width, thresh)
    return ids[:, :t].to(torch.int32), dists[:, :t], nb, hops


def exact_topk(X: torch.Tensor, Q: torch.Tensor, p: float, k: int, chunk: int = 8192):
    """Brute-force Lp top-k (ground truth for recall): (ids (B, k) int32, dists).

    Scans X in chunks and sort-merges into a running top-k. Where n < k the
    trailing slots hold id -1 with distance inf. For p != 2 the chunk is
    cut so that the (B, chunk, d) difference tensor stays under 1 GiB.
    """
    n, d = X.shape
    B = Q.shape[0]
    if float(p) != 2.0:
        chunk = max(1, min(chunk, (1 << 28) // max(B * d, 1)))
    best_d = torch.full((B, k), torch.inf, device=Q.device)
    best_i = torch.full((B, k), -1, dtype=torch.int64, device=Q.device)
    for start in range(0, n, chunk):
        xc = X[start:start + chunk]
        dc = pairwise_lp(Q, xc, p, root=False)
        ic = torch.arange(start, start + xc.shape[0], device=Q.device).expand(B, -1)
        sd, order = torch.sort(torch.cat([best_d, dc], 1), dim=1, stable=True)
        best_d = sd[:, :k]
        best_i = torch.cat([best_i, ic], 1).gather(1, order[:, :k])
    return best_i.to(torch.int32), best_d
