"""HNSW graph container, the sequential builder and the host bulk builder
(paper §2.2).

Counterpart of `repro.core.build` (`HNSWGraph`, `build_hnsw`,
`build_hnsw_bulk` and its helpers). The sequential builder (`build_hnsw`)
is the reference's insertion loop, in NumPy on the host; its frozen graph
lands on the device asked for. The reference runs the whole bulk build in
NumPy on the host too; here its dense steps run in PyTorch on the device of
the data:

  * the exact L2 candidate pools (one chunked product + topk),
  * the exact-metric re-rank of the pools,
  * the pairwise distances of the heuristic prune and of the base-metric
    sort of the merged lists,
  * the nearest cross pair of the connectivity repair, in row chunks whose
    scratch stays under 1 GiB whatever n is.

The ragged steps stay on the host (NumPy): the symmetrize step, the top-up
and the reachability labelling of the repair.

Graph layout (frozen; tensors on the data's device):
  adjacency[0]   : (n, m0) int32 level-0 neighbour lists, padded with -1
  adjacency[l>0] : (n_l, m) int32 global ids for nodes with level >= l
  level_nodes[l] : (n_l,) int32 global ids present at level l
  local_index[l] : (n,) int32 global -> local map at level l (-1 when absent)
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.lp_ops import abs_pow

# Scratch budget of each chunk of the dense steps, in float32 elements
# (256 MiB; with its temporaries a chunk stays under 1 GiB).
_SCRATCH = 1 << 26


def _np_lp(q: np.ndarray, x: np.ndarray, p: float) -> np.ndarray:
    """Vectorized |q - x_i|_p^p over rows of x (no root: ordering-equivalent)."""
    d = np.abs(x - q)
    if p == 2.0:
        return np.einsum("nd,nd->n", d, d)
    if p == 1.0:
        return d.sum(axis=1)
    if p == 0.5:
        return np.sqrt(d).sum(axis=1)
    if p == 1.5:
        return (d * np.sqrt(d)).sum(axis=1)
    return (d**p).sum(axis=1)


@dataclass
class HNSWGraph:
    """A frozen HNSW index over `data` built under base metric L`metric_p`."""

    metric_p: float
    m: int
    m0: int
    ef_construction: int
    entry_point: int
    max_level: int
    adjacency: list[torch.Tensor]
    level_nodes: list[torch.Tensor]
    local_index: list[torch.Tensor]
    data: torch.Tensor
    levels: torch.Tensor

    @property
    def n(self) -> int:
        return self.data.shape[0]

    @property
    def d(self) -> int:
        return self.data.shape[1]

    def index_size_bytes(self) -> int:
        """Index size excluding the dataset (the paper's index-size metric)."""
        return sum(a.numel() * a.element_size()
                   for a in (*self.adjacency, *self.level_nodes, *self.local_index))


class _Builder:
    """The sequential insertion loop (Malkov & Yashunin), in NumPy on the host."""

    def __init__(self, data: np.ndarray, p: float, m: int, ef_construction: int,
                 seed: int, extend_candidates: bool):
        self.data = np.ascontiguousarray(data, dtype=np.float32)
        self.n, self.dim = self.data.shape
        self.p = p
        self.m = m
        self.m0 = 2 * m
        self.efc = ef_construction
        self.ml = 1.0 / math.log(m)
        self.rng = np.random.default_rng(seed)
        self.extend_candidates = extend_candidates

        self.levels = np.zeros(self.n, dtype=np.int32)
        # neighbors[l][i] is a Python list during build; frozen at the end.
        self.neighbors: list[dict[int, list[int]]] = [dict()]
        self.entry = -1
        self.max_level = -1

    # -- primitives ---------------------------------------------------------

    def _dist_many(self, q: np.ndarray, ids: np.ndarray) -> np.ndarray:
        return _np_lp(q, self.data[ids], self.p)

    def _search_layer(self, q: np.ndarray, eps: list[int], ef: int, level: int):
        """Classic ef-search on one layer; returns [(dist, id)] sorted asc."""
        adj = self.neighbors[level]
        visited = set(eps)
        dists = self._dist_many(q, np.array(eps, dtype=np.int64))
        cand = [(float(d), e) for d, e in zip(dists, eps)]  # min-heap
        heapq.heapify(cand)
        result = [(-float(d), e) for d, e in zip(dists, eps)]  # max-heap (neg)
        heapq.heapify(result)
        while len(result) > ef:
            heapq.heappop(result)
        while cand:
            d_c, c = heapq.heappop(cand)
            worst = -result[0][0]
            if d_c > worst and len(result) >= ef:
                break
            nbrs = [u for u in adj.get(c, ()) if u not in visited]
            if not nbrs:
                continue
            visited.update(nbrs)
            nd = self._dist_many(q, np.array(nbrs, dtype=np.int64))
            worst = -result[0][0]
            for dist, u in zip(nd, nbrs):
                dist = float(dist)
                if len(result) < ef or dist < worst:
                    heapq.heappush(cand, (dist, u))
                    heapq.heappush(result, (-dist, u))
                    if len(result) > ef:
                        heapq.heappop(result)
                    worst = -result[0][0]
        out = sorted((-nd, u) for nd, u in result)
        return out

    def _select_neighbors(self, q: np.ndarray, cands: list[tuple[float, int]],
                          m: int) -> list[int]:
        """HNSW heuristic neighbor selection (Alg. 4 of the HNSW paper)."""
        if len(cands) <= m:
            return [u for _, u in cands]
        selected: list[int] = []
        sel_vecs: list[np.ndarray] = []
        for d_q, u in cands:  # cands sorted ascending by distance to q
            if len(selected) >= m:
                break
            uv = self.data[u]
            if sel_vecs:
                d_sel = _np_lp(uv, np.stack(sel_vecs), self.p)
                if (d_sel < d_q).any():
                    continue  # u is closer to an already-selected point
            selected.append(u)
            sel_vecs.append(uv)
        if len(selected) < m:  # backfill with nearest skipped candidates
            skipped = [u for _, u in cands if u not in set(selected)]
            selected.extend(skipped[: m - len(selected)])
        return selected

    def _prune(self, u: int, level: int):
        """Re-select u's neighbor list if it overflowed m_level."""
        m_max = self.m0 if level == 0 else self.m
        adj = self.neighbors[level]
        lst = adj[u]
        if len(lst) <= m_max:
            return
        uv = self.data[u]
        arr = np.array(lst, dtype=np.int64)
        d = _np_lp(uv, self.data[arr], self.p)
        order = np.argsort(d, kind="stable")
        cands = [(float(d[i]), int(arr[i])) for i in order]
        adj[u] = self._select_neighbors(uv, cands, m_max)

    # -- insertion ----------------------------------------------------------

    def insert(self, idx: int):
        q = self.data[idx]
        level = int(-math.log(max(self.rng.random(), 1e-12)) * self.ml)
        self.levels[idx] = level
        while len(self.neighbors) <= level:
            self.neighbors.append(dict())
        for l in range(level + 1):
            self.neighbors[l][idx] = []

        if self.entry < 0:
            self.entry = idx
            self.max_level = level
            return

        ep = [self.entry]
        # zoom down through layers above the insertion level (greedy, ef=1)
        for l in range(self.max_level, level, -1):
            ep = [u for _, u in self._search_layer(q, ep, 1, l)[:1]]
        # insert at each layer from min(level, max_level) down to 0
        for l in range(min(level, self.max_level), -1, -1):
            w = self._search_layer(q, ep, self.efc, l)
            m_max = self.m0 if l == 0 else self.m
            nbrs = self._select_neighbors(q, w, m_max)
            adj = self.neighbors[l]
            adj[idx] = list(nbrs)
            for u in nbrs:
                adj[u].append(idx)
                self._prune(u, l)
            ep = [u for _, u in w]
        if level > self.max_level:
            self.max_level = level
            self.entry = idx

    # -- freeze ---------------------------------------------------------------

    def freeze(self, device) -> HNSWGraph:
        """The frozen graph, its tensors on `device`."""
        adjacency, level_nodes, local_index = [], [], []
        for l, adj in enumerate(self.neighbors):
            m_max = self.m0 if l == 0 else self.m
            if l == 0:
                nodes = np.arange(self.n, dtype=np.int32)
            else:
                nodes = np.array(sorted(adj.keys()), dtype=np.int32)
            mat = np.full((len(nodes), m_max), -1, dtype=np.int32)
            for row, u in enumerate(nodes):
                lst = adj.get(int(u), [])[:m_max]
                mat[row, : len(lst)] = lst
            g2l = np.full(self.n, -1, dtype=np.int32)
            g2l[nodes] = np.arange(len(nodes), dtype=np.int32)
            adjacency.append(torch.from_numpy(mat).to(device))
            level_nodes.append(torch.from_numpy(nodes).to(device))
            local_index.append(torch.from_numpy(g2l).to(device))
        return HNSWGraph(
            metric_p=self.p,
            m=self.m,
            m0=self.m0,
            ef_construction=self.efc,
            entry_point=self.entry,
            max_level=self.max_level,
            adjacency=adjacency,
            level_nodes=level_nodes,
            local_index=local_index,
            data=torch.from_numpy(self.data).to(device),
            levels=torch.from_numpy(self.levels).to(device),
        )


def build_hnsw(
    data,
    metric_p: float = 2.0,
    m: int = 32,
    ef_construction: int = 500,
    seed: int = 0,
    extend_candidates: bool = False,
    progress_every: int = 0,
    device=None,
) -> HNSWGraph:
    """Sequential HNSW construction under base metric L`metric_p`.

    The paper's G1/G2 settings are the defaults (M = 32, efConstruction =
    500). The insertion loop is the reference's, in NumPy on the host
    (about 30 ms a point: use `build_hnsw_bulk` or `core.bulk_build` at
    scale); the frozen graph's tensors land on `device` (None: the data
    tensor's own device, or "cuda" for a numpy array).
    """
    if device is None:
        device = data.device if torch.is_tensor(data) else "cuda"
    if torch.is_tensor(data):
        data = data.detach().cpu().numpy()
    b = _Builder(data, metric_p, m, ef_construction, seed, extend_candidates)
    for i in range(b.n):
        b.insert(i)
        if progress_every and (i + 1) % progress_every == 0:
            print(f"  hnsw build p={metric_p}: {i + 1}/{b.n}")
    return b.freeze(device)


def _rows_lp(q: torch.Tensor, rows: torch.Tensor, p: float) -> torch.Tensor:
    """Root-free |q_i - rows_ij|_p^p: q (c, d), rows (c, k, d) -> (c, k)."""
    return torch.sum(abs_pow(rows - q[:, None, :], p), dim=-1)


def _chunked_l2_topk(sub: torch.Tensor, pool: int) -> torch.Tensor:
    """Exact L2 top-`pool` local ids for each row of `sub`, self excluded,
    ascending by distance -> (nn, pool) int64."""
    nn = sub.shape[0]
    norms = torch.sum(sub * sub, dim=1)
    chunk = max(1, min(nn, _SCRATCH // nn))
    out = torch.empty((nn, pool), dtype=torch.int64, device=sub.device)
    for s in range(0, nn, chunk):
        e = min(s + chunk, nn)
        d2 = norms[s:e, None] + norms[None, :] - 2.0 * (sub[s:e] @ sub.T)
        r = torch.arange(e - s, device=sub.device)
        d2[r, r + s] = torch.inf
        vals, idx = torch.topk(d2, pool, dim=1, largest=False, sorted=True)
        order = torch.sort(vals, dim=1, stable=True).indices
        out[s:e] = idx.gather(1, order)
    return out


def _rerank_pool(sub: torch.Tensor, pool_ids: torch.Tensor, p: float, k: int):
    """Re-rank each row's candidate pool under exact L_p; keep the best k."""
    nn, pool = pool_ids.shape
    chunk = max(1, _SCRATCH // (pool * sub.shape[1]))
    ids = torch.empty((nn, k), dtype=torch.int64, device=sub.device)
    dists = torch.empty((nn, k), dtype=torch.float32, device=sub.device)
    for s in range(0, nn, chunk):
        e = min(s + chunk, nn)
        dd = _rows_lp(sub[s:e], sub[pool_ids[s:e]], p)
        sd, order = torch.sort(dd, dim=1, stable=True)
        ids[s:e] = pool_ids[s:e].gather(1, order[:, :k])
        dists[s:e] = sd[:, :k]
    return ids, dists


def _length_chunks(lengths: np.ndarray, per_row: "callable"):
    """Groups rows of similar list length: yields (rows, width) with rows
    sorted by length, width their longest list, and each group's scratch
    per_row(width) * len(rows) within _SCRATCH."""
    order = np.argsort(lengths, kind="stable")
    s = 0
    while s < len(order):
        width = max(int(lengths[order[s]]), 1)
        e = s + 1
        while e < len(order):
            w = max(int(lengths[order[e]]), 1)
            if per_row(w) * (e + 1 - s) > _SCRATCH:
                break
            width = w
            e += 1
        yield order[s:e], width
        s = e


def _vectorized_heuristic_prune(sub: torch.Tensor, cand_ids: torch.Tensor, m_max: int,
                                alpha: float = 1.0, backfill: bool = False) -> torch.Tensor:
    """HNSW heuristic selection (Alg. 4 of the HNSW paper), batched over rows.

    cand_ids (nn, k) local ids, each row ascending by base-metric distance
    to its node and -1 padded after its valid entries. In that order a
    candidate c is selected iff d(node, c) <= alpha * min over the already
    selected s of d(c, s), while fewer than m_max are selected. The rule's
    distances are L2^2 via the product identity whatever the base metric;
    the order is the exact base metric. backfill=True tops a row up with its
    nearest skipped candidates. Returns (nn, m_max) int64 local ids, -1 padded.
    Rows are processed in groups of similar length, so a few long lists do
    not widen the scratch of every row.
    """
    nn, kmax = cand_ids.shape
    dev = sub.device
    out = torch.full((nn, m_max), -1, dtype=torch.int64, device=dev)
    lengths = (cand_ids >= 0).sum(1).cpu().numpy()
    for rows_np, k in _length_chunks(lengths, lambda w: w * (w + sub.shape[1] + 4)):
        rows = torch.from_numpy(rows_np).to(dev)
        ids_blk = cand_ids[rows, :k]
        c = ids_blk.shape[0]
        valid = ids_blk >= 0
        cand_vec = sub[ids_blk.clamp(min=0)]                    # (c, k, d)
        node_vec = sub[rows]
        sq = torch.sum(cand_vec * cand_vec, dim=-1)
        nsq = torch.sum(node_vec * node_vec, dim=-1)
        d_u = torch.clamp_min(
            nsq[:, None] + sq - 2.0 * torch.bmm(cand_vec, node_vec[:, :, None])[..., 0], 0.0)
        d_u = torch.where(valid, d_u, torch.inf)
        pair = torch.clamp_min(
            sq[:, :, None] + sq[:, None, :] - 2.0 * torch.bmm(cand_vec, cand_vec.transpose(1, 2)),
            0.0)
        run_min = torch.full((c, k), torch.inf, device=dev)
        count = torch.zeros(c, dtype=torch.int64, device=dev)
        selected = torch.zeros((c, k), dtype=torch.bool, device=dev)
        for j in range(k):
            sel = valid[:, j] & (d_u[:, j] <= alpha * run_min[:, j]) & (count < m_max)
            selected[:, j] = sel
            count += sel
            run_min = torch.where(sel[:, None], torch.minimum(run_min, pair[:, j, :]), run_min)
        # selected in candidate order, then (backfill) the skipped valid ones
        pos = torch.arange(k, device=dev).expand(c, k)
        never = 2 * k + 1
        key = torch.where(selected, pos, never)
        if backfill:
            key = torch.where(valid & ~selected, k + pos, key)
        key, order = torch.sort(key, dim=1, stable=True)
        w = min(k, m_max)
        picked = torch.where(key[:, :w] < never, ids_blk.gather(1, order[:, :w]), -1)
        out[rows, :w] = picked
    return out


def _symmetrize(sel: np.ndarray) -> np.ndarray:
    """Row u gets sel[u] plus every v with u in sel[v]: (nn, L) int64, each
    row's ids ascending and distinct, -1 padded (the reference's np.unique
    of each merged list)."""
    nn, m = sel.shape
    u = np.repeat(np.arange(nn, dtype=np.int64), m)
    v = sel.reshape(-1)
    ok = v >= 0
    u, v = u[ok], v[ok]
    keys = np.unique(np.concatenate([u * nn + v, v * nn + u]))
    rows, cols = keys // nn, keys % nn
    counts = np.bincount(rows, minlength=nn)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    out = np.full((nn, max(int(counts.max(initial=0)), 1)), -1, dtype=np.int64)
    out[rows, np.arange(len(rows)) - starts[rows]] = cols
    return out


def _sort_ragged_by_base(sub: torch.Tensor, lists: np.ndarray, p: float) -> torch.Tensor:
    """Each row's ids (ascending, -1 padded) stably re-sorted by base-metric
    distance to the row's node -> (nn, L) int64 on sub's device."""
    dev = sub.device
    lists_t = torch.from_numpy(lists).to(dev)
    out = torch.full(lists.shape, -1, dtype=torch.int64, device=dev)
    lengths = (lists >= 0).sum(1)
    for rows_np, k in _length_chunks(lengths, lambda w: w * sub.shape[1]):
        rows = torch.from_numpy(rows_np).to(dev)
        ids_blk = lists_t[rows, :k]
        valid = ids_blk >= 0
        dd = _rows_lp(sub[rows], sub[ids_blk.clamp(min=0)], p)
        dd = torch.where(valid, dd, torch.inf)
        order = torch.sort(dd, dim=1, stable=True).indices
        out[rows, :k] = torch.where(valid.gather(1, order), ids_blk.gather(1, order), -1)
    return out


def _top_up(pruned: np.ndarray, cand: np.ndarray, chunk: int = 4096) -> None:
    """Fills each row's free slots, in place, with its nearest kNN-pool
    candidates that it does not hold yet (and that are not itself)."""
    nn, m_max = pruned.shape
    nsel = (pruned >= 0).sum(1)
    need_rows = np.flatnonzero(nsel < m_max)
    for s in range(0, len(need_rows), chunk):
        r = need_rows[s:s + chunk]
        c = cand[r]
        held = (c[:, :, None] == pruned[r][:, None, :]).any(-1) | (c == r[:, None])
        avail = ~held
        rank = np.cumsum(avail, axis=1)
        take = avail & (rank <= (m_max - nsel[r])[:, None])
        i, j = np.nonzero(take)
        pruned[r[i], nsel[r[i]] + rank[i, j] - 1] = c[i, j]


def _label_components(mat: np.ndarray, entry_local: int) -> tuple[np.ndarray, int]:
    """Reachability labels: 0 for what the entry reaches; then, for each
    still unlabelled node in index order, a new label for what it reaches
    through unlabelled nodes. Returns (labels, number of labels - 1)."""
    comp = np.full(mat.shape[0], -1, dtype=np.int64)

    def bfs(start: int, label: int) -> None:
        comp[start] = label
        frontier = np.array([start])
        while frontier.size:
            nxt = mat[frontier].reshape(-1)
            nxt = nxt[nxt >= 0]
            nxt = np.unique(nxt[comp[nxt] < 0])
            comp[nxt] = label
            frontier = nxt

    bfs(entry_local, 0)
    label = 0
    for u in np.flatnonzero(comp < 0):
        if comp[u] < 0:
            label += 1
            bfs(int(u), label)
    return comp, label


def _nearest_in(sub: torch.Tensor, members: np.ndarray, main: np.ndarray, p: float):
    """For each member, its nearest node of `main` under the base metric:
    (min distance (float32), first argmin (index into main)), numpy arrays.
    Chunked over members and main so the scratch stays within _SCRATCH
    elements whatever n is."""
    dev = sub.device
    d = sub.shape[1]
    main_vec = sub[torch.from_numpy(main).to(dev)]
    mm_all = torch.from_numpy(members).to(dev)
    M = main_vec.shape[0]
    per_pair = 1 if p == 2.0 else d   # the L2 identity needs no (r, M, d) tensor
    main_chunk = max(1, min(M, _SCRATCH // per_pair // 128))
    rows_chunk = max(1, min(len(members), _SCRATCH // (main_chunk * per_pair)))
    best_v = torch.full((len(members),), torch.inf, device=dev)
    best_j = torch.zeros((len(members),), dtype=torch.int64, device=dev)
    for s in range(0, len(members), rows_chunk):
        a = sub[mm_all[s:s + rows_chunk]]
        bv, bj = best_v[s:s + rows_chunk], best_j[s:s + rows_chunk]
        for t in range(0, M, main_chunk):
            b = main_vec[t:t + main_chunk]
            if p == 2.0:
                dd = torch.clamp_min(torch.sum(a * a, 1)[:, None] + torch.sum(b * b, 1)[None, :]
                                     - 2.0 * (a @ b.T), 0.0)
            else:
                dd = torch.sum(abs_pow(a[:, None, :] - b[None, :, :], p), dim=-1)
            v, j = torch.min(dd, dim=1)
            better = v < bv
            bv.copy_(torch.where(better, v, bv))
            bj.copy_(torch.where(better, j + t, bj))
    return best_v.cpu().numpy(), best_j.cpu().numpy()


def _repair_connectivity(mat: np.ndarray, sub: torch.Tensor, p: float,
                         entry_local: int) -> np.ndarray:
    """Bridges every component unreachable from the entry to the entry's.

    Per round: label reachability from the entry, then for each other
    component add a two-way edge along its nearest cross pair to the
    entry's component (replacing the farthest neighbour when a list is
    full, never a bridge). Bridge evictions can orphan nodes, so rounds
    repeat to a fixed point (at most 10).
    """
    protected: dict[int, set[int]] = {}

    def add_edge(a: int, b: int) -> None:
        row = mat[a]
        existing = np.flatnonzero(row == b)
        if len(existing):
            protected.setdefault(a, set()).add(int(existing[0]))
            return
        slot = np.flatnonzero(row < 0)
        if len(slot):
            chosen = int(slot[0])
        else:
            rows = torch.from_numpy(row.astype(np.int64)).to(sub.device)
            dd = _rows_lp(sub[a][None], sub[rows][None], p)[0].cpu().numpy()
            for s in protected.get(a, ()):
                dd[s] = -np.inf
            chosen = int(np.argmax(dd))
        row[chosen] = b
        protected.setdefault(a, set()).add(chosen)

    for _round in range(10):
        comp, label = _label_components(mat, entry_local)
        if label == 0:
            return mat
        main = np.flatnonzero(comp == 0)
        others = np.flatnonzero(comp > 0)
        near_v, near_j = _nearest_in(sub, others, main, p)
        for c_label in range(1, label + 1):
            idx = np.flatnonzero(comp[others] == c_label)   # members, ascending
            i = idx[np.argmin(near_v[idx])]                  # first of the minima
            u, v = int(others[i]), int(main[near_j[i]])
            add_edge(u, v)
            add_edge(v, u)
    return mat


def build_hnsw_bulk(
    data,
    metric_p: float = 2.0,
    m: int = 32,
    k_graph: int | None = None,
    pool_factor: int = 4,
    seed: int = 0,
    alpha: float = 1.2,
    progress_every: int = 0,
    device=None,
) -> HNSWGraph:
    """Vectorized bulk HNSW construction (see `repro.core.build`).

    Per level: exact kNN candidate pools (L2, re-ranked under the base
    metric when it is not L2), heuristic pruning, symmetrization, a second
    backfilled prune, a top-up from the pool, and a connectivity repair.

    data: (n, d) numpy array or tensor. device: where the dense steps and
    the graph live; None means the tensor's own device, or "cuda" for a
    numpy array.
    """
    if device is None:
        device = data.device if torch.is_tensor(data) else "cuda"
    X = torch.as_tensor(data, dtype=torch.float32, device=device).contiguous()
    n = X.shape[0]
    m0 = 2 * m
    k_graph = k_graph or m0
    rng = np.random.default_rng(seed)
    ml = 1.0 / math.log(m)
    levels = np.minimum(
        (-np.log(np.maximum(rng.random(n), 1e-12)) * ml).astype(np.int32), 30)
    max_level = int(levels.max())
    entry = int(np.argmax(levels))

    adjacency, level_nodes, local_index = [], [], []
    for l in range(max_level + 1):
        nodes = np.nonzero(levels >= l)[0].astype(np.int32)
        sub = X[torch.from_numpy(nodes).to(device)]
        nn = len(nodes)
        m_max = m0 if l == 0 else m
        kk = min(max(k_graph if l == 0 else 2 * m, 2 * m_max), nn - 1)
        if kk <= 0:
            sel = np.full((nn, m_max), -1, dtype=np.int64)
            cand = None
        else:
            if metric_p == 2.0:
                cand_t = _chunked_l2_topk(sub, kk)
            else:
                pool = min(max(pool_factor * kk, kk), nn - 1)
                cand_t, _ = _rerank_pool(sub, _chunked_l2_topk(sub, pool), metric_p, kk)
            sel = _vectorized_heuristic_prune(sub, cand_t, m_max, alpha=alpha).cpu().numpy()
            cand = cand_t.cpu().numpy()
        merged = _sort_ragged_by_base(sub, _symmetrize(sel), metric_p)
        pruned = _vectorized_heuristic_prune(sub, merged, m_max, alpha=alpha,
                                             backfill=True).cpu().numpy()
        if cand is not None:
            _top_up(pruned, cand)
        entry_local = int(np.nonzero(nodes == entry)[0][0])
        mat = _repair_connectivity(pruned.astype(np.int32), sub, metric_p, entry_local)
        mat = np.where(mat >= 0, nodes[np.clip(mat, 0, None)], -1).astype(np.int32)
        g2l = np.full(n, -1, dtype=np.int32)
        g2l[nodes] = np.arange(nn, dtype=np.int32)
        adjacency.append(torch.from_numpy(mat).to(device))
        level_nodes.append(torch.from_numpy(nodes).to(device))
        local_index.append(torch.from_numpy(g2l).to(device))
        if progress_every:
            print(f"  bulk build p={metric_p}: level {l}/{max_level} ({nn} nodes)")

    return HNSWGraph(
        metric_p=metric_p, m=m, m0=m0,
        ef_construction=-1,  # marks bulk construction
        entry_point=entry, max_level=max_level,
        adjacency=adjacency, level_nodes=level_nodes, local_index=local_index,
        data=X, levels=torch.from_numpy(levels).to(device),
    )
