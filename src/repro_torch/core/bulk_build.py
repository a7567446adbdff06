"""Shared-pass bulk construction of the U-HNSW graph pair (DESIGN.md §7).

Counterpart of `repro.core.bulk_build`. G1 (L1) and G2 (L2) come from one
candidate-generation pass whose id blocks are scored under both metrics:

  1. **Seed** — at or below EXACT_SEED_THRESHOLD rows, one chunked L2
     pairwise scan (the pairwise kernel) ranks an 8k-wide shared pool per
     node, and every other metric re-scores that id block exactly (the
     gather kernel): exact kNN pools. Above it, each node scores a random
     candidate block.
  2. **NN-Descent rounds** (large corpora only) — each round samples
     forward and reverse neighbours-of-neighbours from the union of the L1
     and L2 pools, scores the block under both metrics in one pass (the
     multi-p gather kernel reads each distinct row once for both) and
     sort-merges it into each pool (exact distances, keep-best-k).
  3. **Emit** — geometric levels, then per level: the vectorized HNSW
     heuristic prune, reverse-edge symmetrization, a second backfilled
     prune, a kNN top-up to full degree and the connectivity repair,
     emitting `GraphArrays` directly. Upper levels take exact kNN lists
     from the pairwise kernel.

Everything dense runs in torch on the data's device: the pool merges, the
order-preserving dedups, the prunes, the top-k of the pairwise passes and
the NN-Descent gathers. Scoring goes through `kernels.ops` (the CUDA
kernels on the card, their plain versions on the CPU). Every random draw
is the reference's `np.random.default_rng(seed)` call, so the samples are
the reference's; the drawn arrays move to the device. The tie rules are
the reference's: `lax.sort` with two keys is lexicographic and `top_k`
prefers the lower index, which stable torch sorts reproduce. Only the
connectivity repair's reachability labelling runs on the host (NumPy),
through the host builder's `_repair_connectivity`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.build import _SCRATCH, _repair_connectivity
from repro_torch.core.hnsw import GraphArrays
from repro_torch.kernels.ops import (lp_gather_distance, lp_gather_distance_multi,
                                    lp_pairwise_distance)

# Below this corpus size the seed pass scores every column (exact kNN); above
# it, random seeding + NN-Descent keeps the build subquadratic.
EXACT_SEED_THRESHOLD = 4096
_POS_INF = 2**30  # position / id sentinel of the sort tricks
# Elements of a scoring call's (rows, width) output on the card, where the
# kernels stream their rows and build no (rows, width, d) block (1 GiB).
_CARD_ELEMS = 1 << 28


def _rows_per_call(x: torch.Tensor, width: int) -> int:
    """Rows per scoring or pruning call. On the card only the (rows, width)
    output is kept; on the CPU the plain versions build (rows, width, d)."""
    per_row = width if x.is_cuda else width * x.shape[1]
    return max(1, (_CARD_ELEMS if x.is_cuda else _SCRATCH) // max(per_row, 1))


def _first_of_runs(sk: torch.Tensor) -> torch.Tensor:
    """True where a row's sorted keys start a run of equal values."""
    head = torch.ones((sk.shape[0], 1), dtype=torch.bool, device=sk.device)
    return torch.cat([head, sk[:, 1:] != sk[:, :-1]], dim=1)


def _pad_cols(a: torch.Tensor, k: int, value) -> torch.Tensor:
    """Right-pads (rows, c) to k columns (narrow lists of tiny levels)."""
    if a.shape[1] >= k:
        return a[:, :k]
    pad = torch.full((a.shape[0], k - a.shape[1]), value, dtype=a.dtype, device=a.device)
    return torch.cat([a, pad], dim=1)


# ---------------------------------------------------------------------------
# dense primitives: top-k pool merge, order-preserving dedup, heuristic prune
# ---------------------------------------------------------------------------


def _merge_topk(pool_ids, pool_d, cand_ids, cand_d, k: int):
    """Sort-merges candidate blocks into per-row best-k pools with dedup.

    ids are -1 padded; padded and duplicate slots score +inf and sort last.
    Returns (ids (B, k) int64 ascending by distance, d (B, k) f32).
    """
    ids = torch.cat([pool_ids.long(), cand_ids.long()], dim=1)
    d = torch.cat([pool_d, cand_d], dim=1)
    valid = ids >= 0
    d = torch.where(valid, d, torch.inf)
    key = torch.where(valid, ids, _POS_INF)
    # lexicographic (key, d): by d, then stably by key
    d1, o1 = torch.sort(d, dim=1, stable=True)
    key1 = key.gather(1, o1)
    sk, o2 = torch.sort(key1, dim=1, stable=True)
    sd = torch.where(_first_of_runs(sk), d1.gather(1, o2), torch.inf)
    sd2, o3 = torch.sort(sd, dim=1, stable=True)
    out_ids = torch.where(torch.isfinite(sd2), sk.gather(1, o3), -1)
    return out_ids[:, :k], sd2[:, :k]


def _dedup_keep_first(ids: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row order-preserving dedup of -1-padded id lists, cut to k."""
    key = torch.where(ids >= 0, ids.long(), _POS_INF)
    # a stable sort by key keeps positions ascending within equal keys
    sk, pos = torch.sort(key, dim=1, stable=True)
    sp = torch.where(_first_of_runs(sk) & (sk < _POS_INF), pos, _POS_INF)
    sp2, o = torch.sort(sp, dim=1, stable=True)
    out = torch.where(sp2 < _POS_INF, sk.gather(1, o), -1)
    return _pad_cols(out, k, -1)


def _prune_chunk(x_sub, node_idx, cand_ids, m_max: int, alpha: float, backfill: bool):
    """Vectorized HNSW heuristic selection (Alg. 4) over a row chunk.

    cand_ids rows are sorted ascending by base-metric distance to the node
    (-1 padded, self excluded). The diversity rule's distances are L2^2 via
    the product identity whatever the base metric; the order is the exact
    base metric. backfill=True tops short selections up with the nearest
    skipped candidates. Returns (B, m_max) int64 ids, -1 padded.
    """
    b, c = cand_ids.shape
    valid = cand_ids >= 0
    cand_vec = x_sub[cand_ids.clamp(0, x_sub.shape[0] - 1)]      # (B, C, d)
    node_vec = x_sub[node_idx]                                    # (B, d)
    sq = torch.sum(cand_vec * cand_vec, dim=-1)
    nsq = torch.sum(node_vec * node_vec, dim=-1)
    d_u = torch.clamp_min(
        nsq[:, None] + sq - 2.0 * torch.bmm(cand_vec, node_vec[:, :, None])[..., 0], 0.0)
    d_u = torch.where(valid, d_u, torch.inf)
    pair = torch.clamp_min(
        sq[:, :, None] + sq[:, None, :] - 2.0 * torch.bmm(cand_vec, cand_vec.transpose(1, 2)),
        0.0)
    run_min = torch.full((b, c), torch.inf, device=x_sub.device)
    count = torch.zeros(b, dtype=torch.int64, device=x_sub.device)
    selected = torch.zeros((b, c), dtype=torch.bool, device=x_sub.device)
    for j in range(c):
        sel = valid[:, j] & (d_u[:, j] <= alpha * run_min[:, j]) & (count < m_max)
        selected[:, j] = sel
        run_min = torch.where(sel[:, None], torch.minimum(run_min, pair[:, j, :]), run_min)
        count += sel
    pos = torch.arange(c, device=x_sub.device).expand(b, c)
    if backfill:
        key = torch.where(selected, pos, torch.where(valid, pos + c, _POS_INF))
    else:
        key = torch.where(selected & valid, pos, _POS_INF)
    sk, o = torch.sort(key, dim=1, stable=True)
    out = torch.where(sk < _POS_INF, cand_ids.long().gather(1, o), -1)
    return _pad_cols(out, m_max, -1)


def _prune_all(x_sub: torch.Tensor, cand_ids: torch.Tensor, m_max: int, alpha: float,
               backfill: bool) -> torch.Tensor:
    """`_prune_chunk` over every row of a level, in row chunks."""
    n_rows, c = cand_ids.shape
    # the (rows, C, d) candidate block and the (rows, C, C) pair matrix
    chunk = max(1, (_CARD_ELEMS if x_sub.is_cuda else _SCRATCH) // (c * (x_sub.shape[1] + c)))
    out = torch.empty((n_rows, m_max), dtype=torch.int64, device=x_sub.device)
    for s in range(0, n_rows, chunk):
        e = min(s + chunk, n_rows)
        rows = torch.arange(s, e, device=x_sub.device)
        out[s:e] = _prune_chunk(x_sub, rows, cand_ids[s:e], m_max, alpha, backfill)
    return out


# ---------------------------------------------------------------------------
# chunked scoring (the shared distance pass)
# ---------------------------------------------------------------------------


def _score_ids(x: torch.Tensor, node_rows: torch.Tensor, ids: torch.Tensor,
               p: float) -> torch.Tensor:
    """Exact base-metric power sums node_rows[i] -> ids[i, :] through the
    gather kernel (`kernels.ops.lp_gather_distance`); ids < 0 score +inf."""
    n_rows, c = ids.shape
    out = torch.empty((n_rows, c), dtype=torch.float32, device=x.device)
    chunk = _rows_per_call(x, c)
    for s in range(0, n_rows, chunk):
        e = min(s + chunk, n_rows)
        out[s:e] = lp_gather_distance(x[node_rows[s:e]], ids[s:e], x, p)
    return out


def _score_ids_multi(x: torch.Tensor, node_rows: torch.Tensor, ids: torch.Tensor,
                     ps: tuple[float, ...]) -> torch.Tensor:
    """`_score_ids` under every p of ps from one read of each row: (P, rows,
    C) through the multi-p gather kernel (`kernels.ops.
    lp_gather_distance_multi`), two p a launch; each plane has `_score_ids`'
    bits."""
    n_rows, c = ids.shape
    out = torch.empty((len(ps), n_rows, c), dtype=torch.float32, device=x.device)
    chunk = _rows_per_call(x, c)
    for s in range(0, n_rows, chunk):
        e = min(s + chunk, n_rows)
        q = x[node_rows[s:e]]
        for i in range(0, len(ps), 2):
            out[i:i + 2, s:e] = lp_gather_distance_multi(q, ids[s:e], x, ps[i:i + 2])
    return out


def _sorted_pairwise(q: torch.Tensor, x: torch.Tensor, p: float, s: int, width: int):
    """Rows s.. of x scored against all of x through the pairwise kernel,
    self excluded, each row's best `width` columns ascending (lower id
    first on ties, as `lax.top_k` gives): (dists, ids int64)."""
    dd = lp_pairwise_distance(q, x, p)
    r = torch.arange(q.shape[0], device=x.device)
    dd[r, r + s] = torch.inf
    sd, idx = torch.sort(dd, dim=1, stable=True)
    return sd[:, :width], idx[:, :width]


def _exact_seed_pools(x: torch.Tensor, metric_ps, k: int, pool_factor: int = 8):
    """Near-exact per-metric kNN pools via one chunked pairwise scan.

    One L2 scan ranks a `pool_factor * k`-wide shared pool per node; every
    other metric re-scores only that id block exactly and keeps its own
    top-k (the reference's prefilter).
    """
    n = x.shape[0]
    need_pool = any(p != 2.0 for p in metric_ps)
    width = min(max(pool_factor * k, k) if need_pool else k, n - 1)
    ids2 = torch.empty((n, width), dtype=torch.int64, device=x.device)
    d2 = torch.empty((n, width), dtype=torch.float32, device=x.device)
    chunk = _rows_per_call(x, n)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        d2[s:e], ids2[s:e] = _sorted_pairwise(x[s:e], x, 2.0, s, width)
    pools = {}
    rows = torch.arange(n, device=x.device)
    for p in metric_ps:
        if p == 2.0:
            pools[p] = (ids2[:, :k].clone(), d2[:, :k].clone())
            continue
        dp = _score_ids(x, rows, ids2, p)
        none_ids = torch.full((n, 1), -1, dtype=torch.int64, device=x.device)
        none_d = torch.full((n, 1), torch.inf, device=x.device)
        pools[p] = _merge_topk(none_ids, none_d, ids2, dp, k)
    return pools


def _reverse_edges(sel: torch.Tensor, nl: int, r_max: int) -> torch.Tensor:
    """Capped reverse adjacency (nl, r_max) of a -1-padded forward list:
    edges grouped by target with a stable sort, each target keeping its
    first r_max sources in source order."""
    m_max = sel.shape[1]
    dev = sel.device
    src = torch.arange(nl, device=dev).repeat_interleave(m_max)
    dst = sel.reshape(-1).long()
    keep = dst >= 0
    src, dst = src[keep], dst[keep]
    dst_s, order = torch.sort(dst, stable=True)
    src_s = src[order]
    counts = torch.bincount(dst_s, minlength=nl)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(dst_s.numel(), device=dev) - starts[dst_s]
    rev = torch.full((nl, r_max), -1, dtype=torch.int64, device=dev)
    ok = pos < r_max
    rev[dst_s[ok], pos[ok]] = src_s[ok]
    return rev


def nn_descent_pools(
    data,
    metric_ps: tuple[float, ...] = (1.0, 2.0),
    k: int = 64,
    rounds: int = 3,
    sample_t: int = 8,
    cand_cap: int | None = None,
    seed: int = 0,
    interpret=None,
    trajectory: bool = False,
    exact_seed_threshold: int = EXACT_SEED_THRESHOLD,
    *,
    device=None,
):
    """Per-metric kNN candidate pools from one shared pass.

    Returns {p: (ids (n, k) int64 ascending, d (n, k) f32)} on the device.
    At or below `exact_seed_threshold` rows the pools are exact kNN and no
    round runs; above it every node seeds from a random candidate block and
    `rounds` NN-Descent iterations refine it. With trajectory, also returns
    the list of pool-id snapshots {p: ids} after the seed and after each
    round, as the reference does. `interpret` is the reference's kernel
    override, taken at its place and ignored.
    """
    x = _device_data(data, device)
    n = x.shape[0]
    if n < 2:
        raise ValueError("need at least two points to build a graph")
    k = min(k, n - 1)
    cand_cap = cand_cap or max(3 * k, 128)
    rng = np.random.default_rng(seed)
    dev = x.device
    own = torch.arange(n, device=dev)[:, None]

    if n <= exact_seed_threshold:
        pools = _exact_seed_pools(x, metric_ps, k)
        return (pools, [_snapshot(pools)]) if trajectory else pools

    def score_and_merge(pools, cand):
        """The shared pass: one id block, scored under every metric from one
        read of each distinct row, then merged into each metric's pool."""
        cand = torch.where(cand == own, -1, cand)   # no self-loops
        dd = _score_ids_multi(x, own[:, 0], cand, tuple(metric_ps))
        for i, p in enumerate(metric_ps):
            pools[p] = _merge_topk(*pools[p], cand, dd[i], k)
        return pools

    # 1. seed: a random candidate block per node (uniform, self excluded)
    seed_cand = rng.integers(0, n - 1, size=(n, max(k, 8)), dtype=np.int64)
    seed_cand = seed_cand + (seed_cand >= np.arange(n)[:, None])
    empty_ids = torch.full((n, k), -1, dtype=torch.int64, device=dev)
    empty_d = torch.full((n, k), torch.inf, device=dev)
    pools = {p: (empty_ids, empty_d) for p in metric_ps}
    pools = score_and_merge(pools, torch.from_numpy(seed_cand).to(dev))
    snaps = [_snapshot(pools)] if trajectory else []

    # 2. NN-Descent rounds over the joint pool: sample T forward or reverse
    # neighbours per node and take their whole join sets; the node's own
    # join set rides along (reverse edges and the other metric's pool)
    for _ in range(rounds):
        join = torch.cat([pools[p][0] for p in metric_ps], dim=1)
        base = torch.cat([join, _reverse_edges(join, n, join.shape[1])], dim=1)
        w = base.shape[1]
        t = min(sample_t, w)
        sel = torch.from_numpy(rng.integers(0, w, size=(n, t))).to(dev)
        mid = base.gather(1, sel)
        mid = torch.where(mid < 0, own, mid)             # pad -> self
        if t * w > cand_cap:
            # column j of the (n, t*w) second-hop block is base[mid[:, j // w], j % w]:
            # gather only the sampled columns
            sub = torch.from_numpy(rng.integers(0, t * w, size=(n, cand_cap))).to(dev)
            nn2 = base[mid.gather(1, sub // w), sub % w]
        else:
            nn2 = base[mid].reshape(n, t * w)
        pools = score_and_merge(pools, torch.cat([base, nn2], dim=1))
        if trajectory:
            snaps.append(_snapshot(pools))
    return (pools, snaps) if trajectory else pools


def _snapshot(pools) -> dict:
    """The pools' ids at one stage, copied: {p: ids (n, k)}."""
    return {p: ids.clone() for p, (ids, _) in pools.items()}


# ---------------------------------------------------------------------------
# level emission
# ---------------------------------------------------------------------------


def _assign_levels(n: int, m: int, seed: int) -> tuple[np.ndarray, int]:
    """Geometric level assignment (the incremental builder's law)."""
    rng = np.random.default_rng(seed)
    ml = 1.0 / math.log(m)
    levels = np.minimum(
        (-np.log(np.maximum(rng.random(n), 1e-12)) * ml).astype(np.int32), 30)
    return levels, int(np.argmax(levels))


def _exact_knn_local(sub: torch.Tensor, p: float, kk: int) -> torch.Tensor:
    """Exact base-metric kNN ids within a level subset (pairwise kernel)."""
    nl = sub.shape[0]
    out = torch.empty((nl, kk), dtype=torch.int64, device=sub.device)
    chunk = _rows_per_call(sub, nl)
    for s in range(0, nl, chunk):
        e = min(s + chunk, nl)
        out[s:e] = _sorted_pairwise(sub[s:e], sub, p, s, kk)[1]
    return out


def _build_level(sub: torch.Tensor, cand_ids: torch.Tensor, p: float, m_max: int,
                 alpha: float, entry_local: int) -> np.ndarray:
    """One level's adjacency (local ids, numpy int32) from sorted pools.

    Phase 1: diversity prune. Phase 2: symmetrize, re-sort by the exact base
    metric and prune again with backfill; then top up to full degree from
    the kNN pool and repair connectivity.
    """
    nl = sub.shape[0]
    rows = torch.arange(nl, device=sub.device)
    sel = _prune_all(sub, cand_ids, m_max, alpha, backfill=False)
    # a reverse cap of 2 * m_max: hubs collect more than m_max reverse edges
    merged = torch.cat([sel, _reverse_edges(sel, nl, 2 * m_max)], dim=1)
    merged = torch.where(merged == rows[:, None], -1, merged)
    merged = _dedup_keep_first(merged, merged.shape[1])
    dd = _score_ids(sub, rows, merged, p)
    sd, o = torch.sort(dd, dim=1, stable=True)
    merged = torch.where(torch.isfinite(sd), merged.gather(1, o), -1)
    pruned = _prune_all(sub, merged, m_max, alpha, backfill=True)
    topped = _dedup_keep_first(torch.cat([pruned, cand_ids.long()], dim=1), m_max)
    mat = topped.cpu().numpy().astype(np.int32)
    return _repair_connectivity(mat, sub, p, entry_local)


def _emit_arrays(x: torch.Tensor, pool_ids: torch.Tensor, p: float, m: int,
                 levels: np.ndarray, entry: int, alpha: float) -> GraphArrays:
    """The GraphArrays hierarchy of one metric."""
    n = x.shape[0]
    dev = x.device
    max_level = int(levels.max())
    adj0 = None
    upper_adj, upper_g2l = [], []
    for l in range(max_level + 1):
        nodes = np.nonzero(levels >= l)[0]
        m_max = 2 * m if l == 0 else m
        if l == 0:
            mat = _build_level(x, pool_ids, p, m_max, alpha, int(entry))
            adj0 = torch.from_numpy(np.where(mat >= 0, mat, n).astype(np.int64)).to(dev)
            continue
        sub = x[torch.from_numpy(nodes).to(dev)]
        entry_local = int(np.nonzero(nodes == entry)[0][0])
        if len(nodes) <= 1:
            mat = np.full((len(nodes), m_max), -1, np.int32)
        else:
            cand = _exact_knn_local(sub, p, min(2 * m_max, len(nodes) - 1))
            mat = _build_level(sub, cand, p, m_max, alpha, entry_local)
        gmat = np.where(mat >= 0, nodes[np.clip(mat, 0, None)], n)
        g2l = np.full(n, -1, np.int64)
        g2l[nodes] = np.arange(len(nodes))
        upper_adj.append(torch.from_numpy(gmat.astype(np.int64)).to(dev))
        upper_g2l.append(torch.from_numpy(g2l).to(dev))
    return GraphArrays(adj0=adj0, upper_adj=upper_adj, upper_g2l=upper_g2l,
                       entry=torch.as_tensor(entry, dtype=torch.int64, device=dev),
                       n=n, metric_p=p)


# ---------------------------------------------------------------------------
# public surface
# ---------------------------------------------------------------------------


@dataclass
class DeviceGraph:
    """A bulk-built frozen graph: device `GraphArrays` plus its metadata.

    Stands in for `HNSWGraph` wherever the port takes a graph (UHNSW,
    GraphArrays.from_graph, which takes `graph_arrays()` as it is). The
    topology lives only in the GraphArrays; `adjacency_host` derives a
    -1-padded host view for tests and tools.
    """

    metric_p: float
    m: int
    m0: int
    entry_point: int
    max_level: int
    levels: torch.Tensor
    data: torch.Tensor
    arrays: GraphArrays

    @property
    def n(self) -> int:
        return self.data.shape[0]

    @property
    def d(self) -> int:
        return self.data.shape[1]

    def graph_arrays(self) -> GraphArrays:
        return self.arrays

    def adjacency_host(self, level: int) -> np.ndarray:
        """-1-padded host adjacency of one level (global ids, int32)."""
        a = self.arrays.adj0 if level == 0 else self.arrays.upper_adj[level - 1]
        a = a.cpu().numpy()
        return np.where(a == self.n, -1, a).astype(np.int32)

    def index_size_bytes(self) -> int:
        """Index size without the data, counted as int32 entries (the
        reference's layout, whatever the width the port keeps them in)."""
        a = self.arrays
        return 4 * sum(t.numel() for t in (a.adj0, *a.upper_adj, *a.upper_g2l))


def _device_data(data, device) -> torch.Tensor:
    """The corpus as a contiguous float32 tensor on `device` (None: the
    tensor's own device, or "cuda" for a numpy array)."""
    if device is None:
        device = data.device if torch.is_tensor(data) else "cuda"
    if not torch.is_tensor(data):
        data = np.ascontiguousarray(data, dtype=np.float32)
    return torch.as_tensor(data, dtype=torch.float32, device=device).contiguous()


def _default_pool(m: int, n: int) -> int:
    # a pool floor of 64: at small m a 2*m0-wide pool is too narrow for the
    # prune to find diverse edges on clustered data
    return min(max(4 * m, 64), max(n - 1, 1))


def build_bulk_pair(
    data,
    m: int = 32,
    *,
    k_pool: int | None = None,
    rounds: int = 3,
    sample_t: int = 8,
    cand_cap: int | None = None,
    alpha: float = 1.2,
    seed: int = 0,
    progress_every: int = 0,
    exact_seed_threshold: int = EXACT_SEED_THRESHOLD,
    device=None,
) -> tuple[DeviceGraph, DeviceGraph]:
    """Builds the U-HNSW pair (G1 under L1, G2 under L2) in one shared pass.

    The candidate blocks are generated once and scored under both metrics;
    the levels are shared, so the graphs differ only in their edges.
    data: (n, d) numpy array or tensor; device as in `_device_data`.
    Returns (g1, g2) as `DeviceGraph`s ready for `UHNSW(g1, g2)`.
    """
    x = _device_data(data, device)
    n = x.shape[0]
    k_pool = k_pool or _default_pool(m, n)
    pools = nn_descent_pools(x, (1.0, 2.0), k=k_pool, rounds=rounds, sample_t=sample_t,
                             cand_cap=cand_cap, seed=seed,
                             exact_seed_threshold=exact_seed_threshold)
    levels, entry = _assign_levels(n, m, seed)
    graphs = []
    for p in (1.0, 2.0):
        if progress_every:
            print(f"  bulk pair: emitting G{int(p)} (p={p})", flush=True)
        arrays = _emit_arrays(x, pools[p][0], p, m, levels, entry, alpha)
        graphs.append(DeviceGraph(metric_p=p, m=m, m0=2 * m, entry_point=entry,
                                  max_level=int(levels.max()),
                                  levels=torch.from_numpy(levels).to(x.device), data=x,
                                  arrays=arrays))
    return graphs[0], graphs[1]


def build_bulk(
    data,
    metric_p: float = 2.0,
    m: int = 32,
    *,
    k_pool: int | None = None,
    rounds: int = 3,
    sample_t: int = 8,
    cand_cap: int | None = None,
    alpha: float = 1.2,
    seed: int = 0,
    exact_seed_threshold: int = EXACT_SEED_THRESHOLD,
    device=None,
) -> DeviceGraph:
    """Single-metric bulk build (the same pipeline with one pool). For a
    base metric other than L2 the seed pass still ranks with the L2 scan
    and re-scores the shared pool under `metric_p`."""
    x = _device_data(data, device)
    n = x.shape[0]
    p = float(metric_p)
    k_pool = k_pool or _default_pool(m, n)
    pools = nn_descent_pools(x, (p,), k=k_pool, rounds=rounds, sample_t=sample_t,
                             cand_cap=cand_cap, seed=seed,
                             exact_seed_threshold=exact_seed_threshold)
    levels, entry = _assign_levels(n, m, seed)
    arrays = _emit_arrays(x, pools[p][0], p, m, levels, entry, alpha)
    return DeviceGraph(metric_p=p, m=m, m0=2 * m, entry_point=entry,
                       max_level=int(levels.max()),
                       levels=torch.from_numpy(levels).to(x.device), data=x, arrays=arrays)
