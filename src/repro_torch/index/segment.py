"""Dataset partitioning + per-segment graph construction (DESIGN.md §3).

Counterpart of `repro.index.segment`. A segment is an independently built
U-HNSW pair (G1 under L1, G2 under L2) over a random subset of the corpus;
a random partition makes every segment a uniform sample, so the merge of
the per-segment top-t lists loses no recall.

All segments are padded to one shape (`GraphArrays.pad_to`) and stacked
on a leading (S,) axis (`GraphArrays.stack`), with their rows in one
(S, n_pad, d) tensor on the device, so that the segmented search can fold
the segments into one batched beam loop (`index.sharded`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.build import build_hnsw, build_hnsw_bulk
from repro_torch.core.bulk_build import _device_data, build_bulk_pair
from repro_torch.core.hnsw import GraphArrays

# below this size the sequential builder is both faster to start and of
# higher quality; above it the bulk builder wins
BULK_THRESHOLD = 512

# "bulk" is the shared-pass builder (G1 + G2 from one candidate pass),
# "bulk_host" the per-graph bulk builder, "incremental" sequential insertion
BUILD_METHODS = ("incremental", "bulk", "bulk_host")


def partition_dataset(n: int, num_segments: int, seed: int = 0) -> list[np.ndarray]:
    """Random balanced partition of [0, n) into `num_segments` id arrays."""
    if not 1 <= num_segments <= n:
        raise ValueError(f"num_segments={num_segments} must lie in [1, n={n}]")
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    return [np.sort(part).astype(np.int64) for part in np.array_split(perm, num_segments)]


def resolve_build_method(n: int, bulk: bool | None = None, method: str | None = None) -> str:
    """Pick a segment build method: `method` (one of BUILD_METHODS) when
    given; else `bulk` True -> "bulk", False -> "incremental"; else by
    size (incremental below BULK_THRESHOLD, bulk above)."""
    if method is not None:
        if method not in BUILD_METHODS:
            raise ValueError(f"unknown build method {method!r} (options: {BUILD_METHODS})")
        return method
    if bulk is not None:
        return "bulk" if bulk else "incremental"
    return "bulk" if n >= BULK_THRESHOLD else "incremental"


def build_segment_pair(data, m: int, seed: int, bulk: bool | None = None,
                       method: str | None = None, *, device=None):
    """One segment's (G1, G2) over `data` (local ids), with the reference's
    seeds: G1 from seed, G2 from seed + 1 (the shared pass takes seed once).
    device: None means the tensor's own device, or "cuda" for a numpy array."""
    method = resolve_build_method(len(data), bulk=bulk, method=method)
    if method == "bulk":
        return build_bulk_pair(data, m=m, seed=seed, device=device)
    if method == "bulk_host":
        g1 = build_hnsw_bulk(data, 1.0, m=m, seed=seed, device=device)
        g2 = build_hnsw_bulk(g1.data, 2.0, m=m, seed=seed + 1)
        return g1, g2
    efc = min(200, max(16, 4 * m))
    g1 = build_hnsw(data, 1.0, m=m, ef_construction=efc, seed=seed, device=device)
    g2 = build_hnsw(g1.data, 2.0, m=m, ef_construction=efc, seed=seed + 1)
    return g1, g2


def take_segments(arrays: GraphArrays, sel: torch.Tensor) -> GraphArrays:
    """The stacked segments `sel` (a 1-D index tensor) of a stack (copies)."""
    return GraphArrays(arrays.adj0[sel], [a[sel] for a in arrays.upper_adj],
                       [g[sel] for g in arrays.upper_g2l], arrays.entry[sel], arrays.n,
                       arrays.metric_p)


def _stack_uniform(graphs) -> GraphArrays:
    """pad_to every graph to the common shape envelope, then stack."""
    arrays = [GraphArrays.from_graph(g) for g in graphs]
    n_pad = max(a.n for a in arrays)
    n_levels = max(len(a.upper_adj) for a in arrays)
    upper_m = max((g.m for g in graphs), default=0) or None
    level_sizes = tuple(
        max((a.upper_adj[l].shape[0] for a in arrays if l < len(a.upper_adj)), default=1)
        for l in range(n_levels))
    return GraphArrays.stack([a.pad_to(n_pad, n_levels, level_sizes, upper_m=upper_m)
                              for a in arrays])


@dataclass
class SegmentedGraphs:
    """S frozen segments, stacked for the segmented search.

    The per-segment graphs and global ids persist so that new segments can
    join (delta compaction): appending restacks the device tensors to the
    new shape envelope; the graphs themselves are never rebuilt.
    """

    graphs1: list                     # per-segment G1 (L1)
    graphs2: list                     # per-segment G2 (L2)
    global_ids: list[np.ndarray]      # per-segment local -> global id map
    # stacked device state, derived by _restack:
    arrays1: GraphArrays = field(init=False)
    arrays2: GraphArrays = field(init=False)
    X: torch.Tensor = field(init=False)          # (S, n_pad, d) segment rows
    node_ids: torch.Tensor = field(init=False)   # (S, n_pad) int32, -1 pad
    # the segments [lo, hi) the stacks hold on this rank (`hold`), None: all
    held: tuple[int, int] | None = field(init=False, default=None)

    def __post_init__(self):
        self._restack()

    @property
    def num_segments(self) -> int:
        return len(self.graphs1)

    @property
    def n_pad(self) -> int:
        return self.arrays1.n

    @property
    def device(self) -> torch.device:
        return self.graphs1[0].data.device

    def hold(self, block: tuple[int, int] | None) -> None:
        """Keep only the segments [lo, hi) in the stacks (a mesh rank's
        share: `ShardedUHNSW.shard_over`), in the whole stack's shape
        envelope; None: every segment. The per-segment graphs stay whole."""
        if block == self.held:
            return
        if self.held is not None:
            self._restack()
        if block is not None:
            lo, hi = block
            sel = torch.arange(lo, hi, device=self.X.device)
            self.arrays1 = take_segments(self.arrays1, sel)
            self.arrays2 = take_segments(self.arrays2, sel)
            self.X, self.node_ids = self.X[lo:hi].clone(), self.node_ids[lo:hi].clone()
            self.held = (lo, hi)

    def write_rows(self, seg: int, rows: torch.Tensor) -> None:
        """Segment seg's rows in the stacked X, where this rank holds it."""
        lo, hi = self.held if self.held is not None else (0, self.num_segments)
        if lo <= seg < hi:
            self.X[seg - lo, :rows.shape[0]] = rows

    def _restack(self):
        self.held = None
        self.arrays1 = _stack_uniform(self.graphs1)
        self.arrays2 = _stack_uniform(self.graphs2)
        n_pad = max(self.arrays1.n, self.arrays2.n)
        d = self.graphs1[0].d
        X = torch.zeros((self.num_segments, n_pad, d), dtype=torch.float32, device=self.device)
        node_ids = np.full((self.num_segments, n_pad), -1, dtype=np.int32)
        for i, (g, ids) in enumerate(zip(self.graphs1, self.global_ids)):
            X[i, :g.n] = g.data
            node_ids[i, :g.n] = ids
        self.X = X
        self.node_ids = torch.from_numpy(node_ids).to(self.device)

    def append(self, g1, g2, global_ids: np.ndarray):
        """Add a frozen segment (delta compaction) and restack."""
        if not g1.n == g2.n == len(global_ids):
            raise ValueError("a segment's graphs and ids must have one size")
        self.graphs1.append(g1)
        self.graphs2.append(g2)
        self.global_ids.append(np.asarray(global_ids, dtype=np.int64))
        self._restack()

    def index_size_bytes(self) -> int:
        return sum(g.index_size_bytes() for g in self.graphs1 + self.graphs2)


def build_segments(data, num_segments: int = 4, m: int = 16, seed: int = 0,
                   bulk: bool | None = None, method: str | None = None, *,
                   device=None) -> SegmentedGraphs:
    """Partition `data` and build every segment's G1/G2 pair (segment i from
    seed + 17 i). `method` / `bulk` pick the builder (`resolve_build_method`).
    data: (n, d) numpy array or tensor; device: where the graphs live (None:
    the tensor's own device, or "cuda" for a numpy array)."""
    X = _device_data(data, device)
    parts = partition_dataset(X.shape[0], num_segments, seed=seed)
    graphs1, graphs2, global_ids = [], [], []
    for i, ids in enumerate(parts):
        rows = X[torch.from_numpy(ids).to(X.device)]
        g1, g2 = build_segment_pair(rows, m=m, seed=seed + 17 * i, bulk=bulk, method=method)
        graphs1.append(g1)
        graphs2.append(g2)
        global_ids.append(ids)
    return SegmentedGraphs(graphs1=graphs1, graphs2=graphs2, global_ids=global_ids)
