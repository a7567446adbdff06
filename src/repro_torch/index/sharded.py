"""ShardedUHNSW: segmented U-HNSW with one merged verification pass.

Counterpart of `repro.index.sharded`. Query path (DESIGN.md §3):

  1. Candidate generation, by `ShardedParams.policy`:
     * "independent" (default): every segment runs a full beam;
     * "two_phase": the first `probe` segments in prior order (largest
       first) run the full beam; their merged rank-r base distance bounds
       the other segments' narrower beams (`knn_search`'s admission cut);
     * "round_robin": the segments take turns in prior order, each under
       the running merged rank-r bound of the turns before it.
     The reference vmaps `knn_search` over the stacked segment axis. Here
     the segments of one call are folded into the query batch instead: row
     s*B + b searches segment s for query b, in one flattened graph whose
     ids are offset by s*n_pad, so one beam loop serves every segment and
     each row's search is the one its segment alone would give.
  2. Merge: the per-segment top-t lists, segment-major, by one stable sort
     on the base distance (as `lax.sort` with one key is stable).
  3. Verification: one `verify_candidates` pass over the merged list.
  4. Delta merge: exact rooted-Lp distances of the delta buffer, sorted
     into the verified top-k (`index.delta`).

Streaming inserts go to the delta buffer; at capacity it compacts into a
new frozen segment built with the index's build method. Ids are assigned
once and never change. Quarantined segments (`index.health`) are left out
of the search, and every result reports the exact share of the corpus it
covered.

Placement (`ShardedUHNSW.shard_over(rt)`, reference :387): the stacked
segment axis goes over the first dp axis of the mesh whose size D divides
S, replicated when none does; each rank then holds its S / D segments of
the stacks (arrays1, arrays2, segments.X, node_ids: `SegmentedGraphs.hold`)
while the frozen rows X stay whole, as in the reference. A search over any
selection of segments (all, the alive ones, two_phase's probe and spill
lists, a round_robin turn) runs each rank's held ones through the folded
beam loop; the per-segment lists are assembled on every rank (a sum over
the axis of lists that each rank fills where it holds the segment), then
merged and verified alike on every rank: ids, distances and counters
equal the unplaced search's. Compaction re-applies the placement; a
restored segment's rows are written where they are held.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import metrics
from repro_torch.core.bulk_build import _device_data
from repro_torch.core.hnsw import GraphArrays, knn_search
from repro_torch.core.lp_ops import is_static_p, lp_root
from repro_torch.core.uhnsw import (
    CandidateSet,
    SearchStats,
    UHNSWParams,
    mask_base_rows,
    modeled_query_cost,
    two_way_mixed_search,
    verify_candidates,
)
from repro_torch.index.compressed import build_band, energy_order
from repro_torch.index.delta import DeltaBuffer
from repro_torch.index.health import SegmentHealthTracker
from repro_torch.index.segment import (
    SegmentedGraphs,
    build_segment_pair,
    build_segments,
    take_segments,
)


@dataclass(frozen=True)
class ShardedParams:
    """Cross-segment search policy (DESIGN.md §3); bad values raise at
    construction.

    policy: one of POLICIES. probe >= 1: segments phase A searches with
    the full beam (two_phase; clamped to [1, S] at query time). ef_shrink
    in (0, 1]: phase B's beam-width factor (two_phase). thresh_rank: the
    rank r of the running merged list whose base distance bounds later
    searches; None derives max(k, ceil(t * probe / S)), the smallest rank
    that keeps the pruning admissible for the merged top-t.
    """

    policy: str = "independent"
    probe: int = 1
    ef_shrink: float = 0.5
    thresh_rank: int | None = None

    POLICIES = ("two_phase", "round_robin", "independent")

    def __post_init__(self):
        if self.policy not in self.POLICIES:
            raise ValueError(f"unknown policy {self.policy!r} (options: {self.POLICIES})")
        if not self.probe >= 1:
            raise ValueError(f"probe must be >= 1, got {self.probe}")
        if not 0.0 < self.ef_shrink <= 1.0:
            raise ValueError(f"ef_shrink must be in (0, 1], got {self.ef_shrink}")

    def resolve_thresh_rank(self, t: int, num_segments: int, k: int | None) -> int:
        """The rank whose running best becomes the inherited bound."""
        if self.thresh_rank is not None:
            return max(1, min(self.thresh_rank, t))
        probe = max(1, min(self.probe, num_segments))
        admissible = -(-t * probe // num_segments)  # ceil(t * probe / S)
        return max(1, min(max(k or 1, admissible), t))

    def validate_for(self, num_segments: int, t: int) -> None:
        """The bounds that involve the index, checked where it is built."""
        if self.probe > num_segments:
            raise ValueError(
                f"ShardedParams.probe={self.probe} exceeds the index's {num_segments} "
                f"segments: lower probe to <= {num_segments} or build more segments")
        if self.thresh_rank is not None and self.thresh_rank > t:
            raise ValueError(
                f"ShardedParams.thresh_rank={self.thresh_rank} exceeds the candidate width "
                f"t={t}: lower thresh_rank or raise UHNSWParams.t")


def _fold(arrays: GraphArrays, X: torch.Tensor, node_ids: torch.Tensor, b: int):
    """The stacked segments as one graph over S * n_pad rows, for a batch
    of b queries per segment: segment s's ids are offset by s * n_pad (its
    level-l rows by s * n_l), every sentinel becomes S * n_pad, and the
    entry is per row (row s * b + j enters segment s)."""
    s, n_pad = X.shape[0], X.shape[1]
    dev = X.device
    sentinel = s * n_pad

    def offset_ids(a):
        base = (torch.arange(s, device=dev) * n_pad).view(s, *([1] * (a.ndim - 1)))
        return torch.where(a < n_pad, a + base, sentinel).reshape(-1, a.shape[-1])

    def offset_rows(g2l, rows):
        base = (torch.arange(s, device=dev) * rows)[:, None]
        return torch.where(g2l >= 0, g2l + base, -1).reshape(-1)

    entry = (arrays.entry + torch.arange(s, device=dev) * n_pad).repeat_interleave(b)
    flat = GraphArrays(
        offset_ids(arrays.adj0),
        [offset_ids(a) for a in arrays.upper_adj],
        [offset_rows(g, a.shape[1]) for g, a in zip(arrays.upper_g2l, arrays.upper_adj)],
        entry, sentinel, arrays.metric_p)
    return flat, X.reshape(sentinel, -1), node_ids.reshape(-1)


@dataclass(frozen=True)
class SegmentPlacement:
    """A stacked segment axis placed over one mesh axis of a Runtime."""

    rt: object
    axis: str

    @property
    def parts(self) -> int:
        return int(self.rt.mesh.mesh.shape[self.rt.mesh.mesh_dim_names.index(self.axis)])

    def block(self, s: int) -> tuple[int, int] | None:
        """This rank's segments [lo, hi) of a stack of s, or None (D does
        not divide s: replicated)."""
        if s % self.parts:
            return None
        n = s // self.parts
        r = self.rt.coord(self.axis)
        return r * n, (r + 1) * n

    def assemble(self, x: torch.Tensor) -> torch.Tensor:
        """Per-segment results, each rank's own rows filled and the others
        0, summed over the axis: every rank then holds every row (x + 0 is
        x, bit for bit)."""
        from repro_torch.dist import comm

        return comm.all_reduce(x, self.rt, (self.axis,))


def _search_fold(arrays: GraphArrays, X: torch.Tensor, node_ids: torch.Tensor, Q, ef: int,
                 t: int, max_hops: int, expand_width: int, thresh):
    """The folded beam loop over a stack of s segments -> per segment
    (gids (s, B, t), dists (s, B, t), n_b (s, B), hops (s, B), poisoned
    (s, B)), the guards applied."""
    b, dev = Q.shape[0], Q.device
    s = X.shape[0]
    flat, xf, nf = _fold(arrays, X, node_ids, b)
    qf = Q.repeat(s, 1)
    tf = None if thresh is None else torch.as_tensor(
        thresh, dtype=torch.float32, device=dev).repeat(s)
    ids, dists, nb, hops = knn_search(flat, xf, qf, ef=ef, t=t, max_hops=max_hops,
                                      expand_width=expand_width, thresh=tf)
    n_all = flat.n
    valid = ids < n_all
    g = torch.where(valid, nf[ids.long().clamp(0, n_all - 1)], -1)
    d = torch.where(valid & (g >= 0), dists, torch.inf)
    bad = (g >= 0) & ~torch.isfinite(d)
    pois = bad.any(1)
    g = torch.where(bad, -1, g)
    d = torch.where(bad, torch.inf, d)
    diff = torch.abs(qf - xf[flat.entry])
    entry_d = (diff if arrays.metric_p == 1.0 else diff * diff).sum(1)
    pois = pois | ~torch.isfinite(entry_d)
    return (g.reshape(s, b, t), d.reshape(s, b, t), nb.reshape(s, b), hops.reshape(s, b),
            pois.reshape(s, b))


def _merge_segments(g, d, nb, hops, pois, t: int):
    """Per-segment lists (S, B, t), segment-major, -> the stable-sort merge
    (gids (B, t) int32, dists (B, t)) and n_b, hops (summed), poisoned."""
    s, b = g.shape[0], g.shape[1]
    g = g.permute(1, 0, 2).reshape(b, s * t)
    d = d.permute(1, 0, 2).reshape(b, s * t)
    sd, order = torch.sort(d, dim=1, stable=True)
    return (g.gather(1, order[:, :t]).to(torch.int32), sd[:, :t],
            nb.sum(0, dtype=torch.int32), hops.sum(0, dtype=torch.int32), pois.any(0))


def segmented_knn_search(arrays: GraphArrays, X: torch.Tensor, node_ids: torch.Tensor,
                         Q: torch.Tensor, ef: int, t: int, max_hops: int = 4096,
                         expand_width: int = 1, thresh: torch.Tensor | None = None,
                         alive=None):
    """Per-segment base-metric search + one stable-sort merge.

    arrays: stacked GraphArrays (leading (S,) axis, n = n_pad); X (S, n_pad,
    d); node_ids (S, n_pad) local -> global, -1 pad; Q (B, d). `thresh`
    (B,) root-free base-metric bounds, shared by every segment, routes the
    beams through the admission cut. `alive` (S,) bool leaves the dead
    segments out: the merged result is what an index holding only the alive
    segments gives (the reference masks their outputs to padding, which
    merges the same).

    Every gathered distance passes a NaN/inf guard: a real id with a
    non-finite distance is masked to padding and raises its query's
    `poisoned` flag; so does a non-finite distance to a segment's entry row
    (a fully poisoned segment's beam admits nothing, so its list alone
    would look clean).

    Returns (gids (B, t) int32 global ids, -1 past the real data; dists
    (B, t) root-free base distances; n_b (B,); hops (B,); poisoned (B,)
    bool), n_b and hops summed over the segments.
    """
    if alive is not None:
        sel = torch.as_tensor(np.flatnonzero(np.asarray(alive, dtype=bool)), device=Q.device)
        if sel.numel() == 0:
            raise ValueError("no alive segment to search")
        if sel.numel() < X.shape[0]:
            arrays = take_segments(arrays, sel)
            X, node_ids = X[sel], node_ids[sel]
    return _merge_segments(*_search_fold(arrays, X, node_ids, Q, ef, t, max_hops, expand_width,
                                         thresh), t)


def _merge_sorted(gs, ds, fs, t: int):
    """Stable sort of the concatenated (id, distance, flag) lists on the
    distance; the top t of each."""
    g, d, f = torch.cat(gs, 1), torch.cat(ds, 1), torch.cat(fs, 1)
    sd, order = torch.sort(d, dim=1, stable=True)
    order = order[:, :t]
    return g.gather(1, order), sd[:, :t], f.gather(1, order)


def merge_phase_lists(g_a, d_a, g_b, d_b, t: int):
    """Sort-merge probe (flag 0) and spill (flag 1) candidate lists (widths
    may differ) -> (gids (B, t), dists (B, t), flags (B, t))."""
    return _merge_sorted((g_a, g_b), (d_a, d_b), (torch.zeros_like(g_a), torch.ones_like(g_b)), t)


def merge_tagged_lists(g, d, f, g_new, d_new, t: int):
    """One round_robin step: a flag-carrying running list merged with a new
    segment's (spill, flag 1) list, keeping the top t."""
    return _merge_sorted((g, g_new), (d, d_new), (f, torch.ones_like(g_new)), t)


class ShardedUHNSW:
    """Segmented U-HNSW index with streaming inserts.

    `search(Q, p, k)` has UHNSW's contract: Q (B, d); p a float or a (B,)
    array (each row under its own metric); returns (ids (B, k) int32,
    rooted dists (B, k) f32, SearchStats). `add(vec)` inserts online (the
    delta tier). Everything runs on the device of the segments' data.
    """

    def __init__(self, segments: SegmentedGraphs, data, params: UHNSWParams | None = None,
                 delta_capacity: int = 1024, sharded_params: ShardedParams | None = None):
        self.segments = segments
        self.params = params or UHNSWParams()
        self.sharded_params = sharded_params or ShardedParams()
        self.sharded_params.validate_for(segments.num_segments, self.params.t)
        self.health = SegmentHealthTracker(segments.num_segments)
        # the policies' sub-stacks (probe, spill, one turn's segment), by
        # base graph and segments; cleared when compaction restacks
        self._phase_cache: dict = {}
        # the frozen rows only: delta vectors join at compaction
        self.X = _device_data(data, segments.device)
        self.delta = DeltaBuffer(d=self.X.shape[1], capacity=delta_capacity)
        self._next_id = self.X.shape[0]
        self._build_method = None   # compaction's builder; None = by size
        # verification-scan caches over the frozen rows, rebuilt after each
        # compaction: the int8 band and the energy-ordered view
        self._band = None
        self._scan_cache = None
        # durability hook (`index.persist.DurableIndex`): called after a
        # compaction is in place, when the delta is empty; None = no
        # durability layer
        self.on_compact = None
        # the mesh placement (`shard_over`): its Runtime, re-applied after a
        # restack, and the segment axis' placement (None: replicated)
        self._rt = None
        self._place: SegmentPlacement | None = None

    @classmethod
    def build(cls, data, num_segments: int = 4, m: int = 16,
              params: UHNSWParams | None = None, seed: int = 0, bulk: bool | None = None,
              delta_capacity: int = 1024, method: str | None = None,
              sharded_params: ShardedParams | None = None, *, device=None) -> "ShardedUHNSW":
        """Partition + build. `method` picks the per-segment builder
        ("incremental" / "bulk" / "bulk_host"; None = by segment size) and
        is remembered for compaction. device: None means the tensor's own
        device, or "cuda" for a numpy array."""
        segments = build_segments(data, num_segments=num_segments, m=m, seed=seed, bulk=bulk,
                                  method=method, device=device)
        idx = cls(segments, data, params=params, delta_capacity=delta_capacity,
                  sharded_params=sharded_params)
        idx._build_method = method if method is not None else (
            None if bulk is None else ("bulk" if bulk else "incremental"))
        return idx

    @property
    def n(self) -> int:
        """Searchable points (frozen segments + delta)."""
        return self._next_id

    @property
    def dim(self) -> int:
        return int(self.X.shape[1])

    @property
    def num_segments(self) -> int:
        return self.segments.num_segments

    def index_size_bytes(self, p_range_max: float = 2.0) -> int:
        if p_range_max <= 1.0:
            return sum(g.index_size_bytes() for g in self.segments.graphs1)
        return self.segments.index_size_bytes()

    def base_arrays_for(self, p: float) -> tuple[GraphArrays, float]:
        """Scalar-p base-graph pick (G1 iff p <= cutoff)."""
        base = metrics.base_metric_for(p, self.params.cutoff)
        seg = self.segments
        return (seg.arrays1, 1.0) if base == 1.0 else (seg.arrays2, 2.0)

    def compressed_band(self):
        """The int8 `CompressedBand` over the frozen rows, built at first use."""
        if self._band is None:
            self._band = build_band(self.X)
        return self._band

    def _scan_view(self):
        """(x_scan, perm): the energy-ordered view of the frozen rows."""
        if self._scan_cache is None:
            perm = torch.from_numpy(energy_order(self.X).astype(np.int64)).to(self.X.device)
            self._scan_cache = (self.X[:, perm].contiguous(), perm)
        return self._scan_cache

    def _verify_extras(self) -> dict:
        prm = self.params
        if not prm.abandon:
            return {}
        if prm.compressed_band:
            return {"band": self.compressed_band()}
        if prm.energy_perm:
            x_scan, perm = self._scan_view()
            return {"x_scan": x_scan, "scan_perm": perm}
        return {}

    def _queries(self, Q) -> torch.Tensor:
        return torch.as_tensor(Q, dtype=torch.float32, device=self.X.device)

    def shard_over(self, rt) -> "ShardedUHNSW":
        """Place the stacked segment axis over the mesh's data axes: the
        first dp axis whose size D divides S, and this rank then holds its
        S / D segments of the stacks (`SegmentedGraphs.hold`); replicated
        (whole stacks, the search run whole on every rank) when none does.
        The Runtime is kept, so that compaction re-applies the placement.
        rt None unplaces the index."""
        self._rt = rt
        self._phase_cache.clear()
        self._place = None
        if rt is not None and rt.distributed:
            s = self.num_segments
            shape = dict(zip(rt.axis_names, rt.mesh.mesh.shape))
            axis = next((a for a in rt.dp_axes if s % int(shape[a]) == 0), None)
            if axis is not None:
                self._place = SegmentPlacement(rt, axis)
        self.segments.hold(None if self._place is None else self._place.block(self.num_segments))
        return self

    def search(self, Q, p, k: int):
        """Batched ANNS-U-Lp over all alive segments + the delta buffer."""
        if is_static_p(p):
            p = float(p)
            _, base_p = self.base_arrays_for(p)
            cands = self.search_stage_candidates(Q, base_p, k=k)
            return self.search_stage_finish(Q, cands, p, k)
        return self._search_mixed(Q, p, k)

    def _alive_segments(self) -> list[int]:
        return self.health.alive()

    def coverage_frac(self, alive: list[int] | None = None) -> float:
        """Served share of the corpus for an alive set: alive frozen rows
        plus the (always served) delta tier, over all rows."""
        sizes = [g.n for g in self.segments.graphs1]
        if alive is None:
            alive = self._alive_segments()
        total = sum(sizes) + len(self.delta)
        if total <= 0:
            return 1.0
        return (sum(sizes[i] for i in alive) + len(self.delta)) / total

    def search_stage_candidates(self, Q, base_p: float, k: int | None = None,
                                alive: list[int] | None = None) -> CandidateSet:
        """Stage 1 of 2: the policy's cross-segment candidate generation on
        the base graph `base_p`. k (the caller's top-k) tightens the derived
        threshold rank; `alive` restricts the search to those segments
        (None: the health tracker's alive set)."""
        Q = self._queries(Q)
        alive_list = (self._alive_segments() if alive is None
                      else sorted(int(i) for i in alive))
        ids, dists, n_b, hops, nb_probe, nb_spill, n_cand_spill, pois = \
            self._segment_candidates(base_p, Q, k=k, alive=alive_list)
        return CandidateSet(ids=ids, base_dists=dists, n_b=n_b, hops=hops, base_p=base_p,
                            n_b_probe=nb_probe, n_b_spill=nb_spill, n_cand_spill=n_cand_spill,
                            poisoned=pois, coverage_frac=self.coverage_frac(alive_list))

    def search_stage_finish(self, Q, cands: CandidateSet, p, k: int):
        """Stage 2 of 2: verification (or the base-metric skip), then the
        delta merge, which belongs here since delta hits need no
        verification."""
        prm = self.params
        Q = self._queries(Q)
        base_p = cands.base_p
        kappa = prm.kappa or max(k // 2, 1)
        if is_static_p(p) and float(p) == base_p:
            p = float(p)
            ones = torch.ones(cands.n_b.shape, device=Q.device)
            ids, dists = cands.ids[:, :k], lp_root(cands.base_dists[:, :k], p)
            n_p, iters = torch.zeros_like(cands.n_b), 0
            frac, f32f, bandf = ones, ones, torch.zeros_like(ones)
        else:
            p_arg = float(p) if is_static_p(p) else metrics.as_p_vec(p, Q.device)
            # -1 padding passes through: verification scores it +inf
            ids, dists, n_p, iters, frac, f32f, bandf = verify_candidates(
                Q, cands.ids, self.X, p_arg, k, kappa, prm.tau, cand_base=cands.base_dists,
                base_p=base_p, abandon=prm.abandon, block_d=prm.abandon_block_d,
                **self._verify_extras())
            if not is_static_p(p):
                ids, dists, n_p, frac, f32f, bandf = mask_base_rows(
                    cands.ids, cands.base_dists, ids, dists, n_p, p_arg, base_p, k,
                    n_dim_frac=frac, n_f32_frac=f32f, n_band_frac=bandf)
                p = np.array(np.broadcast_to(p_arg.cpu().numpy(), (Q.shape[0],)))
            else:
                p = float(p)
        phases = self._phase_split(cands, n_p)
        return self._merge_delta(Q, p, k, ids, dists, n_p, iters, cands.n_b, cands.hops,
                                 base_p, frac, f32f, bandf, phases,
                                 coverage=cands.coverage_frac, poisoned=cands.poisoned)

    def _phase_split(self, cands: CandidateSet, n_p):
        """Per-phase (probe, spill) N_b / N_p: N_b splits exactly; N_p by
        each phase's share of the merged candidate list."""
        n_b_probe = cands.n_b if cands.n_b_probe is None else cands.n_b_probe
        n_valid = (cands.ids >= 0).sum(1)
        spill_frac = (torch.as_tensor(cands.n_cand_spill, dtype=torch.float32,
                                      device=n_p.device)
                      / torch.clamp_min(n_valid, 1).to(torch.float32))
        n_p_spill = n_p.to(torch.float32) * spill_frac
        n_p_probe = n_p.to(torch.float32) - n_p_spill
        return n_b_probe, cands.n_b_spill, n_p_probe, n_p_spill

    def _probe_order(self) -> list[int]:
        """Largest segments first (their running bound is the tightest),
        oldest first among equals."""
        sizes = [g.n for g in self.segments.graphs1]
        return sorted(range(len(sizes)), key=lambda i: (-sizes[i], i))

    def _held_stack(self, base_p: float, sel: list[int], cache: bool = False):
        """The stacks of segments `sel` (global ids, all held on this rank):
        the held stacks themselves when `sel` is all of them, None when it
        is empty, else a sub-stack (kept in the phase cache if `cache`)."""
        seg = self.segments
        lo, hi = seg.held if seg.held is not None else (0, self.num_segments)
        if sel == list(range(lo, hi)):
            return (seg.arrays1 if base_p == 1.0 else seg.arrays2), seg.X, seg.node_ids
        if not sel:
            return None
        key = ("sel", base_p, tuple(sel))
        hit = self._phase_cache.get(key)
        if hit is None:
            arrays = seg.arrays1 if base_p == 1.0 else seg.arrays2
            idx = torch.as_tensor([i - lo for i in sel], dtype=torch.int64, device=seg.X.device)
            hit = take_segments(arrays, idx), seg.X[idx], seg.node_ids[idx]
            if cache:
                self._phase_cache[key] = hit
        return hit

    def _held(self, sel: list[int]) -> list[int]:
        held = self.segments.held
        return sel if held is None else [i for i in sel if held[0] <= i < held[1]]

    def _phase_order(self, alive: list[int] | None = None) -> list[int]:
        """The probe order (largest segments first: their running bound is
        the tightest; oldest first among equals) over the alive segments."""
        order = self._probe_order()
        return order if alive is None else [i for i in order if i in set(alive)]

    def _phase_stacks(self, base_p: float, probe: int, alive_key: tuple | None = None):
        """Cached (probe, spill) sub-stacks of the held segments, by base
        graph, probe count and alive set (dead segments are left out)."""
        order = self._phase_order(None if alive_key is None else list(alive_key))
        return (self._held_stack(base_p, self._held(order[:probe]), cache=True),
                self._held_stack(base_p, self._held(order[probe:]), cache=True))

    def _search_sel(self, base_p: float, sel: list[int], Q, ef: int, t: int, width: int,
                    thresh=None, cache: bool = False):
        """The merged candidates of segments `sel` (global ids, in order),
        as `segmented_knn_search` over their sub-stack gives them. Placed,
        each rank searches the segments of `sel` it holds, and the
        per-segment lists are assembled on every rank before the merge.
        cache: keep the sub-stack (the policies' fixed phase and turn
        stacks) in the phase cache."""
        prm = self.params
        mine = self._held(sel)
        stacks = self._held_stack(base_p, mine, cache)
        if self._place is None:
            return _merge_segments(*_search_fold(*stacks, Q, ef, t, prm.max_hops, width,
                                                 thresh), t)
        b, dev = Q.shape[0], Q.device
        g = torch.zeros((len(sel), b, t), dtype=torch.int32, device=dev)
        d = torch.zeros((len(sel), b, t), dtype=torch.float32, device=dev)
        nb, hops, pois = (torch.zeros((len(sel), b), dtype=dt, device=dev)
                          for dt in (torch.int32, torch.int32, torch.uint8))
        if stacks is not None:
            got = _search_fold(*stacks, Q, ef, t, prm.max_hops, width, thresh)
            pos = torch.as_tensor([sel.index(i) for i in mine], device=dev)
            for full, part in zip((g, d, nb, hops, pois), got):
                full[pos] = part.to(full.dtype)
        g, d, nb, hops, pois = (self._place.assemble(x) for x in (g, d, nb, hops, pois))
        return _merge_segments(g, d, nb, hops, pois.bool(), t)

    def _segment_candidates(self, base_p: float, Q, k: int | None = None,
                            alive: list[int] | None = None):
        """Policy-dispatched candidate generation -> (gids (B, t), dists,
        n_b, hops, n_b_probe, n_b_spill, n_cand_spill, poisoned). Over an
        alive subset every derived quantity (t, rank, probe order and
        count) is what an index of only those segments computes."""
        prm = self.params
        sp = self.sharded_params
        s_total = self.num_segments
        alive = list(range(s_total)) if alive is None else alive
        if not alive:
            raise RuntimeError("no alive segments to search: every frozen segment is "
                               "quarantined; recover or rebuild the index")
        sizes = [g.n for g in self.segments.graphs1]
        t = min(prm.t, sum(sizes[i] for i in alive))
        ef = max(prm.ef or 2 * prm.t, t)
        width = min(prm.expand_width, ef)
        s = len(alive)
        probe = max(1, min(sp.probe, s))
        if sp.policy == "independent" or s == 1 or (sp.policy == "two_phase" and probe >= s):
            gids, dists, n_b, hops, pois = self._search_sel(base_p, alive, Q, ef, t, width)
            zero = torch.zeros_like(n_b)
            return gids, dists, n_b, hops, n_b, zero, zero, pois
        rank = sp.resolve_thresh_rank(t, s, k)
        order = self._phase_order(alive)
        if sp.policy == "two_phase":
            g_a, d_a, nb_a, hops_a, pois_a = self._search_sel(
                base_p, order[:probe], Q, ef, t, width, cache=True)
            thresh = d_a[:, rank - 1]
            # a rank-r bound admits up to r merged entrants per segment, and
            # the caller's k must fit: the spill beam's width floors at both
            ef_b = max(k or 1, rank, int(round(ef * sp.ef_shrink)))
            t_b = min(t, ef_b)
            g_b, d_b, nb_b, hops_b, pois_b = self._search_sel(
                base_p, order[probe:], Q, ef_b, t_b, min(width, ef_b), thresh=thresh, cache=True)
            gids, dists, flags = merge_phase_lists(g_a, d_a, g_b, d_b, t)
            n_cand_spill = ((flags == 1) & (gids >= 0)).sum(1, dtype=torch.int32)
            return (gids, dists, nb_a + nb_b, hops_a + hops_b, nb_a, nb_b, n_cand_spill,
                    pois_a | pois_b)
        # round_robin: every turn inherits the running merged rank-r bound
        for turn, i in enumerate(order):
            g_i, d_i, nb_i, hops_i, pois_i = self._search_sel(
                base_p, [i], Q, ef, t, width, thresh=dists[:, rank - 1] if turn else None,
                cache=True)
            if turn == 0:
                gids, dists, pois = g_i, d_i, pois_i
                flags = torch.zeros_like(g_i)
                nb_probe, nb_spill, hops = nb_i, torch.zeros_like(nb_i), hops_i
            else:
                gids, dists, flags = merge_tagged_lists(gids, dists, flags, g_i, d_i, t)
                nb_spill = nb_spill + nb_i
                hops = hops + hops_i
                pois = pois | pois_i
        n_cand_spill = ((flags == 1) & (gids >= 0)).sum(1, dtype=torch.int32)
        return gids, dists, nb_probe + nb_spill, hops, nb_probe, nb_spill, n_cand_spill, pois

    def _graph_search_base_vec(self, Q, p_vec, k: int, base_p: float):
        """One homogeneous-base sub-batch with per-row p, as
        `two_way_mixed_search` takes it (with the phase split and the
        poisoned flag)."""
        prm = self.params
        Q = self._queries(Q)
        cands = self.search_stage_candidates(Q, base_p, k=k)
        kappa = prm.kappa or max(k // 2, 1)
        p_vec = metrics.as_p_vec(p_vec, Q.device)
        ids, dists, n_p, iters, frac, f32f, bandf = verify_candidates(
            Q, cands.ids, self.X, p_vec, k, kappa, prm.tau, cand_base=cands.base_dists,
            base_p=base_p, abandon=prm.abandon, block_d=prm.abandon_block_d,
            **self._verify_extras())
        ids, dists, n_p, frac, f32f, bandf = mask_base_rows(
            cands.ids, cands.base_dists, ids, dists, n_p, p_vec, base_p, k,
            n_dim_frac=frac, n_f32_frac=f32f, n_band_frac=bandf)
        nb_pr, nb_sp, np_pr, np_sp = self._phase_split(cands, n_p)
        return (ids, dists, n_p, iters, cands.n_b, cands.hops, frac, f32f, bandf,
                nb_pr, nb_sp, np_pr, np_sp, cands.poisoned)

    def _search_mixed(self, Q, p, k: int):
        """Mixed-p batch: the two-way G1/G2 partition, then one delta merge."""
        Q = self._queries(Q)
        ids, dists, stats = two_way_mixed_search(Q, p, k, self.params.cutoff,
                                                 self._graph_search_base_vec)
        if torch.is_tensor(p):
            p = p.detach().cpu().numpy()
        p_arr = np.array(np.broadcast_to(np.asarray(p, np.float32).reshape(-1), (Q.shape[0],)))
        phases = (stats.n_b_probe, stats.n_b_spill, stats.n_p_probe, stats.n_p_spill)
        return self._merge_delta(Q, p_arr, k, ids, dists, stats.n_p, stats.iterations,
                                 stats.n_b, stats.hops, stats.base_p, stats.n_dim_frac,
                                 stats.n_f32_rows_frac, stats.n_band_frac, phases,
                                 coverage=self.coverage_frac(), poisoned=stats.poisoned)

    def _merge_delta(self, Q, p, k, ids, dists, n_p, iters, n_b, hops, base_p, n_dim_frac,
                     n_f32_frac, n_band_frac, phases=None, coverage: float = 1.0,
                     poisoned=0.0):
        """Sort-merge the delta tier's exact hits into the verified top-k.

        With abandonment on, the delta scan takes the verified k-th best as
        its abandon bound (scalar p = 1 or 2 keep the pairwise form, which
        has no transcendental work to skip). n_dim_frac, n_f32_frac and
        n_band_frac become N_p-weighted means over graph and delta scans
        (delta rows are full f32 rows with no band traffic); the delta's
        scans join N_p but neither phase.
        """
        if len(self.delta):
            n_delta = len(self.delta)
            d = self.X.shape[1]
            basic = is_static_p(p) and float(p) in (1.0, 2.0)
            thresh = dists[:, k - 1] if (self.params.abandon and not basic) else None
            d_ids, d_dists, d_nd = self.delta.search(Q, p, thresh=thresh,
                                                     block_d=self.params.abandon_block_d)
            all_d, order = torch.sort(torch.cat([dists, d_dists], 1), dim=1, stable=True)
            ids = torch.cat([ids, d_ids], 1).gather(1, order[:, :k])
            dists = all_d[:, :k]
            delta_frac = d_nd.sum(1).to(torch.float32) / (n_delta * d)
            denom = torch.clamp_min(n_p + n_delta, 1)
            n_dim_frac = (n_dim_frac * n_p + delta_frac * n_delta) / denom
            n_f32_frac = (n_f32_frac * n_p + 1.0 * n_delta) / denom
            n_band_frac = (n_band_frac * n_p) / denom
            n_p = n_p + n_delta
        nb_pr, nb_sp, np_pr, np_sp = phases if phases is not None else (
            n_b, torch.zeros_like(n_b), n_p, torch.zeros_like(n_p))
        stats = SearchStats(n_b=n_b, n_p=n_p, iterations=iters, base_p=base_p, hops=hops,
                            n_dim_frac=n_dim_frac, n_b_probe=nb_pr, n_b_spill=nb_sp,
                            n_p_probe=np_pr, n_p_spill=np_sp, n_f32_rows_frac=n_f32_frac,
                            n_band_frac=n_band_frac, coverage_frac=float(coverage),
                            degraded=bool(coverage < 1.0), poisoned=poisoned)
        return ids, dists, stats

    def modeled_query_cost(self, stats: SearchStats, p, d: int) -> dict:
        return modeled_query_cost(stats, p, d)

    def canary_probe(self, seg: int, n_probes: int = 2, seed: int = 0) -> bool:
        """One health check of segment `seg`: a few of its own members,
        searched against that segment alone, must each come back as their
        own top-1 at a finite distance with the NaN/inf guard clean. The
        outcome goes to the health tracker and is returned."""
        ids = np.asarray(self.segments.global_ids[seg])
        rng = np.random.default_rng(seed * 1009 + seg)
        pick = rng.choice(len(ids), size=min(n_probes, len(ids)), replace=False)
        gids = ids[np.sort(pick)]
        q = self.X[torch.from_numpy(gids).to(self.X.device)]
        cands = self.search_stage_candidates(q, 2.0, k=1, alive=[seg])
        top = cands.ids[:, 0].cpu().numpy()
        ok = bool(np.array_equal(top, gids)
                  and bool(torch.isfinite(cands.base_dists[:, 0]).all())
                  and not bool(torch.as_tensor(cands.poisoned).any()))
        self.health.record_probe(seg, ok)
        return ok

    def add(self, vec) -> int:
        """Insert one vector online; returns its (stable) global id. The
        vector lands in the delta buffer; a full buffer compacts."""
        v = np.asarray(vec.detach().cpu() if torch.is_tensor(vec) else vec,
                       dtype=np.float32).reshape(-1)
        d = self.X.shape[1]
        if v.shape[0] != d:   # checked before any state changes: no id is burnt
            raise ValueError(f"vector has dim {v.shape[0]}, index has dim {d}")
        gid = self._next_id
        self._next_id += 1
        self.delta.add(v, gid)
        if self.delta.full:
            self.compact()
        return gid

    def get_vector(self, gid: int) -> np.ndarray:
        """A vector by global id, whichever tier it lives in (host copy)."""
        n_frozen = self.X.shape[0]
        if 0 <= gid < n_frozen:
            return self.X[gid].cpu().numpy()
        pos = gid - n_frozen
        if 0 <= pos < len(self.delta):
            return self.delta.vectors()[pos]
        raise IndexError(f"id {gid} not in index (n={self.n})")

    def compact(self):
        """Freeze the delta buffer into a new segment (graphs + restack)."""
        if not len(self.delta):
            return
        vecs, ids = self.delta.drain()
        if int(ids[0]) != self.X.shape[0]:
            raise RuntimeError("delta ids are not row-aligned with the frozen rows")
        rows = torch.from_numpy(vecs).to(self.X.device)
        self.X = torch.cat([self.X, rows], 0)
        m = self.segments.graphs1[0].m
        g1, g2 = build_segment_pair(rows, m=m, seed=int(ids[0]) + 1, method=self._build_method)
        self.segments.append(g1, g2, ids)
        # the new segment starts healthy; quarantines survive
        self.health.resize(self.num_segments)
        self._phase_cache.clear()
        self._band = None
        self._scan_cache = None
        if self._rt is not None:     # S grew: place the new stack
            self.shard_over(self._rt)
        if self.on_compact is not None:
            self.on_compact()
