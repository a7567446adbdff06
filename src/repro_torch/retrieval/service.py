"""Universal vector-search service: mixed-p micro-batching scheduler.

Counterpart of `repro.retrieval.service`. Request vectors arrive as host
arrays; the index runs on its own device (the card unless it was built
with device="cpu"), and every result is copied back to the host.

The ANNS-U-Lp contract is that *every request carries its own p* (paper
§1: the optimal metric is task-specific). The naive way to serve that —
group the stream by exact (p, k) and run one device call per group — runs
tiny, data-dependently-shaped batches, one call (and, in the reference,
one compiled program) per distinct p, which collapses under realistic
traffic with many distinct p values. This scheduler instead threads p through the kernel stack as a
*per-query tensor* (DESIGN.md §6):

  * bounded FIFO request queue (`queue_capacity`; `submit` raises
    `QueueFull` rather than buffering unboundedly);
  * two-way partition by base graph (G1 for p <= cutoff, G2 otherwise) ×
    k — never one group per distinct p;
  * padded power-of-two batch buckets (`min_bucket` … `max_batch`): every
    device call has one of a fixed set of shapes, however many distinct
    p values the stream contains;
  * per-request latency, queue-depth, and per-base-graph / per-p-bucket
    N_b / N_p stats, so benchmark results are attributable (`stats`,
    `latency_summary`). Verify buckets additionally report their
    N_p-weighted scanned-dimension work (`stats["dim_frac_w"]`,
    DESIGN.md §8) so Eq. 1's effective T_p under early-abandoning
    verification is observable per base graph.

Results are bit-identical to per-p grouped serving (`serve_grouped`, kept
as the measurement baseline): the vector-p kernels select each row's
scalar op sequence exactly (repro_torch.core.lp_ops).

The index is a ShardedUHNSW by default, whose delta tier accepts online
inserts, so the service supports a full read/write mixed-metric workload
(DESIGN.md §3). `build(rt=...)` places its segment axis over a mesh
(`ShardedUHNSW.shard_over`); every rank then calls the same service
methods, and `serve` runs the engine on rank 0 with the other ranks
following its index calls (`retrieval.engine.orders`).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field, replace

import numpy as np

from repro_torch.core.metrics import base_metric_for
from repro_torch.core.uhnsw import UHNSW, UHNSWParams
from repro_torch.index.sharded import ShardedUHNSW
from repro_torch.retrieval.engine import EnginePolicy, ServingEngine, default_stats
from repro_torch.retrieval.engine import orders
from repro_torch.retrieval.engine.pipeline import host


class QueueFull(RuntimeError):
    """Raised by `submit` when the bounded request queue is at capacity."""


def _with_expand_width(params: UHNSWParams | None,
                       expand_width: int | None) -> UHNSWParams | None:
    """Apply an explicit expand_width override to the query params."""
    if expand_width is None:
        return params
    return replace(params or UHNSWParams(), expand_width=expand_width)


@dataclass
class QueryRequest:
    """One ANNS-U-Lp query: a (d,) vector, its own metric p ∈ [0.5, 2],
    result size k, and a caller-chosen id the response is keyed by."""

    vector: np.ndarray
    p: float
    k: int = 10
    request_id: int = 0


@dataclass
class InsertRequest:
    vector: np.ndarray
    request_id: int = 0


# one stats schema for both serve paths — see engine.default_stats
_empty_stats = default_stats


@dataclass
class UniversalVectorService:
    """Mixed-p batched serving engine over a U-HNSW index.

    Public surface:
      * `build(data, ...)` / `build_monolithic(data, ...)` — construct the
        backing index (segmented+delta ShardedUHNSW, or the paper-exact
        monolithic UHNSW).
      * `submit(requests)` + `drain()` — enqueue into the bounded queue,
        then serve everything queued in padded mixed-p buckets.
      * `serve(requests)` — submit+drain convenience wrapper; returns
        {request_id: (ids (k,) int32, rooted dists (k,) f32)}.
      * `serve_grouped(requests)` — the legacy per-(p, k) grouped path,
        kept as the benchmark baseline; bit-identical results.
      * `insert(requests)` — streaming inserts into the delta tier.
      * `stats` / `latency_summary()` — scheduler + Eq. 1 accounting.

    Scheduling parameters: `max_batch` caps device batch size,
    `min_bucket` is the smallest padded bucket (buckets are the
    power-of-two ladder min_bucket … max_batch), `queue_capacity` bounds
    the request queue (DESIGN.md §6). `max_verify_batch` caps buckets
    that need the verification pass: the convergence while_loop runs
    until the slowest row in the bucket terminates, so smaller verify
    buckets bound that gating cost (measured sweet spot ~32 on CPU);
    exact-base buckets have no such loop and use the full max_batch.
    """

    index: ShardedUHNSW | UHNSW
    max_batch: int = 256
    max_verify_batch: int = 32
    min_bucket: int = 8
    queue_capacity: int = 4096
    # engine scheduling knobs (repro_torch.retrieval.engine): deadline-flush
    # max-wait, admission-control watermark + overload policy, and the
    # injectable clock every deadline decision is made against (None ->
    # time.perf_counter; tests pass engine.ManualClock and never sleep)
    max_wait_ms: float = 2.0
    watermark: int | None = None
    overload: str = "shed"
    clock: object = None
    # failure recovery (DESIGN.md §9): per-flush retry budget + backoff,
    # and an optional seeded engine.FaultInjector for chaos rehearsal
    # (None = fault injection compiled out of the happy path)
    max_retries: int = 2
    retry_backoff_ms: float = 0.0
    fault_injector: object = None
    # degraded serving (DESIGN.md §11): coverage floor forwarded to
    # EnginePolicy.min_coverage (0.0 = serve at any coverage)
    min_coverage: float = 0.0
    stats: dict = field(default_factory=_empty_stats)

    def __post_init__(self):
        assert self.min_bucket >= 1 and self.max_batch >= self.min_bucket
        self._queue: deque = deque()  # (QueryRequest, enqueue_time)
        self._engine: ServingEngine | None = None
        self._seen_shapes: set = set()  # v1 cold-program detection

    @property
    def engine(self) -> ServingEngine:
        """The continuous-batching engine behind `serve` (lazy: the v1
        submit/drain path never constructs it)."""
        if self._engine is None:
            policy = EnginePolicy(
                max_batch=self.max_batch, min_bucket=self.min_bucket,
                max_wait_ms=self.max_wait_ms,
                queue_capacity=self.queue_capacity,
                watermark=self.watermark, overload=self.overload,
                max_retries=self.max_retries,
                retry_backoff_ms=self.retry_backoff_ms,
                min_coverage=self.min_coverage,
            )
            self._engine = ServingEngine(self.index, policy,
                                         clock=self.clock, stats=self.stats,
                                         fault_injector=self.fault_injector)
        return self._engine

    # -- construction -------------------------------------------------------

    @classmethod
    def build(cls, data: np.ndarray, params: UHNSWParams | None = None,
              m: int = 32, num_segments: int = 4, seed: int = 0,
              delta_capacity: int = 1024, rt=None,
              expand_width: int | None = None, method: str | None = None,
              sharded_params=None, *, device=None, **kw):
        """Build a segmented sharded index over `data` (n, d) f32, on
        `device` (None: the tensor's own device, or "cuda" for a numpy
        array).

        rt: a mesh Runtime, over whose data axes `ShardedUHNSW.shard_over`
        places the segment axis (None: unplaced). expand_width (if given) overrides the params'
        W-way multi-expansion factor for the level-0 beam. `method` picks
        the per-segment graph builder ("incremental" / "bulk" /
        "bulk_host", DESIGN.md §7; None = auto by segment size — the
        batched bulk path above index.segment.BULK_THRESHOLD) and carries
        over to delta compaction. `sharded_params` (a
        repro.index.sharded.ShardedParams) selects the cross-segment
        search policy — e.g. two_phase threshold propagation; the phase
        split lands in stats["n_b_probe"] / ["n_b_spill"]. Remaining
        kwargs configure the service (max_batch, min_bucket,
        queue_capacity).
        """
        index = ShardedUHNSW.build(
            data, num_segments=num_segments, m=m,
            params=_with_expand_width(params, expand_width), seed=seed,
            delta_capacity=delta_capacity, method=method,
            sharded_params=sharded_params, device=device,
        )
        if rt is not None:
            index.shard_over(rt)
        return cls(index=index, **kw)

    @classmethod
    def build_monolithic(cls, data: np.ndarray,
                         params: UHNSWParams | None = None,
                         m: int = 32, bulk: bool = True, seed: int = 0,
                         expand_width: int | None = None,
                         method: str | None = None, *, device=None, **kw):
        """Single-segment paper-exact index (no streaming inserts).

        `method` overrides the legacy `bulk` flag, which maps exactly as
        on the segmented surfaces (index.segment.resolve_build_method):
        bulk=True -> "bulk" (the batched shared-pass G1+G2 builder,
        DESIGN.md §7), bulk=False -> "incremental"; "bulk_host" (the
        vectorized NumPy per-graph builder) is reachable by name. The
        actual method dispatch lives in `UHNSW.build`.
        """
        params = _with_expand_width(params, expand_width)
        if method is None:
            method = "bulk" if bulk else "incremental"
        index = UHNSW.build(data, m=m, seed=seed, params=params,
                            method=method, device=device)
        return cls(index=index, **kw)

    # -- writes -------------------------------------------------------------

    def insert(self, requests: list[InsertRequest]) -> dict[int, int]:
        """Streaming inserts (ShardedUHNSW only). request_id -> global id."""
        if not hasattr(self.index, "add"):
            raise TypeError("index does not support online inserts "
                            "(build with UniversalVectorService.build)")
        out: dict[int, int] = {}
        segs_before = self.index.num_segments
        for r in requests:
            out[r.request_id] = self.index.add(r.vector)
        self.stats["inserts"] += len(requests)
        self.stats["compactions"] += self.index.num_segments - segs_before
        return out

    # -- the micro-batching scheduler ---------------------------------------

    def _validate(self, requests: list[QueryRequest]) -> None:
        """Reject malformed requests before ANY of the batch is accepted:
        p outside the universal range (NaN included), k < 1, a vector of
        the wrong dimensionality (reported as expected vs actual d), or a
        non-finite vector — so a malformed request can never reach (and
        abort) a device batch it shares with healthy ones."""
        dim = int(self.index.X.shape[1])
        for r in requests:
            base_metric_for(float(r.p))  # range-validates p (NaN included)
            if int(r.k) < 1:
                raise ValueError(
                    f"request {r.request_id}: k must be >= 1, got {r.k}")
            v = np.asarray(host(r.vector))
            if v.size != dim:
                raise ValueError(
                    f"request {r.request_id}: dimension mismatch — "
                    f"expected d={dim}, got d={v.size}"
                )
            if not np.all(np.isfinite(v)):
                raise ValueError(
                    f"request {r.request_id}: vector has non-finite "
                    f"entries (NaN/Inf)"
                )

    def submit(self, requests: list[QueryRequest]) -> None:
        """Enqueue requests into the bounded FIFO queue.

        Raises QueueFull if the batch would exceed `queue_capacity` (no
        partial enqueue) or ValueError for a malformed request (see
        `_validate`) — all *before* any request of the batch is accepted.
        """
        if len(self._queue) + len(requests) > self.queue_capacity:
            raise QueueFull(
                f"queue at {len(self._queue)}/{self.queue_capacity}; "
                f"cannot accept {len(requests)} more"
            )
        self._validate(requests)
        now = time.perf_counter()
        for r in requests:
            self._queue.append((r, now))
        self.stats["queue_peak"] = max(self.stats["queue_peak"],
                                       len(self._queue))

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def drain(self) -> dict[int, tuple]:
        """Serve everything queued. Returns request_id -> (ids, dists).

        Scheduling (DESIGN.md §6): the queued requests partition two ways
        by base graph (cutoff rule), then by k; each partition is cut into
        FIFO chunks of <= max_batch and every chunk is padded up to the
        next power-of-two bucket size, so each device call has one of a
        fixed set of shapes regardless of how many distinct p values are
        in flight. Padding rows replicate the chunk's first request and
        are sliced off before stats are counted.
        """
        cutoff = self.index.params.cutoff
        out: dict[int, tuple] = {}
        # two-way base partition × k — insertion order stays FIFO per group.
        # Rows whose p IS a base metric (exactly 1 or 2) never need
        # verification (paper §3 preamble); they bucket separately and take
        # the scalar skip path — the mixed engine's fast lane for the most
        # common production metrics.
        groups: dict[tuple[float, int, bool], list] = {}
        while self._queue:
            r, t0 = self._queue.popleft()
            base = base_metric_for(float(r.p), cutoff)
            exact = float(r.p) == base
            groups.setdefault((base, int(r.k), exact), []).append((r, t0))
        buckets = []
        for (base, k, exact), entries in sorted(groups.items()):
            cap = self.max_batch if exact else min(self.max_verify_batch,
                                                   self.max_batch)
            for start in range(0, len(entries), cap):
                buckets.append((base, k, exact, entries[start:start + cap],
                                cap))
        for i, (base, k, exact, chunk, cap) in enumerate(buckets):
            try:
                self._run_bucket(base, k, exact, chunk, out, cap)
            except Exception as e:
                # a failing bucket must not lose the rest of the drained
                # queue: re-enqueue every unserved request (including the
                # failing bucket's) so the caller can inspect or retry,
                # and hand back the responses already computed this call —
                # those requests are NOT re-enqueued (their stats are
                # already counted), so the partial dict is their only copy.
                for _, _, _, ch, _ in buckets[i:]:
                    self._queue.extend(ch)
                if not hasattr(e, "partial_results"):
                    e.partial_results = out
                raise
        return out

    def _bucket_size(self, n: int, cap: int) -> int:
        """Smallest power-of-two ladder size >= n (min_bucket … cap)."""
        size = self.min_bucket
        while size < n and size < cap:
            size *= 2
        return min(size, cap)

    def _run_bucket(self, base: float, k: int, exact: bool, chunk: list,
                    out: dict[int, tuple], cap: int) -> None:
        """One padded fixed-shape device call for a homogeneous-base chunk.

        exact=True means every row's p equals the base metric — the call
        drops to the scalar skip path (no verification program at all).
        """
        t_start = time.perf_counter()
        n_real = len(chunk)
        size = self._bucket_size(n_real, cap)
        reqs = [r for r, _ in chunk]
        q = np.stack([np.asarray(host(r.vector), np.float32).reshape(-1)
                      for r in reqs])
        if size > n_real:  # pad by replicating row 0 (same base, any p ok)
            q = np.concatenate([q, np.repeat(q[:1], size - n_real, axis=0)])
        if exact:
            ids, dists, stats = self.index.search(q, base, k)
        else:
            p = np.array([float(r.p) for r in reqs], np.float32)
            if size > n_real:
                p = np.concatenate([p, np.repeat(p[:1], size - n_real)])
            ids, dists, stats = self.index.search(q, p, k)
        ids = host(ids)[:n_real]
        dists = host(dists)[:n_real]

        def rows(x):
            x = np.asarray(host(x), dtype=np.float64)
            return x[:n_real] if x.ndim else np.full(n_real, float(x))

        n_b = rows(stats.n_b)
        n_p = rows(stats.n_p)
        # N_p-weighted scanned-dim fraction (1.0 on full-dimension paths)
        frac = rows(stats.n_dim_frac)
        frac_w = float((frac * n_p).sum())
        # N_p-weighted f32-rows fraction (DESIGN.md §10 two-band scan)
        f32_w = float((rows(stats.n_f32_rows_frac) * n_p).sum())
        # per-phase attribution (probe == total for monolithic/independent)
        nb_pr, nb_sp = stats.phase_n_b()
        np_pr, np_sp = stats.phase_n_p()
        nb_pr, nb_sp, np_pr, np_sp = map(rows, (nb_pr, nb_sp, np_pr, np_sp))
        done = time.perf_counter()
        shape_key = (base, k, exact, size)
        cold = shape_key not in self._seen_shapes
        self._seen_shapes.add(shape_key)
        st = self.stats
        st["queries"] += n_real
        st["batches"] += 1
        st["padded_rows"] += size - n_real
        st["n_b"] += float(n_b.sum())
        st["n_p"] += float(n_p.sum())
        st["n_b_probe"] += float(nb_pr.sum())
        st["n_b_spill"] += float(nb_sp.sum())
        st["n_p_probe"] += float(np_pr.sum())
        st["n_p_spill"] += float(np_sp.sum())
        st["dim_frac_w"] += frac_w
        st["f32_rows_w"] += f32_w
        pb = st["per_base"]["G1" if base == 1.0 else "G2"]
        pb["queries"] += n_real
        pb["batches"] += 1
        pb["n_b"] += float(n_b.sum())
        pb["n_p"] += float(n_p.sum())
        pb["dim_frac_w"] += frac_w
        pb["f32_rows_w"] += f32_w
        for i, (r, t0) in enumerate(chunk):
            out[r.request_id] = (ids[i], dists[i])
            pp = st["per_p"].setdefault(
                "%g" % float(r.p), {"queries": 0, "n_b": 0.0, "n_p": 0.0})
            pp["queries"] += 1
            pp["n_b"] += float(n_b[i])
            pp["n_p"] += float(n_p[i])
            st["latency_ms"].append((done - t0) * 1e3)
            st["latency_records"].append((
                (done - t0) * 1e3,            # total
                max(t_start - t0, 0.0) * 1e3,  # queue-wait
                (done - t_start) * 1e3,        # device-compute
                cold,
            ))

    def serve(self, requests: list[QueryRequest]) -> dict[int, tuple]:
        """Serve a mixed-p request list through the continuous-batching
        engine (DESIGN.md §6) — the default serve path since the engine
        PR; `serve_v1` keeps the synchronous submit/drain scheduler as a
        bit-identical baseline.

        Anything already queued via `submit` migrates into the engine
        first (FIFO, original enqueue timestamps preserved), then the
        request list is admitted in waves sized to the queue's remaining
        capacity, so arbitrarily long lists never trip the bound. Returns
        request_id -> (ids (k,) int32, rooted dists (k,) f32); requests
        shed by admission control (watermark + overload="shed") have no
        entry, and neither do requests the engine's bounded failure
        recovery marked terminally FAILED (retries exhausted after
        quarantine isolation, DESIGN.md §9) — those carry their final
        exception message in `engine.take_failures()` and count in
        `stats["failed"]`. Transient device faults are invisible here:
        the engine retries/bisects them and the retried results are
        bitwise-identical. If the recovery machinery itself fails, the
        engine enters its terminal failed state and the error propagates
        with responses already computed as `partial_results`.

        Over more than one rank (an index placed on a mesh) every rank
        calls serve with the same requests. The engine forms its waves by
        the clock, and each rank has its own, so rank 0 alone runs the
        engine: its clock, waves, faults, retries, quarantines and
        recoveries; before each index call that can enter a collective it
        broadcasts an order that the other ranks run on their own placed
        index (`retrieval.engine.orders`). At the end rank 0 broadcasts
        its results, so every rank returns the same dict; the stats and
        the failures are rank 0's."""
        eng = self.engine
        return orders.lead(lambda: self._serve_engine(requests), self.index,
                           eng.set_orders)

    def _serve_engine(self, requests: list[QueryRequest]) -> dict[int, tuple]:
        eng = self.engine
        out: dict[int, tuple] = {}
        i = 0
        try:
            while i < len(requests) or self._queue or eng.pending:
                while self._queue:  # migrate pre-queued v1 submissions
                    r, t0 = self._queue.popleft()
                    eng.admit([eng.make_request(r, now=t0)])
                room = self.queue_capacity - eng.pending
                if room > 0 and i < len(requests):
                    wave = requests[i:i + room]
                    self._validate(wave)
                    eng.admit([eng.make_request(r) for r in wave])
                    i += len(wave)
                out.update(eng.drain())
        except Exception as e:
            out.update(getattr(e, "partial_results", {}))
            e.partial_results = out
            raise
        return out

    def serve_v1(self, requests: list[QueryRequest]) -> dict[int, tuple]:
        """The v1 synchronous scheduler: submit + drain, in waves sized to
        the queue's *remaining* capacity, so arbitrarily long lists never
        trip the bound — even when other requests were already queued via
        `submit` (those are served too, FIFO, and their responses are
        included in the returned dict, as with any `drain`). Kept as the
        engine's bit-identical correctness/latency baseline. Returns request_id -> (ids, dists); on
        failure, computed responses ride on the exception as
        `partial_results`."""
        out: dict[int, tuple] = {}
        i = 0
        try:
            while i < len(requests) or self._queue:
                room = self.queue_capacity - len(self._queue)
                if room > 0 and i < len(requests):
                    wave = requests[i:i + room]
                    self.submit(wave)
                    i += len(wave)
                out.update(self.drain())
        except Exception as e:
            out.update(getattr(e, "partial_results", {}))
            e.partial_results = out
            raise
        return out

    # -- the grouped baseline ------------------------------------------------

    def serve_grouped(self, requests: list[QueryRequest]) -> dict[int, tuple]:
        """Legacy per-(p, k) grouped serving: one device call per exact
        (p, k) group with data-dependent batch shapes — the scheduling the
        micro-batcher replaces. Kept as the baseline and the parity oracle.

        Each group runs through the same per-row-p kernels `serve` uses (a
        constant p vector), so grouped-vs-mixed is a pure *scheduling*
        comparison and results are bit-identical to `serve` by
        construction — per-row kernel results are independent of batch
        composition. Does not touch the scheduler stats."""
        groups: dict[tuple[float, int], list[QueryRequest]] = {}
        for r in requests:
            groups.setdefault((float(r.p), int(r.k)), []).append(r)
        out: dict[int, tuple] = {}
        cutoff = self.index.params.cutoff
        for (p, k), reqs in sorted(groups.items()):
            for start in range(0, len(reqs), self.max_batch):
                chunk = reqs[start:start + self.max_batch]
                q = np.stack([host(r.vector) for r in chunk]).astype(np.float32)
                if p == base_metric_for(p, cutoff):
                    # base-metric group: the scalar skip path (no verify) —
                    # the same program family the mixed exact lane uses
                    ids, dists, _ = self.index.search(q, p, k)
                else:
                    p_vec = np.full(len(chunk), p, dtype=np.float32)
                    ids, dists, _ = self.index.search(q, p_vec, k)
                ids, dists = host(ids), host(dists)
                for i, r in enumerate(chunk):
                    out[r.request_id] = (ids[i], dists[i])
        return out

    # -- stats ---------------------------------------------------------------

    def latency_summary(self) -> dict:
        """Request-latency summary over the most recent window (the
        backing buffers keep the last 10k requests).

        Beyond the total-latency percentiles, the summary *attributes*
        each request's time: `queue_ms` is admission -> dispatch wait,
        `compute_ms` is dispatch -> host materialization, `cold_count` is
        how many requests rode a batch shape's first wave (a compiling one
        in the reference), and `warm` re-reports the total-latency
        percentiles over non-cold requests only, so a first call's cost
        never passes for steady-state serving latency."""
        # fault-tolerance counters (DESIGN.md §9) ride on every summary so
        # operational dashboards see retries/quarantines next to latency
        faults = {key: int(self.stats.get(key, 0))
                  for key in ("faults", "retries", "quarantine_splits",
                              "failed")}
        # degraded-serving counters (DESIGN.md §11): queries-weighted mean
        # coverage plus the engine's poison/quarantine/recovery totals and
        # (for health-tracked indexes) the tracker's own state summary
        q = int(self.stats.get("queries", 0))
        health = {
            "coverage_mean": (float(self.stats.get("coverage_w", 0.0)) / q
                              if q else 1.0),
            **{key: int(self.stats.get(key, 0))
               for key in ("poison_detected", "seg_quarantined",
                           "seg_recovered", "min_coverage_failed")},
        }
        tracker = getattr(self.index, "health", None)
        if tracker is not None:
            health["tracker"] = tracker.summary()
        lat = np.asarray(self.stats["latency_ms"], dtype=np.float64)
        if lat.size == 0:
            return {"count": 0, "mean": 0.0, "p50": 0.0, "p95": 0.0,
                    "max": 0.0, "queue_ms": {}, "compute_ms": {},
                    "cold_count": 0, "warm": {}, "faults": faults,
                    "health": health}
        out = {
            "count": int(lat.size),
            "mean": float(lat.mean()),
            "p50": float(np.percentile(lat, 50)),
            "p95": float(np.percentile(lat, 95)),
            "max": float(lat.max()),
            "faults": faults,
            "health": health,
        }
        recs = list(self.stats["latency_records"])
        if recs:
            arr = np.asarray([r[:3] for r in recs], dtype=np.float64)
            cold = np.asarray([bool(r[3]) for r in recs])
            for name, col in (("queue_ms", arr[:, 1]),
                              ("compute_ms", arr[:, 2])):
                out[name] = {
                    "mean": float(col.mean()),
                    "p50": float(np.percentile(col, 50)),
                    "p95": float(np.percentile(col, 95)),
                }
            out["cold_count"] = int(cold.sum())
            warm = arr[~cold, 0]
            out["warm"] = {} if warm.size == 0 else {
                "count": int(warm.size),
                "p50": float(np.percentile(warm, 50)),
                "p95": float(np.percentile(warm, 95)),
            }
        else:
            out["queue_ms"], out["compute_ms"] = {}, {}
            out["cold_count"], out["warm"] = 0, {}
        return out
