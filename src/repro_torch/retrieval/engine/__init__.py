"""Continuous-batching serving engine (DESIGN.md §6).

Counterpart of `repro.retrieval.engine`. Under the same request stream and
a `ManualClock` it makes the reference's scheduling decisions (flushes,
waves, retries, quarantines) and keeps the same stats.

`ServingEngine` is the latency-first replacement for the v1 synchronous
micro-batching scheduler (`UniversalVectorService.serve_v1`): requests
are admitted into (base, k, exact) buckets, buckets flush when FULL or
when their oldest request's DEADLINE expires (injectable clock — tests
and simulated-time benchmarks never sleep), flushes are cut into
exact-fit half-octave ladder waves, and waves flow through the two-stage
search/verify pipeline with a one-wave lookahead: wave N+1's base-graph
search is dispatched before wave N's verification is collected (in the
port both stages run in order on one CUDA stream: see `pipeline`).

Results are bitwise-identical to `serve_grouped` and `serve_v1` for the
same request set: every wave runs the same traced-p (verify lane) or
scalar-base (exact lane) programs, and per-row results are invariant to
batch composition.

The engine shares the service's stats dict (`default_stats` is the one
schema both write): Eq. 1 counters, per-base/per-p attribution, flush
reasons, shed/degraded counts, and per-request latency records that
separate queue-wait from device-compute and flag cold requests: those
that rode the first wave of their (base, k, exact, size) shape. The
reference compiled a program per shape there; the port compiles nothing
per shape, and the flag keeps its meaning so that the stats of the two
engines agree.

Fault tolerance (DESIGN.md §9): every device interaction — stage A/B
dispatch and host collection — sits behind a fault boundary. A wave that
raises is retried up to `EnginePolicy.max_retries` times (optionally with
exponential backoff against the injectable clock), then *bisected*: each
half gets a fresh retry budget, so a single poison request is isolated in
O(log n) splits instead of failing its whole wave. A singleton wave that
exhausts its budget marks its request FAILED (terminal, with the
exception message) — total device calls are bounded by
(max_retries+1)·(2n−1), so there are no unbounded retries and no hangs.
A seeded `FaultInjector` can be threaded through the same boundary to
rehearse all of this deterministically; with no injector the boundary is
a single `is not None` check (zero overhead disabled). The engine itself
is a three-state machine — live → draining (after `close()`) and a
terminal failed state if the recovery machinery itself breaks — and
admission into a non-live engine raises `EngineClosed` rather than
silently queueing.

Over more than one rank (an index placed on a mesh, `shard_over`), rank 0
drives the engine and sends each index call that can enter a collective
to the other ranks as an order, which they run on their own placed index
(`orders`): `serve` on the service and `warmup` here take that path, and
every rank returns rank 0's result.
"""

from __future__ import annotations

import time
from collections import deque
from types import SimpleNamespace

import numpy as np

from repro_torch.core.metrics import base_metric_for
from repro_torch.index.health import QUARANTINED
from repro_torch.retrieval.engine import orders as mesh_orders
from repro_torch.retrieval.engine.faults import (
    SEGMENT_WILDCARD,
    FaultInjector,
    InjectedFault,
    InjectedSegmentFault,
    InjectedTimeout,
    segment_site,
)
from repro_torch.retrieval.engine.pipeline import TwoStagePipeline, Wave, host, make_waves
from repro_torch.retrieval.engine.request import FAILED as STAGE_FAILED
from repro_torch.retrieval.engine.request import SHED as STAGE_SHED
from repro_torch.retrieval.engine.request import EngineRequest
from repro_torch.retrieval.engine.scheduler import (
    DEADLINE,
    DEGRADE,
    DRAIN,
    FULL,
    SHED,
    BucketScheduler,
    EnginePolicy,
    Flush,
    ManualClock,
    bucket_ladder,
    chunk_plan,
)

# engine lifecycle states (satellite: admissions are rejected — not
# silently queued — once the engine is no longer live)
LIVE = "live"
DRAINING = "draining"
ENGINE_FAILED = "failed"

__all__ = [
    "ServingEngine", "EnginePolicy", "EngineRequest", "BucketScheduler",
    "TwoStagePipeline", "Wave", "Flush", "ManualClock", "bucket_ladder",
    "chunk_plan", "make_waves", "default_stats",
    "FaultInjector", "InjectedFault", "InjectedTimeout",
    "InjectedSegmentFault", "segment_site", "EngineClosed",
    "PoisonedResultError", "CoverageError",
    "FULL", "DEADLINE", "DRAIN", "SHED", "DEGRADE",
    "LIVE", "DRAINING", "ENGINE_FAILED",
]


class EngineClosed(RuntimeError):
    """Admission attempted on an engine that is draining or failed."""


class PoisonedResultError(RuntimeError):
    """A wave's collected results tripped the NaN/inf poison guard. The
    offending segment has already been located (O(log S) bisection) and
    quarantined by the time this raises — the normal retry machinery then
    re-runs the wave at reduced coverage, so no poisoned id ever reaches
    a results dict."""


class CoverageError(RuntimeError):
    """A wave was collected below `EnginePolicy.min_coverage` but a
    background recovery re-admitted at least one segment — raised to send
    the wave back through retry at the improved coverage."""


def default_stats() -> dict:
    """The serving stats schema (shared by the engine and the v1 path)."""
    return {
        "queries": 0, "batches": 0, "inserts": 0, "compactions": 0,
        "n_b": 0.0, "n_p": 0.0,      # aggregate Eq. 1 counters
        # cross-segment phase attribution (DESIGN.md §3): probe = work
        # done without an inherited bound, spill = work under one. For
        # monolithic indexes / the independent policy, probe == total and
        # spill == 0; delta-tier scans join n_p but neither phase.
        "n_b_probe": 0.0, "n_b_spill": 0.0,
        "n_p_probe": 0.0, "n_p_spill": 0.0,
        # N_p-weighted scanned-dimension work (DESIGN.md §8): the
        # early-abandoning verify buckets report effective T_p as
        # dim_frac_w / n_p (1.0 = full-dimension scans everywhere)
        "dim_frac_w": 0.0,
        # N_p-weighted f32 rows gathered (DESIGN.md §10): the compressed
        # two-band path reports gathered-f32-bytes reduction as
        # n_p / f32_rows_w (1.0 = every scored candidate hit f32 HBM)
        "f32_rows_w": 0.0,
        "padded_rows": 0,            # bucket-padding rows executed
        "queue_peak": 0,             # high-water queue depth
        # engine scheduling outcomes
        "flushes": {FULL: 0, DEADLINE: 0, DRAIN: 0},
        "shed": 0,                   # admission control: rejected
        "degraded": 0,               # admission control: exact-base lane
        # fault tolerance (DESIGN.md §9)
        "faults": 0,                 # device-call exceptions caught
        "retries": 0,                # wave re-executions
        "quarantine_splits": 0,      # bisections isolating poison requests
        "failed": 0,                 # requests in terminal FAILED state
        # degraded serving (DESIGN.md §11)
        "coverage_w": 0.0,           # sum(coverage_frac * real rows) served
        "poison_detected": 0,        # result rows caught by the NaN guard
        "seg_quarantined": 0,        # segments quarantined by the engine
        "seg_recovered": 0,          # segments restored + re-admitted
        "min_coverage_failed": 0,    # requests FAILED for low coverage
        # attribution: one bucket per base graph and one per distinct
        # requested p, each with its own Eq. 1 split
        "per_base": {
            "G1": {"queries": 0, "batches": 0, "n_b": 0.0, "n_p": 0.0,
                   "dim_frac_w": 0.0, "f32_rows_w": 0.0},
            "G2": {"queries": 0, "batches": 0, "n_b": 0.0, "n_p": 0.0,
                   "dim_frac_w": 0.0, "f32_rows_w": 0.0},
        },
        "per_p": {},                 # "%g" % p -> {queries, n_b, n_p}
        # per-request latency; bounded so a long-running service cannot
        # grow it without limit (latency_summary reports over the window).
        # latency_ms holds total ms (back-compat); latency_records holds
        # (total_ms, queue_ms, compute_ms, cold) per request — the
        # attribution fix: queue-wait vs device-compute vs first-call
        # compile are separable.
        "latency_ms": deque(maxlen=10_000),
        "latency_records": deque(maxlen=10_000),
    }


class ServingEngine:
    """The continuous-batching loop: admit -> (poll-flush -> pipeline) ->
    collect, against an injectable clock.

    Drive it either offline (`serve(reqs)` = admit + drain) or
    incrementally (`admit` as requests arrive, `pump()` per tick to
    dispatch full/deadline flushes, `drain()` to finish the stream).
    `stats` may be a shared dict (the service passes its own) or None
    for a private one.
    """

    def __init__(self, index, policy: EnginePolicy | None = None,
                 clock=None, stats: dict | None = None,
                 fault_injector: FaultInjector | None = None):
        self.index = index
        self.policy = policy or EnginePolicy()
        self.clock = clock if clock is not None else time.perf_counter
        self.sched = BucketScheduler(self.policy, self.clock)
        self.pipeline = TwoStagePipeline(index)
        self.stats = stats if stats is not None else default_stats()
        # None = no injection and ZERO overhead: the device-call boundary
        # is one attribute `is not None` test (the acceptance criterion)
        self.fault_injector = fault_injector
        self.state = LIVE
        self._inflight: Wave | None = None     # dispatched, not collected
        self._results: dict[int, tuple] = {}
        self._failures: dict[int, str] = {}    # request_id -> error message
        self._seen_shapes: set[tuple] = set()  # cold-program detection
        # rank 0 over a mesh: sends each collective index call to the other
        # ranks first (`orders.send`, installed by `orders.lead`)
        self.orders = None

    # -- admission -----------------------------------------------------------

    @property
    def pending(self) -> int:
        """Requests inside the engine: queued + in the pipeline."""
        inflight = self._inflight.n_real if self._inflight is not None else 0
        return self.sched.depth + inflight

    def _check_live(self) -> None:
        if self.state != LIVE:
            raise EngineClosed(
                f"engine is {self.state}: not accepting new requests")

    def make_request(self, r, now: float | None = None) -> EngineRequest:
        """Wrap a service QueryRequest with engine scheduling metadata."""
        self._check_live()
        now = self.clock() if now is None else now
        p = float(r.p)
        base = base_metric_for(p, self.index.params.cutoff)
        return EngineRequest(
            vector=np.asarray(r.vector, np.float32).reshape(-1),
            p=p, k=int(r.k),
            request_id=r.request_id, base=float(base), exact=p == base,
            arrival_t=now,
            deadline_t=now + self.policy.max_wait_ms / 1e3,
        )

    def admit(self, requests: list[EngineRequest]) -> list[EngineRequest]:
        """Admission control + enqueue. Returns the admitted subset —
        above the watermark the overload policy sheds the request (no
        response, counted) or degrades it onto the exact-base fast lane
        (approximate base-metric response, counted). Raises EngineClosed
        once the engine has left the live state (close() or an engine
        failure) — a request must never queue into an engine that will
        not serve it."""
        self._check_live()
        admitted = []
        for r in requests:
            if self.sched.over_watermark():
                if self.policy.overload == SHED:
                    r.stage = STAGE_SHED
                    self.stats["shed"] += 1
                    continue
                if not r.exact:  # DEGRADE: short-circuit past verification
                    r.exact = True
                    r.degraded = True
                    self.stats["degraded"] += 1
            self.sched.admit(r)
            admitted.append(r)
        self.stats["queue_peak"] = max(self.stats["queue_peak"],
                                       self.sched.depth)
        return admitted

    def submit(self, r, now: float | None = None) -> EngineRequest | None:
        """Admit ONE service-level request (wrap + admission control).
        Returns the EngineRequest, or None if the overload policy shed
        it; raises EngineClosed when the engine is not live."""
        admitted = self.admit([self.make_request(r, now=now)])
        return admitted[0] if admitted else None

    # -- the serving loop ----------------------------------------------------

    def pump(self, now: float | None = None) -> None:
        """Dispatch every flush that is due (full buckets + expired
        deadlines) through the pipeline, then finish whatever is left in
        flight: the one-wave lookahead only helps while another wave is
        ready to overlap with, and holding a dispatched wave for a
        *future* arrival would charge that wave the inter-arrival gap —
        exactly what a latency-first engine must not do."""
        self._maintain()
        flushes = self.sched.poll(now)
        while flushes:
            self._run(flushes)
            flushes = self.sched.poll(now)
        self._settle()

    def drain(self, now: float | None = None) -> dict[int, tuple]:
        """Flush everything queued, finish the pipeline, and hand back
        all results accumulated since the last drain."""
        self._maintain()
        self._run(self.sched.poll(now))          # due flushes keep their
        self._run(self.sched.flush_all(now))     # full/deadline reasons
        self._settle()
        out, self._results = self._results, {}
        return out

    def serve(self, requests: list[EngineRequest]) -> dict[int, tuple]:
        self.admit(requests)
        return self.drain()

    def close(self, now: float | None = None) -> dict[int, tuple]:
        """Stop admissions and finish everything queued/in-flight.

        The engine enters DRAINING — terminal: make_request/admit/submit
        raise EngineClosed from here on (an engine failure leaves it in
        ENGINE_FAILED, with the same admission behavior). Returns the
        final batch of results."""
        if self.state == LIVE:
            self.state = DRAINING
        return self.drain(now)

    def take_results(self) -> dict[int, tuple]:
        """Hand over results collected so far without flushing anything —
        the incremental (admit/pump) driving mode's harvest step."""
        out, self._results = self._results, {}
        return out

    def take_failures(self) -> dict[int, str]:
        """Hand over terminally FAILED requests (request_id -> the final
        exception message) accumulated since the last call. A request is
        either in a results dict, a failures dict, or was shed — the
        accounting invariant the chaos tests pin."""
        out, self._failures = self._failures, {}
        return out

    @property
    def failures(self) -> dict[int, str]:
        """Read-only view of not-yet-harvested terminal failures."""
        return dict(self._failures)

    def warmup(self, k: int = 10,
               ps: tuple[float, ...] = (0.8, 1.8)) -> int:
        """Boot-time warm-up: serve one synthetic batch of every ladder
        size for each lane the given p values map to (in the reference,
        to compile each program before traffic rides it; in the port, to
        pay the first call's allocations and kernel loads). Served
        counters and latency stats are left untouched (the shapes do land
        in the cold-detection set). Returns device batches executed.
        Over more than one rank every rank calls it: rank 0 warms up and
        the others run its orders."""
        return mesh_orders.lead(lambda: self._warmup(k, ps), self.index, self.set_orders)

    def set_orders(self, sender) -> None:
        self.orders = sender

    def _order(self, *order) -> None:
        """Send one order to the other ranks (rank 0 over a mesh only)."""
        if self.orders is not None:
            self.orders(order)

    def _alive(self) -> list[int] | None:
        health = getattr(self.index, "health", None)
        return None if health is None else sorted(health.alive())

    def _warmup(self, k: int, ps: tuple[float, ...]) -> int:
        zero = np.zeros(self.index.dim, np.float32)
        keep_stats, self.stats = self.stats, default_stats()
        keep_results, self._results = self._results, {}
        # warmup is not traffic — never inject faults into
        # it (and never burn the injector's deterministic draw sequence)
        keep_inj, self.fault_injector = self.fault_injector, None
        batches = 0
        try:
            for p in dict.fromkeys(float(p) for p in ps):
                for size in self.policy.ladder:
                    for i in range(size):
                        r = SimpleNamespace(vector=zero, p=p, k=k,
                                            request_id=-(i + 1))
                        self.sched.admit(self.make_request(r))
                    self.drain()
                    batches += 1
        finally:
            self.stats = keep_stats
            self._results = keep_results
            self.fault_injector = keep_inj
        return batches

    def _run(self, flushes: list[Flush]) -> None:
        work: deque[Wave] = deque()
        for fl in flushes:
            self.stats["flushes"][fl.reason] += 1
            work.extend(make_waves(fl, self.policy.ladder))
        self._run_waves(work)

    def _run_waves(self, work: deque[Wave]) -> None:
        """Drive the wave deque to empty. Per-wave device failures are
        recovered *inside* `_advance` (retry/bisect/FAILED — they never
        surface here); an exception escaping it means the recovery
        machinery itself broke, so request accounting can no longer be
        trusted: the engine enters its terminal failed state (admissions
        start raising EngineClosed), unserved requests are requeued for
        inspection, and the error propagates with partial_results."""
        while work:
            wave = work.popleft()
            try:
                self._advance(wave, work)
            except Exception as e:
                self.state = ENGINE_FAILED
                unserved = list(wave.requests)
                unserved += [r for w in work for r in w.requests]
                if self._inflight is not None:
                    unserved = list(self._inflight.requests) + unserved
                    self._inflight = None
                self.sched.requeue(unserved)
                partial = dict(getattr(e, "partial_results", {}))
                partial.update(self._results)
                e.partial_results = partial
                self._results = {}
                raise

    def _inject(self, site: str) -> None:
        if self.fault_injector is not None:
            self.fault_injector.check(site)

    def _inject_segments(self) -> None:
        """Draw the per-segment fault sites for every currently-alive
        segment, in segment order. Strictly opt-in (faults.py contract):
        a no-op unless an injector is configured with a `sites` filter
        that names segment sites AND the index carries a health tracker —
        so classic three-site chaos schedules never shift."""
        inj = self.fault_injector
        if inj is None or inj.sites is None:
            return
        if not any(s == SEGMENT_WILDCARD or s.startswith("segment:")
                   for s in inj.sites):
            return
        health = getattr(self.index, "health", None)
        if health is None:
            return
        for seg in health.alive():
            inj.check(segment_site(seg))

    # rows per localization probe: the poisoned rows' queries tiled to one
    # fixed small batch shape, so every bisection probe costs a fraction of
    # a full wave re-run
    PROBE_BATCH = 8

    def _locate_poisoned_segment(self, wave: Wave,
                                 pois: np.ndarray) -> int | None:
        """Attribute a poisoned wave to ONE alive segment by bisection:
        re-run stage A over half the alive set and read its poison flags,
        keeping whichever half still trips the guard — at most
        ceil(log2 S) device probes per event (the detection bound the
        chaos tests pin). Returns None without any probing when the wave
        was dispatched under a *stale* serving-set generation (its
        poisoned segment is already quarantined — the one-wave lookahead
        makes this ordinary): there is nothing new to quarantine, the
        retry alone fixes it, and bisecting the now-clean set would
        convict an innocent segment. (If a concurrent *readmission* bumped
        the generation instead, the retry re-detects under the current
        generation and bisection proceeds then.) When the generation
        matches, the wave itself is the full-set probe — it searched
        exactly the current alive set and tripped the guard — so
        bisection starts immediately.

        Probes re-use the queries of the rows that tripped the guard
        (`pois`), tiled to the fixed PROBE_BATCH shape: those rows
        provably surface the poison, and a subset search only *lowers*
        the competition a non-finite candidate must beat to be flagged."""
        health = self.index.health
        if wave.health_gen != health.generation:
            return None
        alive = sorted(health.alive())
        if not alive:
            return None
        bad = np.flatnonzero(np.asarray(pois))
        reps = int(np.ceil(self.PROBE_BATCH / len(bad)))
        q = np.tile(wave.q[bad], (reps, 1))[:self.PROBE_BATCH]

        def poisoned(subset: list[int]) -> bool:
            self._order(mesh_orders.CANDIDATES, q, wave.base, wave.k, subset)
            cands = self.index.search_stage_candidates(
                q, wave.base, k=wave.k, alive=subset)
            return bool(np.asarray(host(cands.poisoned)).any())

        while len(alive) > 1:
            left = alive[:len(alive) // 2]
            # the full set is known-poisoned, so a clean left half puts
            # the poison in the right half — no confirmation probe needed
            alive = left if poisoned(left) else alive[len(alive) // 2:]
        return alive[0]

    def _maintain(self) -> int:
        """Background recovery of quarantined segments (DESIGN.md §11):
        for each quarantined segment, re-materialize its rows from the
        latest *durable* snapshot (checksums re-verified by the manifest
        read inside restore_segment), then gate re-admission behind the
        health policy's canary-probe streak — a segment that cannot be
        restored or fails a probe goes straight back to quarantine.
        Returns the number of segments re-admitted. No-op (returns 0)
        for monolithic indexes and for indexes without a durable home
        (no snapshot to restore from)."""
        health = getattr(self.index, "health", None)
        if health is None:
            return 0
        quarantined = health.quarantined()
        if not quarantined:
            return 0
        directory = getattr(self.index, "directory", None)
        if directory is None:
            return 0
        from repro_torch.index.persist import restore_segment
        st = self.stats
        recovered = 0
        for seg in quarantined:
            self._order(mesh_orders.RESTORE, seg, directory)
            if not restore_segment(self.index, seg, directory):
                continue                    # no durable copy of this segment
            health.begin_recovery(seg)
            ok = True
            for i in range(health.policy.probe_successes):
                self._order(mesh_orders.CANARY, seg, i)
                ok = self.index.canary_probe(seg, seed=i)
                if not ok:
                    break
            if ok and health.probe_passed(seg):
                health.readmit(seg)
                st["seg_recovered"] += 1
                recovered += 1
            else:
                health.quarantine(seg)      # canary failed: stay out
        return recovered

    def _advance(self, wave: Wave, work: deque[Wave]) -> None:
        """One pipeline step: dispatch A(N), collect B(N-1), dispatch
        B(N). The collect sits *between* the dispatches so wave N's base
        search is already enqueued while wave N-1's verify materializes.

        Each of the three device interactions is its own fault boundary:
        a stage A/B failure recovers *this* wave (the predecessor is
        unaffected — on an A failure it simply stays in flight); a
        collect failure recovers the *predecessor* and this wave's stage
        B still dispatches. Recovery re-executes from stage A — dispatches
        are pure compute, so re-running them is always safe.
        """
        prev, self._inflight = self._inflight, None
        try:
            self._inject_segments()
            self._inject("search")
            health = getattr(self.index, "health", None)
            # pin the serving-set generation the wave searches under: a
            # poison flag collected from a *stale* generation needs no
            # bisection (its culprit is already quarantined — retry fixes
            # it), and from the *current* one the wave itself is the
            # full-set probe
            wave.health_gen = None if health is None else health.generation
            self._order(mesh_orders.CANDIDATES, wave.q, wave.base, wave.k, self._alive())
            self.pipeline.dispatch_search(wave)
        except Exception as e:
            self._inflight = prev          # predecessor is untouched
            self._recover(wave, e, work)
            return
        if prev is not None:
            try:
                self._inject("collect")
                self._collect(prev)
            except Exception as e:
                self._recover(prev, e, work)
        try:
            self._inject("verify")
            self.pipeline.dispatch_finish(wave)
        except Exception as e:
            self._recover(wave, e, work)
            return
        self._inflight = wave

    def _settle(self) -> None:
        """Collect the in-flight wave (and any recovery work its failure
        spawns) until nothing is left in the pipeline."""
        while self._inflight is not None:
            wave, self._inflight = self._inflight, None
            work: deque[Wave] = deque()
            try:
                self._inject("collect")
                self._collect(wave)
            except Exception as e:
                self._recover(wave, e, work)
            if work:
                self._run_waves(work)

    def _recover(self, wave: Wave, exc: Exception, work: deque[Wave]):
        """Bounded failure recovery for one wave (DESIGN.md §9).

        Retry the wave whole up to max_retries times (front of the work
        deque, optional exponential backoff). A wave that exhausts its
        budget and holds >1 request is bisected — each half a fresh wave
        with a fresh budget, so a poison request is isolated in O(log n)
        splits while its healthy wave-mates still get served. A singleton
        that exhausts its budget is terminally FAILED with the exception
        message. Total device calls per n-request flush are bounded by
        (max_retries+1)·(2n−1): no unbounded retries, ever.
        """
        st = self.stats
        st["faults"] += 1
        # segment-attributable fault: feed the health tracker's failure
        # EWMA before retrying — enough consecutive hits quarantine the
        # segment, and the retried wave then runs with it masked out
        # (reduced coverage) instead of failing requests (DESIGN.md §11).
        health = getattr(self.index, "health", None)
        if isinstance(exc, InjectedSegmentFault) and health is not None \
                and 0 <= exc.segment < health.num_segments:
            was = health.state(exc.segment)
            health.record_failure(exc.segment)
            if was != QUARANTINED and health.state(exc.segment) == QUARANTINED:
                st["seg_quarantined"] += 1
        wave.cands = None    # drop device buffers; re-execute from stage A
        wave.result = None
        if wave.attempt < self.policy.max_retries:
            wave.attempt += 1
            st["retries"] += 1
            for r in wave.requests:
                r.retries += 1
            self._backoff(wave.attempt)
            work.appendleft(wave)
            return
        if wave.n_real > 1:
            st["quarantine_splits"] += 1
            mid = (wave.n_real + 1) // 2
            subs: list[Wave] = []
            for part in (wave.requests[:mid], wave.requests[mid:]):
                fl = Flush(base=wave.base, k=wave.k, exact=wave.exact,
                           requests=part, reason=wave.reason)
                subs.extend(make_waves(fl, self.policy.ladder))
            for w in reversed(subs):
                work.appendleft(w)
            return
        r, = wave.requests   # quarantine isolated it down to one request
        r.stage = STAGE_FAILED
        r.error = f"{type(exc).__name__}: {exc}"
        st["failed"] += 1
        self._failures[r.request_id] = r.error

    def _backoff(self, attempt: int) -> None:
        ms = self.policy.retry_backoff_ms
        if ms <= 0:
            return
        dt = ms * (2 ** (attempt - 1)) / 1e3
        advance = getattr(self.clock, "advance", None)
        if advance is not None:  # ManualClock: simulated time, no sleeping
            advance(dt)
        else:
            time.sleep(dt)

    # -- collection + stats --------------------------------------------------

    def _collect(self, wave: Wave) -> None:
        ids, dists, n_b, n_p, frac, f32, phases, cov, pois = \
            self.pipeline.collect(wave)
        st = self.stats
        health = getattr(self.index, "health", None)
        if pois.any():
            # NaN/inf guard tripped (DESIGN.md §11): locate the poisoned
            # segment, quarantine it, and raise into the retry machinery —
            # the re-run serves at reduced coverage and nothing from this
            # collection is ever recorded as a result.
            st["poison_detected"] += int(pois.sum())
            seg = None
            if health is not None:
                seg = self._locate_poisoned_segment(wave, pois)
                if seg is not None:
                    was = health.state(seg)
                    health.quarantine(seg)
                    if was != QUARANTINED:
                        st["seg_quarantined"] += 1
            raise PoisonedResultError(
                f"{int(pois.sum())} poisoned result rows"
                f" (quarantined segment {seg})")
        if wave.n_real and cov < self.policy.min_coverage:
            # below the coverage floor: try to win segments back first;
            # any re-admission earns the wave a retry at the improved
            # coverage, otherwise its requests FAIL with the achieved
            # coverage attached (DESIGN.md §11).
            if self._maintain() > 0:
                raise CoverageError(
                    f"coverage {cov:.4f} <"
                    f" min_coverage {self.policy.min_coverage:.4f};"
                    " segments recovered, retrying")
            for r in wave.requests:
                r.stage = STAGE_FAILED
                r.error = (f"coverage {cov:.4f} <"
                           f" min_coverage {self.policy.min_coverage:.4f}")
                self._failures[r.request_id] = r.error
            st["failed"] += wave.n_real
            st["min_coverage_failed"] += wave.n_real
            return
        if health is not None:
            for seg in health.alive():
                health.record_success(seg)
        done = self.clock()
        shape_key = (wave.base, wave.k, wave.exact, wave.size)
        cold = shape_key not in self._seen_shapes
        self._seen_shapes.add(shape_key)
        frac_w = float((frac * n_p).sum())
        f32_w = float((f32 * n_p).sum())
        nb_pr, nb_sp, np_pr, np_sp = phases
        st["queries"] += wave.n_real
        st["coverage_w"] += cov * wave.n_real
        st["batches"] += 1
        st["padded_rows"] += wave.padded_rows
        st["n_b"] += float(n_b.sum())
        st["n_p"] += float(n_p.sum())
        st["n_b_probe"] += float(nb_pr.sum())
        st["n_b_spill"] += float(nb_sp.sum())
        st["n_p_probe"] += float(np_pr.sum())
        st["n_p_spill"] += float(np_sp.sum())
        st["dim_frac_w"] += frac_w
        st["f32_rows_w"] += f32_w
        pb = st["per_base"]["G1" if wave.base == 1.0 else "G2"]
        pb["queries"] += wave.n_real
        pb["batches"] += 1
        pb["n_b"] += float(n_b.sum())
        pb["n_p"] += float(n_p.sum())
        pb["dim_frac_w"] += frac_w
        pb["f32_rows_w"] += f32_w
        for i, r in enumerate(wave.requests):
            r.finish_t = done
            self._results[r.request_id] = (ids[i], dists[i])
            pp = st["per_p"].setdefault(
                "%g" % r.p, {"queries": 0, "n_b": 0.0, "n_p": 0.0})
            pp["queries"] += 1
            pp["n_b"] += float(n_b[i])
            pp["n_p"] += float(n_p[i])
            total = (done - r.arrival_t) * 1e3
            queue = max(r.flush_t - r.arrival_t, 0.0) * 1e3
            compute = max(done - r.flush_t, 0.0) * 1e3
            st["latency_ms"].append(total)
            st["latency_records"].append((total, queue, compute, cold))
