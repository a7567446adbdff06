"""Deadline-triggered bucket scheduler for the serving engine.

Counterpart of `repro.retrieval.engine.scheduler` (host only, no torch).

The engine's scheduling problem (DESIGN.md §6): group an arrival stream
of mixed-p queries into homogeneous-base device batches *without* the v1
micro-batcher's two failure modes —

  * waiting for a bucket to fill (unbounded queue-wait at low traffic),
  * power-of-two padding + a hard verify-batch cap (wasted device rows
    and fragmented calls at high traffic).

Two mechanisms replace them:

**Deadline flush.** Buckets are keyed (base, k, exact) exactly like v1.
A bucket dispatches when it is FULL (max_batch rows ready) or when its
oldest request's deadline (`arrival + max_wait`) expires — whichever
comes first, evaluated against an *injectable clock* so tests (and the
simulated-time latency benchmark) drive time explicitly and never sleep.
`flush_all` force-flushes the remainder (reason "drain") when the caller
has no more arrivals.

**Half-octave ladder + exact-fit chunking.** A flush is cut into device
calls with sizes drawn greedily (largest first) from the ladder

    {min_bucket * 2^i} U {1.5 * min_bucket * 2^i}    (capped at max_batch)

e.g. min_bucket=8, max_batch=128 -> {8, 12, 16, 24, 32, 48, 64, 96, 128}.
Any multiple of min_bucket/2 >= min_bucket decomposes exactly (96 -> 96;
60 -> 48+12), so only sub-min_bucket tails ever pad — v1's pure
power-of-two ladder pads every non-power-of-two flush (96 -> 128 = 33%
wasted rows). The ladder stays a fixed finite set of batch shapes per
(base, k-lane) family, independent of traffic (the reference compiles one
program per shape; the port compiles nothing per shape).

Admission control lives here too: past a queue-depth watermark the
scheduler either sheds new requests (reject, counted) or degrades them
onto the exact-base fast lane (approximate base-metric answer, no
verification, counted) — the engine stays live under overload instead
of queueing into its own deadline misses.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from repro_torch.retrieval.engine.request import FLUSHED, EngineRequest

# flush reasons (stats keys)
FULL = "full"
DEADLINE = "deadline"
DRAIN = "drain"

# overload policies
SHED = "shed"
DEGRADE = "degrade"


class ManualClock:
    """A hand-advanced clock for deterministic tests and simulated-time
    benchmarks: `clock()` returns the current simulated seconds and
    `advance(dt)` / `set(t)` move it. No wall-clock sleeps, ever."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t

    def set(self, t: float) -> float:
        self.t = float(t)
        return self.t


def bucket_ladder(min_bucket: int, max_batch: int) -> list[int]:
    """The half-octave device-batch size ladder (ascending)."""
    sizes = set()
    s = min_bucket
    while s <= max_batch:
        sizes.add(s)
        if s + s // 2 <= max_batch:
            sizes.add(s + s // 2)
        s *= 2
    sizes.add(max_batch)
    return sorted(sizes)


def chunk_plan(n: int, ladder: list[int]) -> list[int]:
    """Decompose n rows into ladder-sized device calls, minimizing
    (padded rows, number of calls) lexicographically — padded rows cost
    full device compute, an extra call only dispatch overhead.

    Returns sizes (descending) summing to >= n. E.g. ladder {8..128}:
    96 -> [96] (exact), 60 -> [48, 12] (exact), 30 -> [32] (2 pad, beats
    24+8's same padding with two calls), 11 -> [12] (1 pad). Exhaustive
    DP over n <= max_batch x a ~9-entry ladder: negligible host work.
    """
    assert n > 0
    # best[r] = (pad, calls, plan) to cover r remaining rows
    best: list[tuple[int, int, list[int]] | None] = [None] * (n + 1)
    best[0] = (0, 0, [])
    for r in range(1, n + 1):
        cand = None
        for s in ladder:
            if s >= r:  # one padded (or exact) chunk finishes it
                c = (s - r, 1, [s])
            elif best[r - s] is not None:
                pad, calls, plan = best[r - s]
                c = (pad, calls + 1, plan + [s])
            else:
                continue
            if cand is None or (c[0], c[1]) < (cand[0], cand[1]):
                cand = c
        best[r] = cand
    pad, calls, plan = best[n]
    return sorted(plan, reverse=True)


@dataclass
class Flush:
    """One dispatched bucket: a homogeneous-(base, k, exact) FIFO slice
    of the queue plus why it left the scheduler now."""

    base: float
    k: int
    exact: bool
    requests: list[EngineRequest]
    reason: str  # FULL | DEADLINE | DRAIN


@dataclass
class EnginePolicy:
    """Scheduling knobs (service-level defaults mirror v1 where shared).

    max_wait_ms bounds queue-wait: it is the deadline-flush trigger.
    watermark/overload are admission control — None disables it (the
    offline `serve` path never sheds).
    """

    max_batch: int = 128
    min_bucket: int = 8
    max_wait_ms: float = 2.0
    queue_capacity: int = 4096
    watermark: int | None = None   # queued-request depth that trips overload
    overload: str = SHED           # SHED (reject) | DEGRADE (exact-base lane)
    # failure recovery (DESIGN.md §9): a wave that raises is retried up to
    # max_retries times, then bisected (quarantine) with fresh budgets per
    # half; a *singleton* wave that exhausts its budget marks its request
    # FAILED — total device calls are bounded by (max_retries+1)*(2n-1).
    max_retries: int = 2
    retry_backoff_ms: float = 0.0  # exponential base; ManualClock advances
    # degraded serving (DESIGN.md §11): minimum acceptable index coverage
    # fraction for a wave's results. A wave collected below it first
    # triggers an inline recovery attempt of quarantined segments; if
    # coverage still cannot be met, its requests are marked FAILED with
    # the achieved coverage attached. 0.0 = serve at any coverage.
    min_coverage: float = 0.0

    def __post_init__(self):
        assert self.min_bucket >= 1 and self.max_batch >= self.min_bucket
        assert 0.0 <= self.min_coverage <= 1.0, self.min_coverage
        if self.overload not in (SHED, DEGRADE):
            raise ValueError(f"unknown overload policy {self.overload!r}")
        self.ladder = bucket_ladder(self.min_bucket, self.max_batch)


class BucketScheduler:
    """FIFO buckets keyed (base, k, exact) with full-or-deadline flush.

    The clock is any zero-arg callable returning seconds; the default is
    `time.perf_counter`. All flush decisions are made against it, so a
    `ManualClock` makes every deadline test deterministic.
    """

    def __init__(self, policy: EnginePolicy, clock=None):
        self.policy = policy
        self.clock = clock if clock is not None else time.perf_counter
        self._buckets: dict[tuple[float, int, bool], list[EngineRequest]] = {}
        self._depth = 0

    @property
    def depth(self) -> int:
        """Requests queued (admitted, not yet flushed)."""
        return self._depth

    def admit(self, req: EngineRequest) -> None:
        self._buckets.setdefault(req.group_key(), []).append(req)
        self._depth += 1

    def over_watermark(self) -> bool:
        wm = self.policy.watermark
        return wm is not None and self._depth >= wm

    def next_deadline(self) -> float | None:
        """Earliest queued deadline (the next time a poll could flush),
        or None when nothing is queued. Event-driven callers (the paced
        simulation in benchmarks/serving.py) advance their clock to this."""
        heads = [b[0].deadline_t for b in self._buckets.values() if b]
        return min(heads) if heads else None

    def _pop(self, key, n: int, reason: str, now: float) -> Flush:
        entries = self._buckets[key]
        taken, rest = entries[:n], entries[n:]
        if rest:
            self._buckets[key] = rest
        else:
            del self._buckets[key]
        self._depth -= len(taken)
        for r in taken:
            r.stage = FLUSHED
            r.flush_t = now
        base, k, exact = key
        return Flush(base=base, k=k, exact=exact, requests=taken,
                     reason=reason)

    def poll(self, now: float | None = None) -> list[Flush]:
        """Flush decisions as of `now`: every full bucket (max_batch FIFO
        rows each, repeatedly while over-full) and every bucket whose
        oldest request's deadline has expired."""
        now = self.clock() if now is None else now
        mb = self.policy.max_batch
        flushes = []
        for key in sorted(self._buckets):  # deterministic dispatch order
            while key in self._buckets and len(self._buckets[key]) >= mb:
                flushes.append(self._pop(key, mb, FULL, now))
            if key in self._buckets and \
                    self._buckets[key][0].deadline_t <= now:
                flushes.append(self._pop(key, mb, DEADLINE, now))
        return flushes

    def flush_all(self, now: float | None = None,
                  reason: str = DRAIN) -> list[Flush]:
        """Force-flush everything queued (end of stream / explicit drain)."""
        now = self.clock() if now is None else now
        mb = self.policy.max_batch
        flushes = []
        for key in sorted(self._buckets):
            while key in self._buckets:
                n = min(mb, len(self._buckets[key]))
                flushes.append(self._pop(
                    key, n, FULL if n == mb else reason, now))
        return flushes

    def requeue(self, requests: list[EngineRequest]) -> None:
        """Put flushed-but-unserved requests back at the FRONT of their
        buckets, preserving FIFO order (failure recovery)."""
        by_key: dict[tuple, list[EngineRequest]] = {}
        for r in requests:
            by_key.setdefault(r.group_key(), []).append(r)
        for key, reqs in by_key.items():
            self._buckets[key] = reqs + self._buckets.get(key, [])
            self._depth += len(reqs)
