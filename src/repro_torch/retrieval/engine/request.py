"""Per-request state for the continuous-batching serving engine.

Counterpart of `repro.retrieval.engine.request` (host only, no torch).

An `EngineRequest` wraps one ANNS-U-Lp query (`retrieval.service
.QueryRequest`) with everything the engine's scheduler and pipeline need
to track it through its life cycle (DESIGN.md §6):

    queued -> flushed -> searching -> verifying -> done
                 \\-> shed    (admission control, overload policy "shed")
                 \\-> failed  (retries exhausted after quarantine isolation;
                               `error` carries the final exception message)

Timestamps come from the engine's *injectable clock* (seconds, monotonic
by contract) — `arrival_t` at admission, `flush_t` when the scheduler
dispatches the request's bucket, `finish_t` when its wave's results
materialize on host. The deadline (`deadline_t = arrival_t + max_wait`)
is what drives deadline-triggered bucket flush: a partial bucket
dispatches the moment its *oldest* request's deadline expires, so tail
latency is bounded by max_wait + one wave of device time instead of by
"when does this bucket happen to fill".

Between the two pipeline stages the batched query tensor and the
candidate set stay device-resident (see `pipeline.Wave`); the request
object itself only ever holds host-side metadata.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# life-cycle stages (plain strings: cheap, printable, json-able)
QUEUED = "queued"
FLUSHED = "flushed"
SEARCHING = "searching"
VERIFYING = "verifying"
DONE = "done"
SHED = "shed"
FAILED = "failed"   # terminal: retry budget exhausted on an isolated wave


@dataclass
class EngineRequest:
    """One in-flight query and its scheduling metadata.

    `degraded=True` marks a request the overload policy short-circuited
    onto the exact-base fast lane (served under its base metric, skipping
    general-p verification): the response is approximate and the caller
    can tell from `stats["degraded"]`.
    """

    vector: np.ndarray          # (d,) f32 host copy
    p: float                    # the request's own metric (paper §1)
    k: int
    request_id: int
    base: float                 # base graph pick: 1.0 = G1, 2.0 = G2
    exact: bool                 # p == base: no verification needed
    arrival_t: float            # clock() at admission
    deadline_t: float           # arrival_t + max_wait (flush trigger)
    stage: str = QUEUED
    flush_t: float = field(default=0.0)
    finish_t: float = field(default=0.0)
    degraded: bool = False
    retries: int = 0            # device-call re-executions this request rode
    error: str | None = None    # final exception message when stage == FAILED

    @property
    def queue_wait_s(self) -> float:
        """Admission -> dispatch (what deadline flush bounds)."""
        return self.flush_t - self.arrival_t

    @property
    def compute_s(self) -> float:
        """Dispatch -> host materialization (device + pipeline residency)."""
        return self.finish_t - self.flush_t

    def group_key(self) -> tuple[float, int, bool]:
        """The scheduler's two-way-partition bucket key (DESIGN.md §6):
        base graph x k x exact-lane — never one bucket per distinct p."""
        return (self.base, self.k, self.exact)
