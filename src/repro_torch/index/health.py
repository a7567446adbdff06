"""Per-segment health tracking for degraded-coverage serving (DESIGN.md §11).

A copy of `repro.index.health` (pure NumPy), kept here so that the port
runs without the reference package.

A ShardedUHNSW's frozen segments are its failure domains: a segment's
device copy can be lost (preemption), its rows corrupted (a poisoned
gather path), or its device calls can start failing transiently. Without
this module the index would be all-or-nothing: one bad segment poisons
or fails every query that touches it. It gives each segment a tiny
state machine so the rest of the index keeps serving, at *known,
reported* coverage:

      HEALTHY ──(failure EWMA ≥ suspect_threshold)──▶ SUSPECT
      SUSPECT ──(failure EWMA ≥ quarantine_threshold)▶ QUARANTINED
      SUSPECT ──(EWMA decays below suspect)──────────▶ HEALTHY
      QUARANTINED ──(restore begins)─────────────────▶ RECOVERING
      RECOVERING ──(canary probes pass)──────────────▶ HEALTHY
      RECOVERING ──(restore/probe fails)─────────────▶ QUARANTINED

HEALTHY and SUSPECT segments serve queries (SUSPECT is a warning level,
not an exclusion); QUARANTINED and RECOVERING segments are left out of
the segmented search (`ShardedUHNSW` reads `alive()` per query), and
every result reports the exact fraction of the corpus it actually
searched (`SearchStats.coverage_frac`).

Two paths into quarantine:

  * **EWMA**: transient per-segment device faults (`record_failure`,
    e.g. the engine attributing an `InjectedSegmentFault`) drive the
    exponentially-weighted failure rate up through SUSPECT into
    QUARANTINED; successes decay it back.
  * **direct**: `quarantine(seg)` — the engine's poison bisection
    (DESIGN.md §11) attributes a NaN-poisoned result to one segment in
    O(log S) probes and quarantines it immediately.

Re-admission is gated on **canary probes**: after a segment's rows are
restored from the latest durable snapshot (CRC re-verified,
`persist.restore_segment`), `ShardedUHNSW.canary_probe` self-queries
segment members (top-1 must be the member itself, at a finite
distance, with the NaN guard clean) `probe_successes` times before
`readmit` returns the segment to serving.

Every transition that changes the serving set bumps `generation`, which
keys the index's host-side policy caches (phase sub-stacks) and tells
the engine a retried wave will see a different mask.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

HEALTHY = "healthy"
SUSPECT = "suspect"
QUARANTINED = "quarantined"
RECOVERING = "recovering"

STATES = (HEALTHY, SUSPECT, QUARANTINED, RECOVERING)

# states that serve traffic (feed the alive mask)
SERVING_STATES = (HEALTHY, SUSPECT)


@dataclass(frozen=True)
class HealthPolicy:
    """Knobs for the per-segment failure state machine.

    ewma_alpha: weight of the newest observation in the failure EWMA
      (higher = faster reaction, noisier). Must be in (0, 1].
    suspect_threshold: EWMA failure rate at which a HEALTHY segment
      becomes SUSPECT (still serving — a warning level).
    quarantine_threshold: EWMA at which a SUSPECT segment is pulled
      from serving. Must be >= suspect_threshold.
    probe_successes: consecutive canary-probe passes required before a
      RECOVERING segment is re-admitted.
    """

    ewma_alpha: float = 0.3
    suspect_threshold: float = 0.3
    quarantine_threshold: float = 0.7
    probe_successes: int = 2

    def __post_init__(self):
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError(
                f"ewma_alpha must be in (0, 1], got {self.ewma_alpha}")
        if not 0.0 < self.suspect_threshold <= self.quarantine_threshold:
            raise ValueError(
                f"need 0 < suspect_threshold <= quarantine_threshold, got "
                f"{self.suspect_threshold} / {self.quarantine_threshold}")
        if self.probe_successes < 1:
            raise ValueError(
                f"probe_successes must be >= 1, got {self.probe_successes}")


class SegmentHealthTracker:
    """The per-segment state machine + failure EWMA (module docstring).

    Host-side and cheap: O(S) python state, consulted once per search to
    build the alive mask. Not thread-safe (the serving engine drives it
    from its single pump loop).
    """

    def __init__(self, num_segments: int, policy: HealthPolicy | None = None):
        self.policy = policy or HealthPolicy()
        self.states: list[str] = [HEALTHY] * int(num_segments)
        self.ewma: list[float] = [0.0] * int(num_segments)
        self._probe_streak: list[int] = [0] * int(num_segments)
        # bumps whenever the serving set changes: callers key caches on it
        self.generation = 0
        self.counters = {
            "quarantined": 0,    # transitions into QUARANTINED (any path)
            "recovered": 0,      # RECOVERING -> HEALTHY re-admissions
            "probes": 0,         # canary probes run
            "failures": 0,       # per-segment failures recorded
        }

    # -- observation ---------------------------------------------------------

    @property
    def num_segments(self) -> int:
        return len(self.states)

    def resize(self, num_segments: int) -> None:
        """Grow to a compacted segment count; new segments start HEALTHY
        and existing states (quarantines included) are preserved."""
        grow = int(num_segments) - len(self.states)
        if grow < 0:
            raise ValueError(
                f"segment count cannot shrink ({len(self.states)} -> "
                f"{num_segments}); segments are append-only")
        self.states += [HEALTHY] * grow
        self.ewma += [0.0] * grow
        self._probe_streak += [0] * grow

    def state(self, seg: int) -> str:
        return self.states[seg]

    def alive(self) -> list[int]:
        """Segment indices currently serving (HEALTHY or SUSPECT)."""
        return [i for i, s in enumerate(self.states) if s in SERVING_STATES]

    def quarantined(self) -> list[int]:
        return [i for i, s in enumerate(self.states) if s == QUARANTINED]

    def alive_mask(self) -> np.ndarray:
        """(S,) bool mask over the stacked segment axis."""
        return np.asarray([s in SERVING_STATES for s in self.states])

    def coverage(self, sizes: list[int], extra: int = 0) -> float:
        """Exact served fraction of the corpus: alive frozen rows plus
        `extra` (the always-served delta tier) over the total."""
        total = sum(sizes) + extra
        if total <= 0:
            return 1.0
        live = sum(n for i, n in enumerate(sizes)
                   if self.states[i] in SERVING_STATES)
        return (live + extra) / total

    # -- EWMA transitions ----------------------------------------------------

    def record_success(self, seg: int) -> str:
        """A clean device interaction touching `seg`: decay its EWMA, and
        let a SUSPECT segment return to HEALTHY once it decays back under
        the suspect threshold."""
        a = self.policy.ewma_alpha
        self.ewma[seg] = (1.0 - a) * self.ewma[seg]
        if self.states[seg] == SUSPECT \
                and self.ewma[seg] < self.policy.suspect_threshold:
            self.states[seg] = HEALTHY
        return self.states[seg]

    def record_failure(self, seg: int) -> str:
        """A device failure attributed to `seg` (e.g. an injected
        per-segment fault site): bump the EWMA and walk the state machine
        HEALTHY -> SUSPECT -> QUARANTINED as thresholds are crossed."""
        a = self.policy.ewma_alpha
        self.ewma[seg] = (1.0 - a) * self.ewma[seg] + a
        self.counters["failures"] += 1
        st = self.states[seg]
        if st == HEALTHY and self.ewma[seg] >= self.policy.suspect_threshold:
            self.states[seg] = SUSPECT
            st = SUSPECT
        if st == SUSPECT \
                and self.ewma[seg] >= self.policy.quarantine_threshold:
            self._enter_quarantine(seg)
        return self.states[seg]

    # -- direct transitions (poison attribution + recovery) ------------------

    def _enter_quarantine(self, seg: int) -> None:
        self.states[seg] = QUARANTINED
        self._probe_streak[seg] = 0
        self.counters["quarantined"] += 1
        self.generation += 1

    def quarantine(self, seg: int) -> None:
        """Pull `seg` from serving immediately (the engine's poison
        bisection lands here; also RECOVERING segments that fail their
        restore or canary probes). Idempotent."""
        if self.states[seg] != QUARANTINED:
            self._enter_quarantine(seg)

    def begin_recovery(self, seg: int) -> None:
        """QUARANTINED -> RECOVERING (a restore is in progress; the
        segment stays out of the serving set until re-admitted)."""
        if self.states[seg] != QUARANTINED:
            raise ValueError(
                f"segment {seg} is {self.states[seg]}, not quarantined")
        self.states[seg] = RECOVERING

    def record_probe(self, seg: int, ok: bool) -> int:
        """One canary-probe outcome for a RECOVERING segment. Returns the
        current pass streak (a failure resets it to zero)."""
        self.counters["probes"] += 1
        self._probe_streak[seg] = self._probe_streak[seg] + 1 if ok else 0
        return self._probe_streak[seg]

    def probe_passed(self, seg: int) -> bool:
        """Has `seg` accumulated enough consecutive canary passes?"""
        return self._probe_streak[seg] >= self.policy.probe_successes

    def readmit(self, seg: int) -> None:
        """RECOVERING -> HEALTHY after the canary gate. Resets the EWMA —
        the restored rows are a fresh copy, old failures don't carry."""
        if self.states[seg] != RECOVERING:
            raise ValueError(
                f"segment {seg} is {self.states[seg]}, not recovering")
        if not self.probe_passed(seg):
            raise ValueError(
                f"segment {seg} has probe streak {self._probe_streak[seg]} "
                f"< required {self.policy.probe_successes}")
        self.states[seg] = HEALTHY
        self.ewma[seg] = 0.0
        self._probe_streak[seg] = 0
        self.counters["recovered"] += 1
        self.generation += 1

    # -- reporting -----------------------------------------------------------

    def summary(self) -> dict:
        """Operator-facing snapshot (latency_summary / launch.serve)."""
        by_state = {s: 0 for s in STATES}
        for s in self.states:
            by_state[s] += 1
        return {
            "segments": len(self.states),
            "by_state": by_state,
            "generation": self.generation,
            **{k: int(v) for k, v in self.counters.items()},
        }
