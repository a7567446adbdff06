"""Deterministic fault injection for the serving engine (DESIGN.md §9, §11).

Counterpart of `repro.retrieval.engine.faults`, with the same seeded
schedules: one seed gives the same faults in both packages.

Production accelerator calls fail: transient device errors, preempted
devices, collective timeouts. The engine's recovery machinery (bounded
retry, bisection quarantine, terminal FAILED marking) has to be exercised
against *reproducible* failure schedules, so the injector is a seeded PRNG
drawn once per guarded site — the same seed and the same wave schedule
produce the same faults, which is what lets the chaos CI lane assert exact
terminal states across runs.

The seeded-schedule contract, precisely:

  * One uniform draw is consumed per *enabled* call to `check`, in call
    order. Same seed + same sequence of enabled `check` calls => the same
    fault schedule, independent of wall clock, host, or library version.
  * A `check` on a site excluded by the `sites` filter consumes NO draw —
    filtering a site out never perturbs the schedule the remaining sites
    see. This is what lets a chaos run target, say, a search-only
    schedule (`sites=("search",)`) and still reproduce the exact faults
    of a full-site run restricted to its search draws.
  * `reset()` rewinds the PRNG to the seed state and zeroes every
    injected counter (total and per-site), giving a byte-identical
    replay of the schedule from the top.

The engine consults the injector only at its device-call boundary
(`ServingEngine._advance`), guarded by a single `is not None` check —
with no injector configured the happy path carries zero overhead (the
acceptance criterion: fault tolerance compiled out when disabled).

Sites (the engine's three device interactions, plus per-segment sites):

    "search"      — before stage A dispatch (base-graph candidate gen)
    "verify"      — before stage B dispatch (general-p verification)
    "collect"     — before host materialization of a wave's results
    "segment:<i>" — a fault attributable to frozen segment i of a
                    sharded index (DESIGN.md §11). Segment sites are
                    *opt-in*: the engine only draws them when the
                    `sites` filter names them (exactly, or via the
                    "segment" wildcard entry), so adding segment chaos
                    never shifts the classic three-site schedules.

`InjectedTimeout` models a stuck device call (distinct type so tests can
assert the retry path is exception-type agnostic); `InjectedSegmentFault`
carries the segment it hit so the engine can feed the health tracker's
failure EWMA. All derive from `InjectedFault`, and the engine treats
*any* exception from a device call identically — real faults get the
same bounded recovery as injected ones.
"""

from __future__ import annotations

import numpy as np
import torch

SITES = ("search", "verify", "collect")

# `sites` filter entry that enables every per-segment site at once
SEGMENT_WILDCARD = "segment"


def segment_site(seg: int) -> str:
    """The per-segment fault-site name for frozen segment `seg`."""
    return f"segment:{int(seg)}"


class InjectedFault(RuntimeError):
    """A simulated transient device-call failure."""


class InjectedTimeout(InjectedFault):
    """A simulated stuck/timed-out device call."""


class InjectedSegmentFault(InjectedFault):
    """A simulated fault attributable to one frozen segment."""

    def __init__(self, msg: str, segment: int):
        super().__init__(msg)
        self.segment = int(segment)


def poison_segment(index, seg: int) -> np.ndarray:
    """NaN-poison every row of frozen segment `seg`, everywhere the query
    path can gather it: the frozen rows `X` (the verify copy), the stacked
    per-segment `segments.X`, and the per-graph data a later restack would
    read. Models silent row corruption (bad DMA, a flipped HBM page) rather
    than a failed call: nothing raises; the index's query-time NaN/inf
    guard (DESIGN.md §11) is what must notice. `index.X` is copied before
    the write, so the caller's corpus, which it may share memory with,
    stays clean; the caches over the clean rows (band, energy-ordered
    view, probe-phase sub-stacks) are dropped. Accepts a DurableIndex or a
    bare ShardedUHNSW; returns the poisoned segment's global ids (the set
    no result may ever contain).
    """
    # imported here: the index package does not import the serving engine
    from repro_torch.index.persist import write_segment_rows

    index = getattr(index, "index", index)  # unwrap DurableIndex
    gids = np.asarray(index.segments.global_ids[seg], dtype=np.int64)
    bad = torch.full((len(gids), index.dim), float("nan"), device=index.X.device)
    write_segment_rows(index, seg, gids, bad)
    return gids


class FaultInjector:
    """Seeded Bernoulli fault source, one draw per enabled call site.

    rate: probability a guarded call raises InjectedFault.
    timeout_rate: additional probability it raises InjectedTimeout.
    sites: restrict injection to a site subset (None = the three classic
      SITES). Entries may be classic site names, explicit per-segment
      sites ("segment:3"), or the "segment" wildcard enabling all
      per-segment sites. Per-segment sites fire only when named here —
      see the module docstring for the full seeded-schedule contract
      (enabled calls consume draws in call order; filtered calls consume
      nothing; `reset()` replays the schedule exactly and clears the
      `injected` / `injected_by_site` counters).
    """

    def __init__(self, rate: float = 0.1, timeout_rate: float = 0.0,
                 seed: int = 0, sites: tuple[str, ...] | None = None):
        assert 0.0 <= rate + timeout_rate <= 1.0, (rate, timeout_rate)
        if sites is not None:
            unknown = {s for s in sites
                       if s not in SITES and s != SEGMENT_WILDCARD
                       and not s.startswith("segment:")}
            assert not unknown, f"unknown fault sites {sorted(unknown)}"
        self.rate = float(rate)
        self.timeout_rate = float(timeout_rate)
        self.seed = int(seed)
        self.sites = tuple(sites) if sites is not None else None
        self.injected = 0
        self.injected_by_site: dict[str, int] = {}
        self._rng = np.random.default_rng(self.seed)

    def reset(self) -> None:
        """Rewind to the seed state (fresh deterministic schedule) and
        zero the injected counters, total and per-site."""
        self._rng = np.random.default_rng(self.seed)
        self.injected = 0
        self.injected_by_site = {}

    def enabled(self, site: str) -> bool:
        """Whether `check(site)` would consume a draw. Segment sites are
        opt-in; classic sites default on (module docstring)."""
        if site.startswith("segment:"):
            return self.sites is not None and (
                site in self.sites or SEGMENT_WILDCARD in self.sites)
        return self.sites is None or site in self.sites

    def _record(self, site: str) -> int:
        self.injected += 1
        self.injected_by_site[site] = self.injected_by_site.get(site, 0) + 1
        return self.injected

    def check(self, site: str) -> None:
        """Raise iff this draw lands inside the configured fault mass.
        Disabled sites consume no draw (seeded-schedule contract)."""
        if not self.enabled(site):
            return
        u = self._rng.random()
        if u < self.rate:
            n = self._record(site)
            if site.startswith("segment:"):
                raise InjectedSegmentFault(
                    f"injected segment fault at {site} (#{n})",
                    segment=int(site.split(":", 1)[1]))
            raise InjectedFault(
                f"injected transient fault at {site} (#{n})")
        if u < self.rate + self.timeout_rate:
            n = self._record(site)
            raise InjectedTimeout(f"injected timeout at {site} (#{n})")
