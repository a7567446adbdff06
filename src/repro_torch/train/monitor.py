"""Straggler mitigation + heartbeat monitoring.

Counterpart of `repro.train.monitor`, a plain copy (it never imported JAX).
On a real multi-pod deployment these hooks attach to the coordinator:
  * StepWatchdog flags hosts whose step times exceed k x the fleet median
    (persistent stragglers, not transient jitter) and emits a rebalance
    plan that shrinks the slow host's data shard;
  * HeartbeatMonitor watches a progress file and lets the supervisor kill
    and restart a hung process (the checkpoint/restart path then resumes).

The policies are pure functions over observed timings so they are unit-
testable in-container; the supervisor (repro_torch/launch/supervisor.py) wires them to
real processes.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from pathlib import Path


@dataclass
class StepWatchdog:
    """Flags persistent stragglers from per-host step-time streams."""

    threshold: float = 1.5      # x median
    patience: int = 3           # consecutive slow steps before flagging
    history: dict = field(default_factory=dict)   # host -> [durations]
    slow_counts: dict = field(default_factory=dict)

    def observe(self, step_times: dict[int, float]) -> list[int]:
        """step_times: host -> seconds for one step. Returns flagged hosts."""
        times = sorted(step_times.values())
        median = times[len(times) // 2]
        flagged = []
        for host, t in step_times.items():
            self.history.setdefault(host, []).append(t)
            if t > self.threshold * median:
                self.slow_counts[host] = self.slow_counts.get(host, 0) + 1
            else:
                self.slow_counts[host] = 0
            if self.slow_counts[host] >= self.patience:
                flagged.append(host)
        return flagged

    def rebalance_plan(self, hosts: list[int], flagged: list[int],
                       shards_per_host: int) -> dict[int, int]:
        """Shrink flagged hosts' data shards, spreading them to healthy hosts.

        Returns host -> shard_count (total preserved)."""
        plan = {h: shards_per_host for h in hosts}
        healthy = [h for h in hosts if h not in flagged]
        if not healthy:
            return plan
        moved = 0
        for h in flagged:
            give = max(shards_per_host // 2, 1)
            plan[h] -= give
            moved += give
        for i in range(moved):
            plan[healthy[i % len(healthy)]] += 1
        assert sum(plan.values()) == shards_per_host * len(hosts)
        return plan


@dataclass
class HeartbeatMonitor:
    """Progress-file watchdog: stalls longer than `timeout_s` are hangs."""

    path: str
    timeout_s: float = 300.0

    def beat(self, step: int, metrics: dict | None = None):
        payload = {"step": step, "time": time.time(), **(metrics or {})}
        Path(self.path).parent.mkdir(parents=True, exist_ok=True)
        tmp = f"{self.path}.tmp"
        Path(tmp).write_text(json.dumps(payload))
        os.replace(tmp, self.path)

    def is_stalled(self, now: float | None = None) -> bool:
        try:
            payload = json.loads(Path(self.path).read_text())
        except (FileNotFoundError, json.JSONDecodeError):
            return False  # not started yet
        return ((now or time.time()) - payload["time"]) > self.timeout_s

    def last_step(self) -> int | None:
        try:
            return json.loads(Path(self.path).read_text())["step"]
        except (FileNotFoundError, json.JSONDecodeError, KeyError):
            return None
