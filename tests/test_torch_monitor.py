"""The port's straggler watchdog, heartbeat and supervisor: the four tests
of `tests/test_monitor.py` on `repro_torch.train.monitor`, and
`repro_torch.launch.supervisor` restarting a command that fails once and
giving up with the child's exit code."""

import subprocess
import sys
import time
from pathlib import Path

from repro_torch.launch.supervisor import supervise
from repro_torch.train.monitor import HeartbeatMonitor, StepWatchdog

ROOT = Path(__file__).resolve().parents[1]


def test_watchdog_flags_persistent_straggler():
    wd = StepWatchdog(threshold=1.5, patience=3)
    base = {0: 1.0, 1: 1.0, 2: 1.0, 3: 1.0}
    slow = {0: 1.0, 1: 1.0, 2: 1.0, 3: 2.5}
    assert wd.observe(base) == []
    assert wd.observe(slow) == []       # patience 1
    assert wd.observe(slow) == []       # patience 2
    assert wd.observe(slow) == [3]      # flagged


def test_watchdog_ignores_transient_jitter():
    wd = StepWatchdog(threshold=1.5, patience=3)
    slow = {0: 1.0, 1: 1.0, 2: 1.0, 3: 2.5}
    base = {0: 1.0, 1: 1.0, 2: 1.0, 3: 1.0}
    wd.observe(slow)
    wd.observe(slow)
    wd.observe(base)  # recovery resets the counter
    assert wd.observe(slow) == []


def test_rebalance_conserves_shards():
    wd = StepWatchdog()
    hosts = list(range(8))
    plan = wd.rebalance_plan(hosts, flagged=[2, 5], shards_per_host=4)
    assert sum(plan.values()) == 32
    assert plan[2] < 4 and plan[5] < 4
    assert all(plan[h] >= 4 for h in hosts if h not in (2, 5))


def test_heartbeat(tmp_path):
    hb = HeartbeatMonitor(str(tmp_path / "hb.json"), timeout_s=100.0)
    assert not hb.is_stalled()  # no file yet
    hb.beat(5, {"loss": 1.0})
    assert hb.last_step() == 5
    assert not hb.is_stalled()
    assert hb.is_stalled(now=time.time() + 200.0)


def fails_once(marker: Path) -> list[str]:
    """A command that exits 3 the first time (leaving `marker`), then 0."""
    code = ("import pathlib, sys; p = pathlib.Path(sys.argv[1]); "
            "sys.exit(0 if p.exists() else (p.touch() or 3))")
    return [sys.executable, "-c", code, str(marker)]


def test_supervisor_restarts_a_command_that_fails_once(tmp_path, capfd):
    assert supervise(fails_once(tmp_path / "marker"), retries=2, backoff_s=0.01) == 0
    out = capfd.readouterr().out
    assert "exit code 3" in out and "success after 1 restarts" in out


def test_supervisor_gives_up_with_the_childs_exit_code(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.supervisor", "--retries", "1",
           "--backoff", "0.01", "--", sys.executable, "-c", "import sys; sys.exit(7)"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 7
    assert out.stdout.count("attempt") == 2 and "giving up after 1 restarts" in out.stdout
