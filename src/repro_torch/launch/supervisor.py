"""Process supervisor: restart-on-failure with exponential backoff.

Counterpart of `repro.launch.supervisor`, a plain copy. Wraps any entry
point (typically launch.train) and restarts it when it
exits nonzero or its heartbeat stalls — combined with checkpoint auto-resume
this is the node-failure story: a crashed/preempted worker rejoins from the
last committed checkpoint.

  PYTHONPATH=src python -m repro_torch.launch.supervisor --retries 3 -- \
      python -m repro_torch.launch.train --arch tinyllama_1_1b --smoke \
        --steps 50 --ckpt-dir CKPT_DIR
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time


def supervise(cmd: list[str], retries: int = 3, backoff_s: float = 1.0,
              backoff_factor: float = 2.0) -> int:
    attempt = 0
    while True:
        t0 = time.time()
        print(f"[supervisor] attempt {attempt}: {' '.join(cmd)}", flush=True)
        proc = subprocess.run(cmd)
        if proc.returncode == 0:
            print(f"[supervisor] success after {attempt} restarts", flush=True)
            return 0
        attempt += 1
        if attempt > retries:
            print(f"[supervisor] giving up after {retries} restarts", flush=True)
            return proc.returncode
        delay = backoff_s * backoff_factor ** (attempt - 1)
        print(f"[supervisor] exit code {proc.returncode} after "
              f"{time.time() - t0:.1f}s; restarting in {delay:.1f}s",
              flush=True)
        time.sleep(delay)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--retries", type=int, default=3)
    ap.add_argument("--backoff", type=float, default=1.0)
    ap.add_argument("cmd", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no command given after --")
    return supervise(cmd, retries=args.retries, backoff_s=args.backoff)


if __name__ == "__main__":
    sys.exit(main())
