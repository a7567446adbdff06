#!/usr/bin/env python3
"""Times the port's pairwise_lp and gather_lp_abandon kernels of one source
tree on one CUDA card, at the shapes of `chip_smoke.py`.

    python3 tools/time_torch_kernels.py [--src DIR] [--label NAME]

--src is the `src` directory whose `repro_torch` is imported (default: this
checkout's), so two versions of the kernels can be timed in one run on one
card, in turns (old, new, new, old), each in its own process:

    mkdir -p build/old && git archive <commit> src/repro_torch | tar -x -C build/old
    python3 tools/time_torch_kernels.py --src build/old/src --label old

The corpus is the smoke's: the synthetic Sun corpus at its published size
(78,306 x 512, 256 queries, seed 0), indexed by the shared-pass builder (m =
16). Cases:
  - pairwise_lp on the build's level-1 call (every node of level >= 1
    against all of them, 4,848 x 4,848 x 512) at p = 1 and p = 2, beside
    torch.cdist of the same rows at the same p, and on the smoke's
    shared-ids call (the 256 queries against 1,024 corpus rows, mixed p);
  - gather_lp_abandon on the first kappa batch after the first k of G1's
    candidates (256 x 5, block_d = 32) at the mixed p of the smoke,
    thresholds from the first k, as the verification loop makes them.
Each kernel output is compared with its plain version first (the smoke's
tolerances). Times: `ms` is the median per-call CUDA-event time around the
wrapper (host work included), `device_ms` the device-only time of calls
captured in a CUDA graph (`chip_smoke.device_ms`), `host_ms` the host's
time per call over 200 calls issued back to back (the enqueue rate: the
device keeps up whenever `device_ms` is the smaller). One JSON line goes to
stdout, with the card's name and power limit from nvidia-smi.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def host_ms(fn, calls: int = 200) -> float:
    """Host time per call of `calls` calls issued without a synchronisation."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_torch_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core.datasets import make_dataset
    from repro_torch.core.uhnsw import UHNSW
    from repro_torch.kernels import lp_distance as kd
    from repro_torch.kernels import ref

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    ds = make_dataset("sun", n=cs.N_SUN, n_queries=cs.N_QUERIES, seed=0)
    X = torch.from_numpy(ds.data).to(dev)
    Q = torch.from_numpy(ds.queries).to(dev)
    index = UHNSW.build(X, m=cs.M, seed=0, method="bulk")
    report = {"label": args.label, "src": args.src}

    sub = X[torch.nonzero(index.g1.levels >= 1)[:, 0]].contiguous()
    pw = {}
    for p in (1.0, 2.0):
        got = kd.pairwise_lp(sub, sub, p)
        rows = slice(0, cs.PLAIN_ROWS)
        errs = cs.check_pairwise(f"level 1 p={p}", cs.pairwise_errors(
            got[rows], ref.pairwise_lp_ref(sub[rows], sub, p), sub[rows], sub, p))
        pw[str(p)] = {"shape": list(got.shape) + [sub.shape[1]], **errs,
                      **cs.kernel_ms(lambda: kd.pairwise_lp(sub, sub, p), reps=10, calls=10),
                      "library_ms": cs.median_ms(lambda: torch.cdist(sub, sub, p=p), reps=10)}
    ids = torch.from_numpy(np.random.default_rng(0).choice(X.shape[0], cs.SHARED_IDS,
                                                            replace=False)).to(dev)
    xs = X[ids].contiguous()
    p_mix = torch.from_numpy(cs.mixed_p(Q.shape[0])).to(dev)
    errs = cs.check_pairwise("shared ids", cs.pairwise_errors(
        kd.pairwise_lp(Q, xs, p_mix), ref.pairwise_lp_ref(Q, xs, p_mix), Q, xs, p_mix))
    pw["shared ids, mixed p"] = {"shape": [Q.shape[0], cs.SHARED_IDS, Q.shape[1]], **errs,
                                 **cs.kernel_ms(lambda: kd.pairwise_lp(Q, xs, p_mix))}
    report["pairwise_lp"] = pw

    k, kappa, bd = cs.K, cs.K // 2, 32
    c = index.search_stage_candidates(Q, 1.0, k)
    first = c.ids[:, :k].contiguous()
    thresh = torch.sort(ref.gather_lp_ref(Q, first, X, p_mix), dim=1).values[:, k - 1]
    thresh = thresh.contiguous()
    batch = c.ids[:, k:k + kappa].contiguous()
    sb = c.base_dists[:, k:k + kappa].contiguous()
    _, stats = cs.compare_abandon(Q, batch, X, thresh, sb, p_mix, 1.0, bd, "mixed")
    def call():
        return kd.gather_lp_abandon(Q, batch, X, thresh, sb, p_mix, 1.0, bd)

    report["gather_lp_abandon"] = {"shape": list(batch.shape), "block_d": bd, **stats,
                                   **cs.kernel_ms(call), "host_ms": host_ms(call)}
    report["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
