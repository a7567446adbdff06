#!/usr/bin/env python3
"""Times the port's pairwise_lp, gather_lp_abandon, gather_lp, lp_topk,
gather_lp_screen and rowwise_lp kernels of one source tree on one CUDA card,
at the shapes of `chip_smoke.py`.

    python3 tools/time_torch_kernels.py [--src DIR] [--label NAME] [--variants]

--src is the `src` directory whose `repro_torch` is imported (default: this
checkout's), so two versions of the kernels can be timed in one run on one
card, in turns (old, new, new, old), each in its own process:

    mkdir -p build/old && git archive <commit> src/repro_torch | tar -x -C build/old
    python3 tools/time_torch_kernels.py --src build/old/src --label old

The corpus is the smoke's: the synthetic Sun corpus at its published size
(78,306 x 512, 256 queries, seed 0), indexed by the shared-pass builder (m =
16; the build is run twice, and the second timed: `bulk_build_seconds`).
Cases:
  - pairwise_lp on the build's level-1 call (every node of level >= 1
    against all of them, 4,848 x 4,848 x 512) at p = 1 and p = 2, beside
    torch.cdist of the same rows at the same p, and on the smoke's
    shared-ids call (the 256 queries against 1,024 corpus rows, mixed p);
  - gather_lp_abandon on the first kappa batch after the first k of G1's
    candidates (256 x 5, block_d = 32) at the mixed p of the smoke,
    thresholds from the first k, as the verification loop makes them;
  - gather_lp at the build's scoring shape, both metrics (p = 1 and 2):
    the shared pass's round-2 candidate block as the build makes it
    (78,306 x 448, recorded during the build), then random ids at the same
    shape. A tree with the multi-p kernel (`gather_lp_multi`) scores both
    metrics in its one launch; any tree also in two single-p launches;
  - gather_lp on the query path's first-k call (256 x 10, G1's candidates,
    mixed p);
  - lp_topk at (256, 300, 512) over G1's candidates, k = 10, p = 1.25
    (device times at p = 1 and 2 beside it);
  - gather_lp_screen on the band search's first kappa batch after the
    first k (256 x 5, block_d = 32) at each p of the smoke and the mixed
    batch, the ids and base sums handed over as the verification loop
    hands them (column slices of the candidate lists), thresholds from the
    first k; and one tight case (mixed p, no base bounds, thresholds that
    kill at every depth: `chip_smoke.tight_thresh`);
  - rowwise_lp at (256, 300, 512) over G1's candidates at p = 0.5, 1,
    1.25, 2 and the mixed batch.
With --variants, also gather_lp_multi at other slab sizes
(`lp_distance.SLAB_BYTES`, 0 = one slab: the sort and the duplicate skip
alone), where the tree has it.
Each kernel output is compared with its plain version first (the smoke's
tolerances). The gather_lp, lp_topk, gather_lp_screen and rowwise_lp
outputs are saved under build/time_kernels/ by label; a run whose label
differs from a saved one reports the largest |this - that| per case
(`vs_<label>`: 0 when every value has the same bits, inf where only one
of the two is finite), for lp_topk the share of equal ids, and for the
screen the number of slots whose keep or nd differ (`vs_<label>_keep`,
`vs_<label>_nd`). Times: `ms` is the median per-call CUDA-event time around the
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
SAVED = ROOT / "build" / "time_kernels"


def max_diff(a, b) -> float:
    """Largest |a - b|: 0 where both hold the same value (inf included), inf
    where only one is finite."""
    import torch

    a, b = a.double(), b.double()
    same = (a == b) | (a.isnan() & b.isnan())
    if bool(same.all()):
        return 0.0
    if bool((a.isfinite() != b.isfinite())[~same].any()):
        return float("inf")
    return float((a - b)[~same].abs().max())


def compare_saved(label: str, case: str, outs: dict) -> dict:
    """Saves this run's outputs of a case and compares them with every other
    label's saved outputs of it: {"vs_<label>": largest |difference|, ...}."""
    import torch

    SAVED.mkdir(parents=True, exist_ok=True)
    report = {}
    for path in sorted(SAVED.glob(f"*__{case}.pt")):
        other = path.name.split("__")[0]
        if other == label:
            continue
        theirs = torch.load(path)
        for key, val in outs.items():
            if key == "ids":
                report[f"vs_{other}_ids_equal"] = float((val.cpu() == theirs[key]).float().mean())
            elif key in ("keep", "nd"):
                report[f"vs_{other}_{key}"] = int((val.cpu() != theirs[key]).sum())
            else:
                report[f"vs_{other}" + ("" if key == "out" else f"_{key}")] = max_diff(
                    val.cpu(), theirs[key])
    torch.save({k: v.cpu() for k, v in outs.items()}, SAVED / f"{label}__{case}.pt")
    return report


def record_round2():
    """Context that keeps the shared pass's round-2 candidate block (node
    rows, ids) of a bulk build: the third block the pass scores. A tree with
    the multi-p pass scores each block once (`_score_ids_multi`); an older
    tree scores it once per metric (`_score_ids`, L1 first), so there the
    block is the fifth call's."""
    from contextlib import contextmanager

    from repro_torch.core import bulk_build

    @contextmanager
    def ctx():
        rec = {}
        multi = getattr(bulk_build, "_score_ids_multi", None)
        single = bulk_build._score_ids
        calls = {"multi": 0, "single": 0}

        def on_multi(x, rows, ids, ps):
            if calls["multi"] == 2:
                rec["block"] = (rows.clone(), ids.clone())
            calls["multi"] += 1
            return multi(x, rows, ids, ps)

        def on_single(x, rows, ids, p):
            if multi is None and calls["single"] == 4:
                rec["block"] = (rows.clone(), ids.clone())
            calls["single"] += 1
            return single(x, rows, ids, p)

        if multi is not None:
            bulk_build._score_ids_multi = on_multi
        bulk_build._score_ids = on_single
        try:
            yield rec
        finally:
            bulk_build._score_ids = single
            if multi is not None:
                bulk_build._score_ids_multi = multi

    return ctx()


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
    ap.add_argument("--label", default="this-checkout")
    ap.add_argument("--variants", action="store_true",
                    help="also time gather_lp_multi's slab sizes")
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
    with record_round2() as rec:
        index = UHNSW.build(X, m=cs.M, seed=0, method="bulk")
    # the shared-pass build once more, timed on the host clock (the first one
    # also loaded the kernels)
    t0 = cs._now()
    again = UHNSW.build(X, m=cs.M, seed=0, method="bulk")
    build_s = cs._now() - t0
    cs.check(all(bool(torch.equal(a.arrays.adj0, b.arrays.adj0))
                 for a, b in ((again.g1, index.g1), (again.g2, index.g2))), "rebuild differs")
    del again
    report = {"label": args.label, "src": args.src, "bulk_build_seconds": build_s}

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

    # gather_lp at the build's scoring shape, both metrics
    rows_b, real = rec["block"]
    qb = X[rows_b].contiguous()
    rand = torch.from_numpy(np.random.default_rng(1).integers(0, X.shape[0], real.shape)
                            .astype(np.int32)).to(dev)
    multi = getattr(kd, "gather_lp_multi", None)
    for name, ids_b in (("build_real", real), ("build_random", rand)):
        def two():
            return torch.stack([kd.gather_lp(qb, ids_b, X, p) for p in (1.0, 2.0)])

        def fused():
            return multi(qb, ids_b, X, (1.0, 2.0)) if multi is not None else two()

        out = fused()
        plain_rows = slice(0, cs.PLAIN_ROWS)
        for i, p in enumerate((1.0, 2.0)):
            rel, _, mis = cs.rel_err(out[i, plain_rows],
                                     ref.gather_lp_ref(qb[plain_rows], ids_b[plain_rows], X, p))
            cs.check(mis == 0 and rel <= cs.RTOL, f"gather_lp {name} p={p}: rel {rel}")
        cs.check(bool(torch.equal(out, two())), f"gather_lp {name}: fused and single differ")
        row = {"shape": list(ids_b.shape) + [X.shape[1]], "block": cs.block_stats(ids_b, X.shape[0]),
               "fused_form": "gather_lp_multi" if multi is not None else "two gather_lp",
               **cs.kernel_ms(fused, reps=10, calls=5),
               "two_launches_device_ms": cs.device_ms(two, calls=5),
               **compare_saved(args.label, name, {"out": out})}
        if multi is not None and args.variants:
            saved = kd.SLAB_BYTES
            for mb in (0, 8, 16, 24, 32, 48):
                kd.SLAB_BYTES = mb << 20
                cs.check(bool(torch.equal(fused(), out)), f"gather_lp {name} slab {mb} MB")
                row[f"device_ms_slab_{mb}MB"] = cs.device_ms(fused, calls=5)
            kd.SLAB_BYTES = saved
            row["plan_device_ms"] = cs.device_ms(
                lambda: kd.gather_plan(ids_b, X.shape[0], saved // (4 * X.shape[1])), calls=5)
        report[f"gather_lp_{name}"] = row
        del out

    # gather_lp on the query path's first-k call
    first = c.ids[:, :k].contiguous()
    out = kd.gather_lp(Q, first, X, p_mix)
    rel, _, mis = cs.rel_err(out, ref.gather_lp_ref(Q, first, X, p_mix))
    cs.check(mis == 0 and rel <= cs.RTOL, f"gather_lp first k: rel {rel}")

    def first_k():
        return kd.gather_lp(Q, first, X, p_mix)

    report["gather_lp_first_k"] = {"shape": list(first.shape), **cs.kernel_ms(first_k),
                                   "host_ms": host_ms(first_k),
                                   **compare_saved(args.label, "first_k", {"out": out})}

    # lp_topk over G1's 300 candidates a query
    from repro_torch.kernels import lp_topk as lt

    cand = X[c.ids.long()].contiguous()
    t = cand.shape[1]
    got_d, got_i = lt.lp_topk(Q, cand, 1.25, k)
    want_d, want_i = ref.lp_topk_ref(Q, cand, 1.25, k)
    cs.topk_errors(got_d, got_i, want_d, want_i, ref.rowwise_lp_ref(Q, cand, 1.25), k, "k=10")

    def topk():
        return lt.lp_topk(Q, cand, 1.25, k)

    row = {"shape": [Q.shape[0], t, Q.shape[1]], "k": k, **cs.kernel_ms(topk, reps=20),
           "host_ms": host_ms(topk),
           # the cheap p families beside p = 1.25's accurate log and exp
           **{f"device_ms_p{p:g}": cs.device_ms(lambda: lt.lp_topk(Q, cand, p, k))
              for p in (1.0, 2.0)},
           **compare_saved(args.label, "lp_topk", {"out": got_d, "ids": got_i})}
    report["lp_topk"] = row

    # gather_lp_screen on the band search's kappa batches, as the loop hands them
    band, Qp, bd, cases = cs.screen_setup(index, Q, p_mix)
    kappa_sl = slice(k, k + kappa)
    screen = {}
    for label, p, base, cc, thr in cases:
        batch, sbs = cc.ids[:, kappa_sl], cc.base_dists[:, kappa_sl]
        screen[f"p={label}"] = (batch, sbs, thr, p, base)
    cc = cases[-1][3]
    batch = cc.ids[:, kappa_sl]
    screen["tight, p=mixed, no bound"] = (batch, torch.zeros(batch.shape, device=dev),
                                          cs.tight_thresh(Qp, batch, band, p_mix), p_mix, 1.0)
    for name, (batch, sbs, thr, p, base) in screen.items():
        nd, stats = cs.screen_case(Qp, batch, band, thr, sbs, p, base, bd, name)
        keep, _ = kd.gather_lp_screen(Qp, batch, band.codes, band.scale, band.radius, thr, sbs,
                                      p, base, bd)

        def call():
            return kd.gather_lp_screen(Qp, batch, band.codes, band.scale, band.radius, thr, sbs,
                                       p, base, bd)

        report[f"gather_lp_screen {name}"] = {
            "shape": list(batch.shape), "block_d": bd, **stats, **cs.kernel_ms(call),
            "host_ms": host_ms(call),
            **compare_saved(args.label, f"screen_{name.replace(' ', '_').replace(',', '')}",
                            {"keep": keep.bool(), "nd": nd})}

    # rowwise_lp over G1's 300 candidates a query (cand, as for lp_topk)
    for label, p in (("0.5", 0.5), ("1.0", 1.0), ("1.25", 1.25), ("2.0", 2.0),
                     ("mixed", p_mix)):
        got = kd.rowwise_lp(Q, cand, p)
        rel, abs_err, mis = cs.rel_err(got, ref.rowwise_lp_ref(Q, cand, p))
        cs.check(mis == 0 and rel <= cs.RTOL, f"rowwise_lp p={label}: rel {rel}")

        def rowwise():
            return kd.rowwise_lp(Q, cand, p)

        row = {"shape": list(cand.shape), "max_rel_err": rel, "max_abs_err": abs_err,
               **cs.kernel_ms(rowwise, reps=20), "host_ms": host_ms(rowwise),
               **compare_saved(args.label, f"rowwise_{label}", {"out": got})}
        report[f"rowwise_lp p={label}"] = row
    report["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
