#!/usr/bin/env python3
"""Drives the port's U-HNSW query path once on one CUDA card, at full size.

    python3 chip_smoke.py

The path: the synthetic Sun corpus at its published size (78,306 x 512,
256 queries, seed 0) -> UHNSW.build (G1 under L1 and G2 under L2, bulk
builder, m = 16, dense steps on the card) -> UHNSW.search with the default
parameters (t = 300, tau = 0.92, kappa = k // 2, ef = 2t, early-abandoning
verification) at k = 10 and p in {0.5, 0.8, 1.25, 2.0}, then once on a
mixed-p batch cycling through the same four values.

It builds the CUDA kernels with nvcc first, holds each kernel against its
plain PyTorch version on the card at the path's shapes, measures recall
against a brute-force top-k and checks it against the same search with the
plain versions, and checks that every row of the mixed batch equals the
scalar call at its p. One JSON object per phase, with its seconds, goes to stdout;
then the card's name and power limit, the kernel summary, and last
{"ok": true, "device": {...}}. Any failed check raises (exit code != 0).
Without a CUDA device it exits with code 2 before doing anything.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

P_SCALAR = (0.5, 0.8, 1.25, 2.0)
N_SUN = 78_306           # src/repro/core/datasets.py PAPER_DATASETS["sun"]
N_QUERIES = 256
K = 10
M = 16
RTOL = 1e-5              # f32 sums taken in another order than the plain version
MAX_RECALL_GAP = 0.002
TIMING_REPS = 50
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
# Operations per element of each p family: sub, abs, (pow sequence), add.
OPS_PER_ELEMENT = {1.0: 3, 2.0: 3, 0.5: 4, 1.5: 5}
OPS_GENERAL = 6


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Check(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise Check(what)


def _sync():
    import torch

    torch.cuda.synchronize()


def _now() -> float:
    _sync()
    return time.perf_counter()


def median_ms(fn, reps: int = TIMING_REPS, warmup: int = 5) -> float:
    """Median of `reps` per-call CUDA-event times after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    _sync()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def ops_per_element(p) -> np.ndarray:
    if hasattr(p, "cpu"):
        p = p.cpu().numpy()
    pv = np.atleast_1d(np.asarray(p, dtype=np.float64))
    return np.array([OPS_PER_ELEMENT.get(float(x), OPS_GENERAL) for x in pv])


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextmanager
def plain_versions():
    """Routes the query path's two kernel wrappers to their plain versions
    for the comparison run; the kernels' own code is not touched."""
    from repro_torch.kernels import lp_distance, ref

    saved = lp_distance.gather_lp, lp_distance.gather_lp_abandon
    lp_distance.gather_lp = ref.gather_lp_ref
    lp_distance.gather_lp_abandon = ref.gather_lp_abandon_ref
    try:
        yield
    finally:
        lp_distance.gather_lp, lp_distance.gather_lp_abandon = saved


def rel_err(got, want) -> tuple[float, float, int]:
    """(max relative error, max absolute error) over entries finite in both,
    and the number of entries finite in exactly one."""
    fg, fw = got.isfinite(), want.isfinite()
    both = fg & fw
    mismatch = int((fg != fw).sum())
    if not bool(both.any()):
        return 0.0, 0.0, mismatch
    a, b = got[both].double(), want[both].double()
    abs_err = (a - b).abs()
    return (float((abs_err / b.abs().clamp_min(1e-30)).max()), float(abs_err.max()),
            mismatch)


def compare_abandon(Q, batch, X, thresh, sb, p, base, bd, label):
    """gather_lp_abandon against its plain version: nd must agree (but for
    near-ties of a partial sum with the threshold, at most 1%), and where it
    does the distances agree within RTOL with the same +inf pattern."""
    import torch

    from repro_torch.kernels import lp_distance as kd
    from repro_torch.kernels import ref

    got, nd_got = kd.gather_lp_abandon(Q, batch, X, thresh, sb, p, base, bd)
    want, nd_want = ref.gather_lp_abandon_ref(Q, batch, X, thresh, sb, p, base, bd)
    _sync()
    same_nd = nd_got == nd_want
    nd_agree = float(same_nd.float().mean())
    a_rel, a_abs, a_mis = rel_err(torch.where(same_nd, got, 0.0), torch.where(same_nd, want, 0.0))
    check(nd_agree >= 0.99, f"gather_lp_abandon p={label}: nd agreement {nd_agree}")
    check(a_mis == 0 and a_rel <= RTOL,
          f"gather_lp_abandon p={label}: rel {a_rel} mismatch {a_mis}")
    return nd_got, {"nd_agreement": nd_agree, "max_rel_err": a_rel, "max_abs_err": a_abs,
                    "survivors": int(got.isfinite().sum())}


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    report = {name: [ln.strip() for ln in rep.splitlines()
                     if "Used" in ln or "spill" in ln] if rep != "cached" else "cached"
              for name, (_, rep) in libs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": report})


def phase_data(dev):
    import torch

    from repro_torch.core.datasets import make_dataset

    t0 = _now()
    ds = make_dataset("sun", n=N_SUN, n_queries=N_QUERIES, seed=0)
    t1 = _now()
    X = torch.from_numpy(ds.data).to(dev)
    Q = torch.from_numpy(ds.queries).to(dev)
    t2 = _now()
    emit({"phase": "data", "seconds": t2 - t0, "generate_seconds": t1 - t0,
          "to_device_seconds": t2 - t1, "n": ds.n, "d": ds.d, "n_queries": N_QUERIES,
          "corpus_mib": X.numel() * 4 / 2**20})
    return X, Q


def phase_index(X):
    import torch

    from repro_torch.core.uhnsw import UHNSW

    torch.cuda.reset_peak_memory_stats()
    t0 = _now()
    index = UHNSW.build(X, m=M, seed=0)
    t1 = _now()
    graphs = {}
    for name, g in (("g1", index.g1), ("g2", index.g2)):
        adj0 = g.adjacency[0]
        deg = float((adj0 >= 0).sum(1).float().mean())
        check(g.n == X.shape[0] and adj0.shape == (X.shape[0], 2 * M), f"{name} shape")
        check(deg > M, f"{name} mean level-0 degree {deg}")
        graphs[name] = {"max_level": g.max_level, "mean_l0_degree": deg,
                        "index_mib": g.index_size_bytes() / 2**20}
    emit({"phase": "index", "seconds": t1 - t0, **graphs,
          "peak_device_mib": torch.cuda.max_memory_allocated() / 2**20})
    return index


def phase_kernels(index, Q):
    """Each kernel against its plain version at the path's shapes."""
    import torch

    from repro_torch.core.metrics import base_metric_for
    from repro_torch.kernels import lp_distance as kd
    from repro_torch.kernels import ref
    from repro_torch.kernels.ops import pick_abandon_block_d

    t0 = _now()
    X = index.X
    n, d = X.shape
    kappa = K // 2
    bd = pick_abandon_block_d(d)
    cands = {b: index.search_stage_candidates(Q, b) for b in (1.0, 2.0)}
    p_mix = torch.tensor([P_SCALAR[i % 4] for i in range(Q.shape[0])],
                         dtype=torch.float32, device=X.device)
    cases = [(str(p), p, base_metric_for(p)) for p in P_SCALAR] + [("mixed", p_mix, 1.0)]
    rows = []
    worst = {"gather_lp": 0.0, "gather_lp_abandon": 0.0}
    for label, p, base in cases:
        c = cands[base]
        first = c.ids[:, :K].contiguous()
        got = kd.gather_lp(Q, first, X, p)
        want = ref.gather_lp_ref(Q, first, X, p)
        _sync()
        g_rel, g_abs, g_mis = rel_err(got, want)
        check(g_mis == 0 and g_rel <= RTOL, f"gather_lp p={label}: rel {g_rel} mismatch {g_mis}")
        worst["gather_lp"] = max(worst["gather_lp"], g_abs)
        # thresholds from a real first-k pass, as the verification loop makes them
        thresh = torch.sort(want, dim=1).values[:, K - 1].contiguous()
        batch = c.ids[:, K:K + kappa].contiguous()
        sb = c.base_dists[:, K:K + kappa].contiguous()
        nd_got, a_stats = compare_abandon(Q, batch, X, thresh, sb, p, base, bd, label)
        # the path's batch is mostly abandoned; also compare survivors: the
        # last kappa of the first k (all within the threshold), with every
        # 8th row frozen (-inf) and every 8th unbounded (+inf)
        r8 = torch.arange(Q.shape[0], device=X.device) % 8
        thr2 = torch.where(r8 == 1, -torch.inf, torch.where(r8 == 2, torch.inf, thresh))
        _, s_stats = compare_abandon(Q, c.ids[:, K - kappa:K].contiguous(), X,
                                     thr2.contiguous(), c.base_dists[:, K - kappa:K].contiguous(),
                                     p, base, bd, label + " survivors")
        check(s_stats["survivors"] > 0, f"no survivors to compare at p={label}")
        worst["gather_lp_abandon"] = max(worst["gather_lp_abandon"], a_stats["max_abs_err"],
                                         s_stats["max_abs_err"])

        ope = ops_per_element(p)
        ope_rows = np.broadcast_to(ope, (Q.shape[0],)) if ope.size > 1 else ope[0]
        valid = ((first >= 0) & (first < n)).sum(1).cpu().numpy()
        g_bytes = 4 * (valid.sum() * d + Q.numel() + 2 * first.numel() + Q.shape[0])
        g_bound = bound(g_bytes, float(np.sum(valid * d * ope_rows)))
        scanned = nd_got.sum(1).cpu().numpy()
        live_rows = int((nd_got.sum(1) > 0).sum())
        a_bytes = 4 * (scanned.sum() + live_rows * d + 4 * batch.numel() + 2 * Q.shape[0])
        a_bound = bound(a_bytes, float(np.sum(scanned * (ope_rows + 2))))
        row = {
            "p": label, "base_p": base,
            "gather_lp": {
                "shape": list(first.shape), "max_rel_err": g_rel, "max_abs_err": g_abs,
                "ms": median_ms(lambda: kd.gather_lp(Q, first, X, p)),
                "plain_ms": median_ms(lambda: ref.gather_lp_ref(Q, first, X, p)),
                "bound_ms": g_bound[0], "bound_by": g_bound[1]},
            "gather_lp_abandon": {
                "shape": list(batch.shape), "block_d": bd, **a_stats,
                "survivor_case": s_stats,
                "dim_frac": float(scanned.sum() / (batch.numel() * d)),
                "ms": median_ms(lambda: kd.gather_lp_abandon(Q, batch, X, thresh, sb, p,
                                                             base, bd)),
                "plain_ms": median_ms(lambda: ref.gather_lp_abandon_ref(
                    Q, batch, X, thresh, sb, p, base, bd)),
                "bound_ms": a_bound[0], "bound_by": a_bound[1]},
        }
        rows.append(row)
        emit({"phase": "kernels", "case": row})
    emit({"phase": "kernels", "seconds": _now() - t0})
    return rows, worst


def _search(index, Q, p):
    t0 = _now()
    ids, dists, st = index.search(Q, p, K)
    return ids, dists, st, _now() - t0


def phase_search(index, Q):
    """The main path, counted: every p, then the mixed batch.

    Recall is measured against a brute-force top-10 and reported with what
    bounds it: the share of the true top-10 inside the t candidates (the
    ceiling of verification) and the base graphs' own recall under their
    base metric (navigation). The checks are the port's correctness: the
    kernel path's recall equals the plain path's within MAX_RECALL_GAP, and
    is at least that of the first k candidates in base order (verification
    never drops a true neighbour it has scored).
    """
    import torch

    from repro_torch.core.hnsw import exact_topk
    from repro_torch.core.metrics import base_metric_for
    from repro_torch.core.uhnsw import recall
    from repro_torch.kernels import lp_distance as kd

    t0 = _now()
    truth = {p: exact_topk(index.X, Q, p, K)[0] for p in (*P_SCALAR, 1.0)}
    gt_seconds = _now() - t0
    cands = {b: index.search_stage_candidates(Q, b) for b in (1.0, 2.0)}
    graphs = {}
    for b, c in cands.items():
        hits = (c.ids[:, :K, None] == truth[b][:, None, :]).any(-1).sum(1)
        graphs[f"g{int(b)}"] = {"beam_recall@10": recall(c.ids[:, :K], truth[b]),
                                "stranded_share": float((hits == 0).float().mean())}
    p_mix = np.array([P_SCALAR[i % 4] for i in range(Q.shape[0])], dtype=np.float32)
    _search(index, Q, 0.8)                                    # warm-up, not counted

    kd.reset_launch_counts()
    results = {}
    for p in P_SCALAR:
        before = kd.launch_counts()
        results[p] = _search(index, Q, p)
        results[p] = (*results[p], {k: v - before[k] for k, v in kd.launch_counts().items()})
    before = kd.launch_counts()
    mixed = _search(index, Q, p_mix)
    mixed = (*mixed, {k: v - before[k] for k, v in kd.launch_counts().items()})
    counts = kd.launch_counts()

    with plain_versions():
        plain = {p: index.search(Q, p, K)[0] for p in P_SCALAR}
    per_p = {}
    for p in P_SCALAR:
        ids, dists, st, secs, launched = results[p]
        c = cands[base_metric_for(p)]
        r = recall(ids, truth[p])
        r_plain = recall(plain[p], truth[p])
        r_first = recall(c.ids[:, :K], truth[p])
        per_p[str(p)] = {
            "recall@10": r, "recall@10_plain": r_plain,
            "candidate_ceiling": recall(c.ids, truth[p]), "base_order_recall@10": r_first,
            "ids_equal_plain": float((ids == plain[p]).float().mean()),
            "mean_n_b": float(st.n_b.float().mean()), "mean_n_p": float(st.n_p.float().mean()),
            "mean_hops": float(st.hops.float().mean()),
            "n_dim_frac": float(torch.as_tensor(st.n_dim_frac).float().mean()),
            "iterations": st.iterations, "batch_seconds": secs, "launches": launched}
        check(abs(r - r_plain) <= MAX_RECALL_GAP, f"recall {r} vs plain {r_plain} at p={p}")
        check(r >= r_first, f"recall {r} below the first-k base order's {r_first} at p={p}")
        check(bool(dists.isfinite().all()) and ids.shape == (Q.shape[0], K), f"output at p={p}")
    check(counts["gather_lp"] > 0 and counts["gather_lp_abandon"] > 0,
          f"kernels not launched on the main path: {counts}")
    emit({"phase": "search", "seconds": _now() - t0, "ground_truth_seconds": gt_seconds,
          "graphs": graphs, "per_p": per_p, "launches": counts})
    return results, mixed, p_mix, counts


def phase_mixed(results, mixed, p_mix):
    t0 = time.perf_counter()
    ids_m, d_m, st_m, secs, launched = mixed
    rows_equal = 0
    for p in P_SCALAR:
        sel = np.flatnonzero(p_mix == np.float32(p))
        ids, dists, st = results[p][:3]
        same = (bool((ids_m[sel] == ids[sel]).all()) and bool((d_m[sel] == dists[sel]).all())
                and bool((st_m.n_p[sel] == st.n_p[sel]).all())
                and bool((st_m.n_b[sel] == st.n_b[sel]).all()))
        check(same, f"mixed-p rows at p={p} differ from the scalar call")
        rows_equal += len(sel)
    emit({"phase": "mixed", "seconds": time.perf_counter() - t0, "batch_seconds": secs,
          "rows_equal_to_scalar": rows_equal, "launches": launched,
          "mean_n_p": float(st_m.n_p.float().mean())})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device, nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch  # noqa: F401  (fails outside the repository)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    phase_build()
    X, Q = phase_data(dev)
    index = phase_index(X)
    del X
    kernel_rows, worst = phase_kernels(index, Q)
    results, mixed, p_mix, counts = phase_search(index, Q)
    phase_mixed(results, mixed, p_mix)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    mix_row = kernel_rows[-1]
    kernels = []
    for name, replaces, src in (
            ("gather_lp", "src/repro/kernels/lp_distance.py:384",
             "src/repro_torch/kernels/csrc/gather_lp.cu"),
            ("gather_lp_abandon", "src/repro/kernels/lp_distance.py:560",
             "src/repro_torch/kernels/csrc/gather_lp_abandon.cu")):
        r = mix_row[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": counts[name], "max_abs_err": worst[name],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
