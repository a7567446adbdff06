#!/usr/bin/env python3
"""Drives the port's paths once on one CUDA card, at full size.

    python3 chip_smoke.py

The corpus: the synthetic Sun corpus at its published size (78,306 x 512,
256 queries, seed 0); the LM: tinyllama_1_1b at its full width and depth
(random weights from a seed, and the weights it trains); and the other
block kinds' four configs at their full widths. Fifteen paths,
each driven with the kernels' launch counts set to 0 just before it and
read just after:

  1. the query path (phase `search`): UHNSW.build(method="bulk_host", m = 16,
     dense steps on the card) -> UHNSW.search with the default parameters
     (t = 300, tau = 0.92, kappa = k // 2, ef = 2t, early-abandoning
     verification) at k = 10 and p in {0.5, 1.25} (one p verified on each
     base graph), then a mixed-p batch cycling through {0.5, 0.8, 1.25, 2.0}
     (gather_lp, gather_lp_abandon);
  2. the shared-pass bulk build (phase `index_bulk`): UHNSW.build(
     method="bulk", m = 16), both graphs from one NN-Descent pass on the card
     (pairwise_lp, gather_lp, and gather_lp_multi, which scores each block of
     the shared pass under both metrics in one launch), then the searches
     on its graphs at p in {0.5, 0.8, 1.25, 2.0} and the mixed batch (phase
     `search_bulk`);
  3. the compressed band (phase `band`): the bulk index searched with
     compressed_band=True (gather_lp_screen, gather_lp), then with
     energy_perm=True, at every p and the mixed batch;
  4. the rowwise and fused top-k entry points (phase `kernels_rest`):
     kernels.ops.lp_rowwise_distance at every p family (0.5, 0.8, 1, 1.25,
     1.5, 2 and mixed) and kernels.lp_topk.lp_topk on the shared-pass
     index's 300 candidates a query (rowwise_lp, lp_topk), with tie cases,
     NaN and +inf rows, and a block of 257 candidates;
  5. the sharded index (phase `sharded`): ShardedUHNSW.build(4 segments,
     m = 16, method="bulk"), searched under the independent, two_phase and
     round_robin policies at p in {0.5, 1.25, 2.0} and the mixed batch
     (gather_lp, gather_lp_abandon), then under the independent policy
     with compressed_band=True at p = 1.25 and the mixed batch
     (gather_lp_screen), which must return the independent ids;
  6. the delta tier (phase `delta`): 512 fresh rows added to the sharded
     index, each searched for with abandon on and off (gather_lp_abandon,
     pairwise_lp on the delta scan), then compacted into a fifth segment;
  7. durability (phase `durable`): the sharded index wrapped in a
     DurableIndex, 1,536 fresh rows through add() (one compaction and
     snapshot rotation: pairwise_lp, gather_lp), searches, recover() into a
     fresh index that must be bitwise equal (searches at p = 1.25 and the
     mixed batch), a recovery from a log whose newest record was cut
     short, and a poisoned segment restored from the snapshot;
  8. serving (phase `serve`): 1,024 mixed-p requests through
     UniversalVectorService.serve (the engine) over the recovered index
     (gather_lp, gather_lp_abandon, and pairwise_lp on the delta scan),
     equal to serve_grouped; again under injected faults, and again with
     per-segment faults and a poisoned segment that is quarantined,
     restored and re-admitted;
  9. the command line (phase `serve_cli`): `repro_torch.launch.serve`
     with --retrieval --n 100000 --state-dir, twice (build, then recover),
     each serving every request with no fault caught; a sample of the
     first run's kernel calls (d = 256) is held against the plain
     versions;
 10. the LM serving path (phase `lm`): tinyllama_1_1b (22 layers, d 2048,
     32 heads / 4 KV, vocab 32,000) from models.init_params, prefill and
     decode against the full forward in f32 and bf16, the f32 forward on
     the card against the CPU, ServeEngine.generate (bf16, batch 8, prompt
     128, 128 greedy steps, twice), and `repro_torch.launch.serve --arch
     tinyllama_1_1b` as a subprocess (plain torch: no kernel of the repo);
 11. kNN-LM (phase `knn_lm`): a U-HNSW datastore of 65,536 of the trained
     model's hidden states (d = 2048) and their next tokens (KnnLM, host bulk
     builder), memorized continuations and held-out NLL at several p
     (gather_lp, gather_lp_abandon at d = 2048, a sample of their calls held
     against the plain versions, and both timed at that width);
 12. the MLSH baseline (phase `mlsh`): MLSH on the Sun corpus on the card,
     recall, N_p and rounds beside U-HNSW's N_p, and 16 queries against the
     same code on the CPU (plain torch);
 13. training (phase `train`): tinyllama_1_1b at full width, bf16
     parameters and f32 AdamW moments from init_train_state, 8 x 512
     tokens a step from make_batch_iterator (from pipeline step 2) through
     make_train_step, held to the reference's loss rule; one step with
     microbatches=2 against one with 1, one compressed step (error
     feedback exact), loss_fn's gradients on the card against the CPU (the
     first 2 layers), the flash backward alone against plain autograd at
     the model's attention shape, and a checkpoint round trip of the
     embedding's, head's, final norm's and first 2 layers' state (plain
     torch: no kernel of the repo); the trained weights then feed
     `knn_store` and `knn_lm`;
 14. the training command line (phase `train_cli`):
     `repro_torch.launch.train --smoke` uninterrupted, crashed at step 7
     (exit 42) and resumed from its checkpoint, the resumed losses against
     the uninterrupted ones, and `repro_torch.launch.supervisor` restarting
     a command that fails once;
 15. the other block kinds (phase `lm_kinds`, one line per config), each
     at its published width in f32: deepseek_v3_671b (MLA with the
     absorbed decode, 256-expert top-8 MoE; its first 4 layers),
     llama4_scout_17b_a16e (top-1 MoE with a shared expert; 2 of 48
     layers), recurrentgemma_2b (RG-LRU and the local-attention ring, all
     26 layers, a prefill longer than the 2,048 window) and mamba2_1_3b
     (SSD, all 48 layers): prefill + decode against the full forward at
     MoE capacity factor E / top_k (no route can drop), one prefill at the
     published capacity whose dropped routes must equal a recount by rank,
     loss_fn's gradients on the card against the CPU for the recurrent two,
     and each served in bf16 at B 8 (decode ms a step); plain torch;
 16. the mesh (phase `mesh`), on a one-rank NCCL group and its (1, 1)
     mesh (`launch.mesh.make_local_mesh`), where every collective is a real
     launch of size 1 and any difference from the mesh-free path is a bug
     of the mesh code: in the `--lm-kinds` process, deepseek's and llama4's
     expert-parallel MoE body (`moe_forward` on the mesh) and the
     weights-stationary decode (`_moe_decode_gather`, B 8) against the
     mesh-free calls on their published-width layers, then
     tinyllama_1_1b at full width: its state placed by
     `distribute_params`, 3 f32 train steps of 8 x 512 tokens (microbatches
     2, int8 compression) against the mesh-free steps, the explicit-TP FFN
     against `ffn_forward`, ServeEngine's tokens against the mesh-free
     engine's and a checkpoint round trip mesh -> no mesh -> mesh; in the
     `--sharded-paths` process, the 4-segment index placed by `shard_over`
     and searched at p = 0.5 and the mixed batch (gather_lp,
     gather_lp_abandon), equal to the unplaced search, then served through
     the engine (`UniversalVectorService.serve`: rank 0's orders over the
     group) with 128 mixed-p requests, equal to `serve_grouped`;
 17. the dry-run (phase `dryrun`, in the `--lm-paths` process): the train
     phase's step traced with `launch.dryrun.trace` (meta tensors, no
     mesh), its predicted peak held to one real step's on the card within
     10%, its flops and roofline terms printed beside the step's time;
     and `python -m repro_torch.launch.dryrun` on tinyllama_1_1b x
     train_4k (--optimized) and qwen2_5_32b x decode_32k over a fake
     256-rank group, started with the process and read at its end, each
     status ok.

Paths 5–8 run in a second process, `chip_smoke.py --sharded-paths`, on
the same corpus, queries and truth made again, and paths 9, 10, 11, 13
and 14 (with the kNN-LM's datastore, phase `knn_store`) and 17 in a third,
`chip_smoke.py --lm-paths`; both start once the kernels are built and
timed (after `kernels_rest`), beside paths 1–4 and 12, and are read at
the end: their seconds and rates share the card and the host with the
phases beside them. Path 15 runs in a fourth process, `chip_smoke.py
--lm-kinds`, started first (it needs no kernel) beside the build; the
LM paths start only once it has exited, so their models never share the
card. Path 16's two parts print `mesh_lm` and `mesh_index` in those
processes; the first process joins them into the `mesh` line.

It builds the CUDA kernels with nvcc (on a second thread, while the
data, the brute-force truth and the host builder's graphs are made),
holds each kernel against its plain PyTorch version on the card at the
paths' shapes and at shapes the paths' defaults do not reach (pairwise_lp at ragged shapes, with its level
calls exactly symmetric; gather_lp_multi on the build's own round-2 block
and on random ids, with gather_lp's bits, and at d = 37, general p and
small slabs; gather_lp_abandon at block_d 8 and 16, C = 1 and 37, on
strided id slices; gather_lp_screen at block_d 8 and 16, C = 1 and 37,
on strided id and base-sum slices, at d = 37, with frozen and +inf
rows, padding ids and NaN query coordinates; lp_topk at k = 65 and k =
C, with NaN and +inf rows, and at d = 37 and 1,100; gather_lp_abandon,
gather_lp_screen and pairwise_lp on NaN rows and NaN base sums, phase
`nan_cases`), times each kernel
around its wrapper (`ms`) and on the device alone (`device_ms`, calls
captured in a CUDA graph), measures recall
against a brute-force top-k and checks it against the same search with the
plain versions, checks that every row of a mixed batch equals the scalar
call at its p, that the band and energy-ordered paths return the default
path's ids, that the sharded candidates are exact and that two_phase at
thresh_rank = t gives the independent ids wherever their candidates agree,
and that every inserted row is its own top-1 in the delta tier and, after
compaction, wherever the graphs found it. One JSON object per phase, with its seconds, goes to
stdout; then the card's name and power limit, the kernel summary, and last
{"ok": true, "device": {...}}. Any failed check raises (exit code != 0).
Without a CUDA device it exits with code 2 before doing anything.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from dataclasses import replace
from pathlib import Path

import numpy as np

P_SCALAR = (0.5, 0.8, 1.25, 2.0)
HOST_P = (0.5, 1.25)     # the host builder's graphs: one p verified on each base graph
N_SUN = 78_306           # src/repro/core/datasets.py PAPER_DATASETS["sun"]
N_QUERIES = 256
K = 10
M = 16
RTOL = 1e-5              # f32 sums taken in another order than the plain version
ATOL = 1e-6              # the tests' absolute floor beside RTOL (band / energy_perm dists)
PLAIN_ROWS = 256         # rows of a level the plain pairwise version scores at a time
SHARED_IDS = 1024        # rows of the shared-ids (1-D) pairwise form
MAX_RECALL_GAP = 0.002
TIMING_REPS = 50
PLAIN_REPS = 10          # the plain versions' times: a reference figure, not a kernel's
GRAPH_CALLS = 20         # calls captured in one CUDA graph for a device-only time
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
# H100 SXM float32 outside the tensor cores, NVIDIA data sheet. The figure
# counts an FMA as 2 FLOPs; instructions that are not FMAs issue at half of
# it (about 33.5 T/s), so for the counts below the bound is one the card
# cannot reach.
F32_OPS_PER_S = 67e12
# Operations per element of each p family: sub, abs, (pow sequence), add.
OPS_PER_ELEMENT = {1.0: 3, 2.0: 3, 0.5: 4, 1.5: 5}
OPS_GENERAL = 6
OPS_IDENTITY = 2         # a p = 2 row of the pairwise kernel: one FMA per element
# The screen's extra operations per scanned band element: convert, scale, sub,
# abs, minus and plus the radius, max, and the base-metric upper term.
OPS_SCREEN_EXTRA = 8


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


def device_ms(fn, calls: int = GRAPH_CALLS, reps: int = 5) -> float:
    """Device-only time of one call: `calls` back-to-back calls captured in
    one CUDA graph (torch.cuda.graphs), its replay timed with CUDA events
    (median of `reps` replays) and divided by `calls`. The wrapper's host
    work (Python, checks, the launch itself) is not in it, so `ms` less
    `device_ms` is what the host adds to a call made alone."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    _sync()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / calls)
    del graph
    return float(np.median(times))


def kernel_ms(fn, reps: int = TIMING_REPS, calls: int = GRAPH_CALLS) -> dict:
    """{"ms": median per-call time around the wrapper, "device_ms": the
    same calls' device-only time}."""
    return {"ms": median_ms(fn, reps=reps), "device_ms": device_ms(fn, calls=calls)}


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
    """Routes the paths' five kernel wrappers to their plain versions for
    the comparison runs; the kernels' own code is not touched."""
    import torch

    from repro_torch.kernels import lp_distance, ref

    def uncounted(fn):
        def call(*args):
            return fn(*args)
        call.launches = 0          # a plain version launches no kernel
        return call

    def multi_ref(q, ids, x, ps):
        return torch.stack([ref.gather_lp_ref(q, ids, x, p) for p in ps])

    plain = {"pairwise_lp": uncounted(ref.pairwise_lp_ref),
             "gather_lp": uncounted(ref.gather_lp_ref),
             "gather_lp_multi": uncounted(multi_ref),
             "gather_lp_abandon": uncounted(ref.gather_lp_abandon_ref),
             "gather_lp_screen": uncounted(ref.gather_lp_screen_ref)}
    saved = {name: getattr(lp_distance, name) for name in plain}
    for name, fn in plain.items():
        setattr(lp_distance, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(lp_distance, name, fn)


@contextmanager
def build_gather_shapes():
    """Records what the bulk build's gather calls score: the (B, C) shape
    of every per-row single-p call it makes through `lp_gather_distance`
    (the level passes), the (B, C, ps) of every multi-p call of its shared
    scoring pass, and, of the shared pass's third block (the second
    NN-Descent round's), its node rows and candidate ids, the build's real
    traffic. Launches are counted as usual."""
    from repro_torch.core import bulk_build

    rec = {"shapes": [], "multi": [], "round2": None}
    single, multi = bulk_build.lp_gather_distance, bulk_build._score_ids_multi

    def record(q, ids, x, p, *args, **kwargs):
        if ids.ndim == 2:
            rec["shapes"].append(tuple(ids.shape))
        return fn_single(q, ids, x, p, *args, **kwargs)

    def record_multi(x, node_rows, ids, ps):
        if len(rec["multi"]) == 2:
            rec["round2"] = (node_rows.clone(), ids.clone())
        rec["multi"].append((*ids.shape, tuple(ps)))
        return multi(x, node_rows, ids, ps)

    fn_single = single
    bulk_build.lp_gather_distance = record
    bulk_build._score_ids_multi = record_multi
    try:
        yield rec
    finally:
        bulk_build.lp_gather_distance = single
        bulk_build._score_ids_multi = multi


def counted(fn, *args, **kwargs):
    """Runs one path with every launch count set to 0 just before it and
    read just after: (its result, {kernel: launches})."""
    from repro_torch.kernels import lp_distance as kd

    _sync()
    kd.reset_launch_counts()
    out = fn(*args, **kwargs)
    _sync()
    return out, kd.launch_counts()


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


def phase_build(libs, t0: float):
    """Waits for the kernels' build (`_build.build_all`, started at t0 on
    another thread while the data, the truth and the host builder's
    graphs, which launch no kernel, are made) and reports it."""
    libs = libs.result()
    report = {name: [ln.strip() for ln in rep.splitlines()
                     if "Used" in ln or "spill" in ln] if rep != "cached" else "cached"
              for name, (_, rep) in libs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": report})


def corpus(dev):
    """The Sun corpus and its queries on the card, and when each was ready:
    (X, Q, generated, on the card)."""
    import torch

    from repro_torch.core.datasets import make_dataset

    ds = make_dataset("sun", n=N_SUN, n_queries=N_QUERIES, seed=0)
    t1 = _now()
    X = torch.from_numpy(ds.data).to(dev)
    Q = torch.from_numpy(ds.queries).to(dev)
    return X, Q, t1, _now()


def exact_truth(X, Q) -> dict:
    """Brute-force top-10 at every p of the paths (and p = 1 for G1's beam)."""
    from repro_torch.core.hnsw import exact_topk

    return {p: exact_topk(X, Q, p, K)[0] for p in (*P_SCALAR, 1.0)}


def phase_data(dev):
    t0 = _now()
    X, Q, t1, t2 = corpus(dev)
    emit({"phase": "data", "seconds": t2 - t0, "generate_seconds": t1 - t0,
          "to_device_seconds": t2 - t1, "n": X.shape[0], "d": X.shape[1],
          "n_queries": N_QUERIES, "corpus_mib": X.numel() * 4 / 2**20})
    return X, Q


def phase_truth(X, Q):
    t0 = _now()
    truth = exact_truth(X, Q)
    emit({"phase": "truth", "seconds": _now() - t0})
    return truth


def graph_stats(index, Q, truth) -> dict:
    """Each base graph's mean level-0 degree and its own beam under its base
    metric: recall@10, and the share of queries whose beam finds none of
    the true top-10 (stranded)."""
    from repro_torch.core.hnsw import GraphArrays
    from repro_torch.core.uhnsw import recall

    out = {}
    for name, g, b in (("g1", index.g1, 1.0), ("g2", index.g2, 2.0)):
        adj0 = GraphArrays.from_graph(g).adj0
        deg = float((adj0 < g.n).sum(1).float().mean())
        check(g.n == index.X.shape[0] and adj0.shape == (g.n, 2 * M), f"{name} shape")
        check(deg > M, f"{name} mean level-0 degree {deg}")
        c = index.search_stage_candidates(Q, b, K)
        hits = (c.ids[:, :K, None] == truth[b][:, None, :]).any(-1).sum(1)
        out[name] = {"max_level": g.max_level, "mean_l0_degree": deg,
                     "index_mib": g.index_size_bytes() / 2**20,
                     "beam_recall@10": recall(c.ids[:, :K], truth[b]),
                     "stranded_share": float((hits == 0).float().mean())}
    return out


def phase_index(X, Q, truth, built):
    """The host bulk builder (slice 1's path); `built()` returns once the
    kernels are built, before the first search."""
    import torch

    from repro_torch.core.uhnsw import UHNSW

    torch.cuda.reset_peak_memory_stats()
    t0 = _now()
    index = UHNSW.build(X, m=M, seed=0, method="bulk_host")
    seconds = _now() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    built()
    stats = graph_stats(index, Q, truth)
    emit({"phase": "index", "method": "bulk_host", "seconds": seconds, **stats,
          "peak_device_mib": peak})
    return index, {"seconds": seconds, "peak_device_mib": peak, "graphs": stats}


def phase_index_bulk(X, Q, truth, host):
    """The shared-pass bulk build, counted, beside the host builder's figures."""
    import torch

    from repro_torch.core.uhnsw import UHNSW

    torch.cuda.reset_peak_memory_stats()
    t0 = _now()
    with build_gather_shapes() as rec:
        index, launched = counted(UHNSW.build, X, m=M, seed=0, method="bulk")
    seconds = _now() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    check(launched["pairwise_lp"] > 0 and launched["gather_lp"] > 0,
          f"bulk build did not launch its kernels: {launched}")
    # the shared pass: the seed block and each NN-Descent round scored under
    # both metrics in multi-p launches (one each at this size on the card)
    check(launched["gather_lp_multi"] >= len(rec["multi"]) > 0 and rec["round2"] is not None
          and all(ps == (1.0, 2.0) for *_, ps in rec["multi"]),
          f"bulk build's shared pass: {launched['gather_lp_multi']} multi-p launches for "
          f"{rec['multi']}")
    stats = graph_stats(index, Q, truth)
    emit({"phase": "index_bulk", "method": "bulk", "seconds": seconds, **stats,
          "peak_device_mib": peak, "launches": launched, "gather_shapes": rec["shapes"],
          "gather_multi_calls": [[b, c, list(ps)] for b, c, ps in rec["multi"]],
          "host_builder": {"seconds": host["seconds"],
                           "peak_device_mib": host["peak_device_mib"],
                           **host["graphs"]}})
    return index, launched, rec


def path_kernel_row(Q, X, c, p, base: float, bd: int, label: str, k: int = K):
    """The query path's two kernels on one batch of candidates `c`, each
    against its plain version, timed, with its bound: gather_lp on the first
    k candidates, gather_lp_abandon on the next kappa = k // 2 at the
    thresholds of that first-k pass (as the verification loop makes them),
    and again on the last kappa of the first k (all within the threshold),
    with every 8th row frozen (-inf) and every 8th unbounded (+inf), so
    that survivors are compared too. -> (row, the thresholds)."""
    import torch

    from repro_torch.kernels import lp_distance as kd
    from repro_torch.kernels import ref

    n, d = X.shape
    kappa = k // 2
    first = c.ids[:, :k].contiguous()
    got = kd.gather_lp(Q, first, X, p)
    want = ref.gather_lp_ref(Q, first, X, p)
    _sync()
    g_rel, g_abs, g_mis = rel_err(got, want)
    check(g_mis == 0 and g_rel <= RTOL, f"gather_lp p={label}: rel {g_rel} mismatch {g_mis}")
    thresh = torch.sort(want, dim=1).values[:, k - 1].contiguous()
    batch = c.ids[:, k:k + kappa].contiguous()
    sb = c.base_dists[:, k:k + kappa].contiguous()
    nd_got, a_stats = compare_abandon(Q, batch, X, thresh, sb, p, base, bd, label)
    r8 = torch.arange(Q.shape[0], device=X.device) % 8
    thr2 = torch.where(r8 == 1, -torch.inf, torch.where(r8 == 2, torch.inf, thresh))
    _, s_stats = compare_abandon(Q, c.ids[:, k - kappa:k].contiguous(), X, thr2.contiguous(),
                                 c.base_dists[:, k - kappa:k].contiguous(), p, base, bd,
                                 label + " survivors")
    check(s_stats["survivors"] > 0, f"no survivors to compare at p={label}")

    ope = ops_per_element(p)
    ope_rows = np.broadcast_to(ope, (Q.shape[0],)) if ope.size > 1 else ope[0]
    valid = ((first >= 0) & (first < n)).sum(1).cpu().numpy()
    g_bytes = 4 * (valid.sum() * d + Q.numel() + 2 * first.numel() + Q.shape[0])
    g_bound = bound(g_bytes, float(np.sum(valid * d * ope_rows)))
    scanned = nd_got.sum(1).cpu().numpy()
    live_rows = int((nd_got.sum(1) > 0).sum())
    # the kernel loads one block ahead: a candidate that died mid-row
    # (0 < nd < d) also read the block after the one it died in
    ahead = int(((nd_got > 0) & (nd_got < d)).sum())
    a_bytes = 4 * (scanned.sum() + ahead * bd + live_rows * d + 4 * batch.numel()
                   + 2 * Q.shape[0])
    a_bound = bound(a_bytes, float(np.sum(scanned * (ope_rows + 2))))
    row = {
        "p": label, "base_p": base, "d": d,
        "gather_lp": {
            "shape": list(first.shape), "max_rel_err": g_rel, "max_abs_err": g_abs,
            **kernel_ms(lambda: kd.gather_lp(Q, first, X, p)),
            "plain_ms": median_ms(lambda: ref.gather_lp_ref(Q, first, X, p), reps=PLAIN_REPS,
                                  warmup=2),
            "bound_ms": g_bound[0], "bound_by": g_bound[1]},
        "gather_lp_abandon": {
            "shape": list(batch.shape), "block_d": bd, **a_stats,
            "survivor_case": s_stats,
            "dim_frac": float(scanned.sum() / (batch.numel() * d)),
            **kernel_ms(lambda: kd.gather_lp_abandon(Q, batch, X, thresh, sb, p, base, bd)),
            "plain_ms": median_ms(lambda: ref.gather_lp_abandon_ref(
                Q, batch, X, thresh, sb, p, base, bd), reps=PLAIN_REPS, warmup=2),
            "bound_ms": a_bound[0], "bound_by": a_bound[1]},
    }
    return row, thresh


def phase_kernels(index, Q):
    """Each kernel against its plain version at the path's shapes."""
    import torch

    from repro_torch.core.metrics import base_metric_for
    from repro_torch.kernels.ops import pick_abandon_block_d

    t0 = _now()
    X = index.X
    bd = pick_abandon_block_d(X.shape[1])
    cands = {b: index.search_stage_candidates(Q, b, K) for b in (1.0, 2.0)}
    p_mix = torch.tensor([P_SCALAR[i % 4] for i in range(Q.shape[0])],
                         dtype=torch.float32, device=X.device)
    cases = [(str(p), p, base_metric_for(p)) for p in P_SCALAR] + [("mixed", p_mix, 1.0)]
    rows = []
    worst = {"gather_lp": 0.0, "gather_lp_abandon": 0.0}
    for label, p, base in cases:
        row, thresh = path_kernel_row(Q, X, cands[base], p, base, bd, label)
        worst["gather_lp"] = max(worst["gather_lp"], row["gather_lp"]["max_abs_err"])
        worst["gather_lp_abandon"] = max(worst["gather_lp_abandon"],
                                         row["gather_lp_abandon"]["max_abs_err"],
                                         row["gather_lp_abandon"]["survivor_case"]["max_abs_err"])
        rows.append(row)
        emit({"phase": "kernels", "case": row})
    extra = abandon_cases(Q, X, cands, p_mix, thresh)
    worst["gather_lp_abandon"] = max(worst["gather_lp_abandon"],
                                     max(r["max_abs_err"] for r in extra.values()))
    emit({"phase": "kernels", "gather_lp_abandon_cases": extra})
    emit({"phase": "kernels", "seconds": _now() - t0})
    return rows, worst


def abandon_cases(Q, X, cands, p_mix, thresh) -> dict:
    """gather_lp_abandon at the shapes the path's defaults do not reach,
    each against its plain version under compare_abandon's rule: block_d 8
    and 16, C = 1 and C = 37, ids and sb passed as the verification loop
    passes them (column slices of the candidate lists, read through their
    row strides, not copied), and rows frozen (-inf) or unbounded (+inf)
    beside rows at the path's thresholds. Mixed p over G1's candidates,
    and scalar p = 0.8."""
    import torch

    c = cands[1.0]
    r8 = torch.arange(Q.shape[0], device=X.device) % 8
    thr2 = torch.where(r8 == 1, -torch.inf, torch.where(r8 == 2, torch.inf, thresh)).contiguous()
    kappa = K // 2
    out = {}
    for p, plabel in ((p_mix, "mixed"), (0.8, "0.8")):
        for bd in (8, 16):
            sl = slice(K, K + kappa)
            _, out[f"block_d={bd} p={plabel}"] = compare_abandon(
                Q, c.ids[:, sl], X, thr2, c.base_dists[:, sl], p, 1.0, bd,
                f"{plabel} block_d={bd}")
        for width in (1, 37):
            sl = slice(K - 1, K - 1 + width)      # the k-th candidate first: survivors too
            ids, sb = c.ids[:, sl], c.base_dists[:, sl]
            check(not ids.is_contiguous() and not sb.is_contiguous(), "strided slices")
            _, out[f"C={width} p={plabel}"] = compare_abandon(
                Q, ids, X, thr2, sb, p, 1.0, 32, f"{plabel} C={width}")
    check(all(r["survivors"] > 0 for r in out.values()), "abandon cases: a case with no survivor")
    return out


def _search(index, Q, p):
    t0 = _now()
    ids, dists, st = index.search(Q, p, K)
    return ids, dists, st, _now() - t0


def mixed_p(b: int) -> np.ndarray:
    return np.array([P_SCALAR[i % 4] for i in range(b)], dtype=np.float32)


def run_searches(index, Q, ps=P_SCALAR) -> dict:
    """Every scalar p of `ps`, then the mixed batch: {p or "mixed": (ids,
    dists, stats, seconds, launches of that batch)}."""
    from repro_torch.kernels import lp_distance as kd

    results = {}
    for p in (*ps, "mixed"):
        before = kd.launch_counts()
        out = _search(index, Q, mixed_p(Q.shape[0]) if p == "mixed" else p)
        results[p] = (*out, {k: v - before[k] for k, v in kd.launch_counts().items()})
    return results


def mixed_truth(truth, b: int):
    import torch

    return torch.stack([truth[P_SCALAR[i % 4]][i] for i in range(b)])


def phase_search(index, Q, truth, label: str, ps=P_SCALAR):
    """A query path, counted: every p of `ps`, then the mixed batch.

    Recall is measured against a brute-force top-10 and reported with what
    bounds it: the share of the true top-10 inside the t candidates (the
    ceiling of verification) and the base graphs' own recall under their
    base metric (navigation, in the index phases). The checks are the
    port's correctness: the kernel path's recall equals the plain path's
    within MAX_RECALL_GAP, and at a scalar p is at least that of the first
    k candidates in base order (verification never drops a true neighbour
    it has scored).
    """
    import torch

    from repro_torch.core.metrics import base_metric_for
    from repro_torch.core.uhnsw import recall

    t0 = _now()
    cands = {b: index.search_stage_candidates(Q, b, K) for b in (1.0, 2.0)}
    _search(index, Q, 0.8)                                    # warm-up, not counted
    results, counts = counted(run_searches, index, Q, ps)
    with plain_versions():
        plain = run_searches(index, Q, ps)
    per_p = {}
    for p in (*ps, "mixed"):
        ids, dists, st, secs, launched = results[p]
        tr = mixed_truth(truth, Q.shape[0]) if p == "mixed" else truth[p]
        r = recall(ids, tr)
        r_plain = recall(plain[p][0], tr)
        row = {"recall@10": r, "recall@10_plain": r_plain,
               "ids_equal_plain": float((ids == plain[p][0]).float().mean()),
               "mean_n_b": float(st.n_b.float().mean()), "mean_n_p": float(st.n_p.float().mean()),
               "mean_hops": float(st.hops.float().mean()),
               "n_dim_frac": float(torch.as_tensor(st.n_dim_frac).float().mean()),
               "iterations": st.iterations, "batch_seconds": secs, "launches": launched}
        if p != "mixed":
            c = cands[base_metric_for(p)]
            r_first = recall(c.ids[:, :K], tr)
            row.update({"candidate_ceiling": recall(c.ids, tr), "base_order_recall@10": r_first})
            check(r >= r_first, f"{label}: recall {r} below the first-k base order's {r_first} "
                                f"at p={p}")
        per_p[str(p)] = row
        check(abs(r - r_plain) <= MAX_RECALL_GAP, f"{label}: recall {r} vs plain {r_plain} at p={p}")
        check(bool(dists.isfinite().all()) and ids.shape == (Q.shape[0], K),
              f"{label}: output at p={p}")
    check(counts["gather_lp"] > 0 and counts["gather_lp_abandon"] > 0,
          f"{label}: kernels not launched on the query path: {counts}")
    emit({"phase": label, "seconds": _now() - t0, "per_p": per_p, "launches": counts})
    return results, counts


def phase_mixed(results, label: str):
    """Every row of the mixed batch whose p was also searched alone equals
    that scalar call's row (ids, dists, N_p, N_b)."""
    t0 = time.perf_counter()
    ids_m, d_m, st_m, secs, launched = results["mixed"]
    p_mix = mixed_p(ids_m.shape[0])
    rows_equal = 0
    for p in (p for p in P_SCALAR if p in results):
        sel = np.flatnonzero(p_mix == np.float32(p))
        ids, dists, st = results[p][:3]
        same = (bool((ids_m[sel] == ids[sel]).all()) and bool((d_m[sel] == dists[sel]).all())
                and bool((st_m.n_p[sel] == st.n_p[sel]).all())
                and bool((st_m.n_b[sel] == st.n_b[sel]).all()))
        check(same, f"{label}: mixed-p rows at p={p} differ from the scalar call")
        rows_equal += len(sel)
    emit({"phase": label, "seconds": time.perf_counter() - t0, "batch_seconds": secs,
          "rows_equal_to_scalar": rows_equal, "launches": launched,
          "mean_n_p": float(st_m.n_p.float().mean())})


def pairwise_errors(got, want, q, x, p):
    """(max relative error on rows off p = 2, max absolute error, max of
    |error| / (|q|^2 + |x|^2) on p = 2 rows, entries finite in only one)."""
    import torch

    pv = torch.as_tensor(p, dtype=torch.float32, device=q.device).reshape(-1, 1)
    l2 = (pv == 2.0).expand_as(want)
    err = (got.double() - want.double()).abs()
    norms = (q.double() ** 2).sum(1)[:, None] + (x.double() ** 2).sum(1)[None, :]
    rel = err / want.double().abs().clamp_min(1e-30)
    mismatch = int((got.isfinite() != want.isfinite()).sum())
    off = rel[~l2]
    on = (err / norms)[l2]
    return (float(off.max()) if off.numel() else 0.0, float(err.max()),
            float(on.max()) if on.numel() else 0.0, mismatch)


def pairwise_bound(b: int, n: int, d: int, p, inputs: int) -> tuple[float, str]:
    """Bound of a (b, n) pairwise call over d: `inputs` * d floats per
    output row and column read once, the output written once."""
    import torch

    ope = np.array([OPS_IDENTITY if v == 2.0 else OPS_PER_ELEMENT.get(v, OPS_GENERAL)
                    for v in np.broadcast_to(torch.as_tensor(p).cpu().numpy(), (b,))])
    return bound(4 * (inputs * d + b * n + b), float(ope.sum()) * n * d)


def check_pairwise(label: str, errors) -> dict:
    rel, abs_err, l2_rel, mismatch = errors
    check(mismatch == 0 and rel <= RTOL and l2_rel <= RTOL,
          f"pairwise_lp {label}: rel {rel}, p=2 norm-scaled {l2_rel}, mismatch {mismatch}")
    return {"max_rel_err": rel, "max_abs_err": abs_err, "p2_err_over_norms": l2_rel}


def pairwise_case(q, x, p, label: str):
    """The shared-ids form: one call against its plain version."""
    from repro_torch.kernels import lp_distance as kd
    from repro_torch.kernels import ref

    got = kd.pairwise_lp(q, x, p)
    want = ref.pairwise_lp_ref(q, x, p)
    _sync()
    errs = check_pairwise(label, pairwise_errors(got, want, q, x, p))
    (b, d), n = q.shape, x.shape[0]
    bnd = pairwise_bound(b, n, d, p, b + n)
    return {"case": label, "shape": [b, n, d], **errs,
            **kernel_ms(lambda: kd.pairwise_lp(q, x, p)),
            "plain_ms": median_ms(lambda: ref.pairwise_lp_ref(q, x, p), reps=10),
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}


def pairwise_level(sub, p: float, label: str, timed: bool):
    """The call the shared-pass build makes for one upper level: all of
    the level's nodes against all of them in one launch, compared with the
    plain version PLAIN_ROWS rows at a time (it builds a (rows, n, d)
    block), the last, partial block of rows included."""
    import torch

    from repro_torch.kernels import lp_distance as kd
    from repro_torch.kernels import ref

    nl, d = sub.shape
    got = kd.pairwise_lp(sub, sub, p)
    _sync()
    check(bool((got == got.T).all()), f"pairwise_lp {label}: not exactly symmetric")
    blocks = [pairwise_errors(got[s:s + PLAIN_ROWS], ref.pairwise_lp_ref(sub[s:s + PLAIN_ROWS],
                                                                           sub, p),
                              sub[s:s + PLAIN_ROWS], sub, p)
              for s in range(0, nl, PLAIN_ROWS)]
    errs = check_pairwise(label, (max(e[0] for e in blocks), max(e[1] for e in blocks),
                                  max(e[2] for e in blocks), sum(e[3] for e in blocks)))
    row = {"case": label, "shape": [nl, nl, d], "plain_blocks": len(blocks), **errs,
           "symmetric": True}
    if timed:
        def plain():
            return [ref.pairwise_lp_ref(sub[s:s + PLAIN_ROWS], sub, p)
                    for s in range(0, nl, PLAIN_ROWS)]

        bnd = pairwise_bound(nl, nl, d, p, nl)
        # the library call: one PyTorch call of the same function (rooted at p = 2)
        row.update({**kernel_ms(lambda: kd.pairwise_lp(sub, sub, p), reps=10, calls=10),
                    "plain_ms": median_ms(plain, reps=5, warmup=1),
                    "bound_ms": bnd[0], "bound_by": bnd[1],
                    "library_ms": median_ms(lambda: torch.cdist(sub, sub, p=float(p)),
                                            reps=10)})
    return row


def screen_case(Qp, batch, band, thresh, sb, p, base, bd, label):
    """gather_lp_screen against its plain version: keep and nd equal on
    every candidate. Kills are counted by where they fell: at entry
    (nd = 0) or mid-scan (0 < nd < d)."""
    from repro_torch.kernels import lp_distance as kd
    from repro_torch.kernels import ref

    keep, nd = kd.gather_lp_screen(Qp, batch, band.codes, band.scale, band.radius, thresh, sb,
                                   p, base, bd)
    k_ref, nd_ref = ref.gather_lp_screen_ref(Qp, batch, band.codes, band.scale, band.radius,
                                             thresh, sb, p, base, bd)
    _sync()
    keep_diff = int((keep.bool() != k_ref).sum())
    nd_diff = int((nd != nd_ref).sum())
    check(keep_diff == 0 and nd_diff == 0,
          f"gather_lp_screen p={label}: keep differs on {keep_diff}, nd on {nd_diff}")
    n, d = band.codes.shape
    killed = (batch >= 0) & (batch < n) & ~keep.bool()
    return nd, {"survivors": int(keep.sum()), "kills": int(killed.sum()),
                "entry_kills": int((killed & (nd == 0)).sum()),
                "mid_scan_kills": int((killed & (nd > 0) & (nd < d)).sum()),
                "nd_values": int(nd.unique().numel()),
                # band bytes of the blocks scanned (the bound's), and the bytes the
                # kernel reads: the whole row of every candidate alive at entry
                "band_bytes_scanned": int(nd.sum()), "band_bytes_read": d * int((nd > 0).sum()),
                "keep_mismatch": keep_diff, "nd_mismatch": nd_diff}


def tight_thresh(Qp, batch, band, p):
    """Thresholds that kill: each row's median of the plain certified lower
    bound over its batch, times 1/4, 1/2, 3/4 or 1 by row (see
    screen_tight)."""
    import torch

    from repro_torch.index.compressed import compressed_lower_bound

    b, c = batch.shape
    n = band.codes.shape[0]
    rows = torch.arange(b, device=batch.device)
    lb = compressed_lower_bound(Qp, band.codes[batch.long().clamp(0, n - 1).reshape(-1)],
                                band.scale, band.radius, p)
    factor = 0.25 * (1 + rows % 4)
    return (lb.reshape(b, b, c)[rows, rows].median(dim=1).values * factor).contiguous()


def screen_tight(Qp, batch, band, sb, p, base, bd, label) -> dict:
    """The screen at thresholds that kill: each row's median of the plain
    certified lower bound over its batch, times 1/4, 1/2, 3/4 or 1 by row.
    The batch's bounds lie within a few percent of each other, so the
    median alone kills only at the last block; the smaller factors make
    candidates die at every depth in every p family. Once with the path's
    base bounds (entry and suffix tests), once with none (sb = 0: the
    lower-bound sum alone; at p = 2 the base bound is exact, so with it
    every kill is at entry). Each must kill; the
    second must kill mid-scan, with nd taking at least three values. The
    kills that the base bound brings forward are the suffix test's."""
    import torch

    thresh = tight_thresh(Qp, batch, band, p)
    out, nds = {}, {}
    for name, sbc in (("base_bound", sb), ("no_bound", torch.zeros_like(sb))):
        nds[name], st = screen_case(Qp, batch, band, thresh, sbc, p, base, bd,
                                    f"{label} tight {name}")
        check(st["kills"] > 0, f"gather_lp_screen p={label} tight {name}: no kill")
        out[name] = st
    # killed mid-scan earlier with the base bound than without: the suffix test
    nb, nn = nds["base_bound"], nds["no_bound"]
    out["base_bound"]["suffix_kills"] = int(((nb > 0) & (nb < nn)).sum())
    st = out["no_bound"]
    check(st["mid_scan_kills"] > 0 and st["nd_values"] >= 3,
          f"gather_lp_screen p={label} tight no_bound: {st['mid_scan_kills']} mid-scan kills, "
          f"{st['nd_values']} nd values")
    return out


def block_stats(ids, n: int) -> dict:
    """What a candidate block asks of the gather: distinct ids per row (the
    rows a node's block needs), distinct rows per window of 1,024 nodes
    (the rows a tile of nodes shares), and the share of padding ids."""
    import torch

    valid = (ids >= 0) & (ids < n)
    key = torch.where(valid, ids.long(), -1)
    srt = key.sort(1).values
    heads = torch.cat([srt[:, :1] >= 0, (srt[:, 1:] != srt[:, :-1]) & (srt[:, 1:] >= 0)], 1)
    per_row = heads.sum(1).double()
    windows = [int(torch.unique(key[w:w + 1024][valid[w:w + 1024]]).numel())
               for w in range(0, ids.shape[0], 1024)]
    return {"slots_per_row": ids.shape[1], "distinct_per_row_mean": float(per_row.mean()),
            "distinct_per_row_min": int(per_row.min()), "distinct_per_row_max": int(per_row.max()),
            "slots_per_distinct": float(valid.sum() / per_row.sum()),
            "distinct_rows_per_1024_nodes_mean": float(np.mean(windows)),
            "distinct_rows_per_1024_nodes_min": int(np.min(windows)),
            "padding_share": float((~valid).double().mean()),
            "distinct_pairs": int(per_row.sum()), "distinct_rows": int(torch.unique(key[valid]).numel())}


def gather_build_block(q, ids, X, label: str) -> dict:
    """gather_lp at the bulk build's scoring shape, both metrics of the
    shared pass: the multi-p kernel's one launch (p = 1 and 2) against the
    single-p kernel's two launches on the same ids, which must give the
    same bits, and against the plain version on its first PLAIN_ROWS rows
    (the plain version builds a (B, C, d) block, too large at the full
    shape), which is also what `plain_ms` times."""
    import torch

    from repro_torch.kernels import lp_distance as kd
    from repro_torch.kernels import ref

    n, d = X.shape
    b, c = ids.shape
    ps = (1.0, 2.0)
    got = kd.gather_lp_multi(q, ids, X, ps)
    singles = [kd.gather_lp(q, ids, X, p) for p in ps]
    rows = slice(0, PLAIN_ROWS)
    want = [ref.gather_lp_ref(q[rows], ids[rows], X, p) for p in ps]
    _sync()
    same = all(bool(torch.equal(got[i], singles[i])) for i in range(len(ps)))
    check(same, f"gather_lp build {label}: the multi-p kernel's bits differ from gather_lp's")
    errs = [rel_err(got[i, rows], want[i]) for i in range(len(ps))]
    rel, abs_err, mis = max(e[0] for e in errs), max(e[1] for e in errs), sum(e[2] for e in errs)
    check(mis == 0 and rel <= RTOL, f"gather_lp build {label}: rel {rel} mismatch {mis}")
    stats = block_stats(ids, n)
    # each input read once: the distinct corpus rows the block names, the
    # node rows, the ids; both outputs written once. Operations: each
    # distinct (node, id) pair's d elements, a subtract and an abs shared by
    # the two metrics, then an add (L1) and an FMA (L2).
    ops_pair = OPS_PER_ELEMENT[1.0] + OPS_PER_ELEMENT[2.0] - 2
    bnd = bound(4 * (stats["distinct_rows"] * d + q.numel() + b * c + len(ps) * b * c),
                float(stats["distinct_pairs"]) * d * ops_pair)
    fused = kernel_ms(lambda: kd.gather_lp_multi(q, ids, X, ps), reps=10, calls=5)
    old = [kernel_ms(lambda: kd.gather_lp(q, ids, X, p), reps=10, calls=5) for p in ps]
    slab_rows = kd.SLAB_BYTES // (4 * d)
    plan_ms = device_ms(lambda: kd.gather_plan(ids, n, slab_rows), calls=5)
    return {"case": f"build scoring, {label} ids, p = 1 and 2", "shape": [b, c, d],
            "block": stats, "bits_equal_gather_lp": same, "max_rel_err": rel,
            "max_abs_err": abs_err, "ms": fused["ms"], "device_ms": fused["device_ms"],
            "plan_device_ms": plan_ms, "slab_rows": slab_rows,
            "gather_lp_two_launches_ms": old[0]["ms"] + old[1]["ms"],
            "gather_lp_two_launches_device_ms": old[0]["device_ms"] + old[1]["device_ms"],
            "gather_lp_p1_device_ms": old[0]["device_ms"],
            "gather_lp_p2_device_ms": old[1]["device_ms"],
            "plain_rows": PLAIN_ROWS,
            "plain_ms_on_plain_rows": median_ms(
                lambda: [ref.gather_lp_ref(q[rows], ids[rows], X, p) for p in ps], reps=5),
            "bound_ms": bnd[0], "bound_by": bnd[1],
            "gathered_bytes_ms": 4 * b * c * d / HBM_BYTES_PER_S * 1e3, "library_ms": None}


def gather_multi_cases(X) -> dict:
    """gather_lp_multi at shapes the build's defaults do not reach, each
    equal to gather_lp's bits at its p and within RTOL of the plain
    version: d = 37 (rows not 16-byte aligned: 4-byte loads), one p and
    two general p, small slabs (many spans a row, padding at both ends),
    long runs of one id and an all-padding row."""
    import torch

    from repro_torch.kernels import lp_distance as kd
    from repro_torch.kernels import ref

    rng = np.random.default_rng(3)
    out = {}
    saved = kd.SLAB_BYTES
    try:
        for label, d, ps, slab_bytes in (("d=37 p=0.8", 37, (0.8,), 4 * 37 * 500),
                                         ("d=64 p=1.5,0.5", 64, (1.5, 0.5), 4 * 64 * 700),
                                         ("d=512 p=1.25,2 one slab", 512, (1.25, 2.0), 0)):
            n = 3000
            x = X[:n, :d].contiguous()
            q = X[n:n + 300, :d].contiguous()
            ids = torch.from_numpy(rng.integers(-2, n + 3, (300, 200)).astype(np.int32))
            ids[:, 100:] = ids[:, :100]                      # every id twice
            ids[7] = ids[7, 0]                               # one run over the whole row
            ids[9] = -1                                      # all padding
            ids = ids.to(X.device)
            kd.SLAB_BYTES = slab_bytes
            got = kd.gather_lp_multi(q, ids, x, ps)
            for i, p in enumerate(ps):
                single = kd.gather_lp(q, ids, x, p)
                want = ref.gather_lp_ref(q, ids, x, p)
                _sync()
                check(bool(torch.equal(got[i], single)),
                      f"gather_lp_multi {label}: bits differ from gather_lp at p={p}")
                rel, abs_err, mis = rel_err(got[i], want)
                check(mis == 0 and rel <= RTOL,
                      f"gather_lp_multi {label} p={p}: rel {rel} mismatch {mis}")
                out[f"{label} p={p}"] = {"max_rel_err": rel, "max_abs_err": abs_err}
    finally:
        kd.SLAB_BYTES = saved
    return out


def screen_setup(index, Q, p_mix):
    """What the band search hands the screen: the band, the queries in its
    coordinate order, the block width, and for each case (label, p, base
    metric, that metric's candidate set, threshold) at every p and the
    mixed batch, the threshold being the k-th best exact distance of the
    first k candidates, as the verification loop makes it."""
    from repro_torch.core.metrics import base_metric_for
    from repro_torch.kernels import ref
    from repro_torch.kernels.ops import pick_abandon_block_d

    band = index.compressed_band()
    Qp = Q[:, band.perm].contiguous()
    bd = pick_abandon_block_d(index.X.shape[1])
    cands = {b: index.search_stage_candidates(Q, b, K) for b in (1.0, 2.0)}
    cases = []
    for label, p, base in ([(str(p), p, base_metric_for(p)) for p in P_SCALAR]
                           + [("mixed", p_mix, 1.0)]):
        c = cands[base]
        first = c.ids[:, :K].contiguous()
        thresh = kth_smallest(ref.gather_lp_ref(Q, first, index.X, p))
        cases.append((label, p, base, c, thresh))
    return band, Qp, bd, cases


def kth_smallest(d):
    """Each row's K-th smallest value, contiguous."""
    import torch

    return torch.sort(d, dim=1).values[:, K - 1].contiguous()


def screen_path_rows(index, Q, p_mix):
    """gather_lp_screen on the band search's kappa batches at every p and
    the mixed batch: keep and nd against the plain version, a batch that
    mostly survives (with frozen and unbounded rows), the tight cases,
    and the times beside the bound. Returns (rows, screen_setup's
    output)."""
    import torch

    from repro_torch.kernels import lp_distance as kd
    from repro_torch.kernels import ref

    band, Qp, bd, cases = screen_setup(index, Q, p_mix)
    d = index.X.shape[1]
    kappa = K // 2
    rows = []
    for label, p, base, c, thresh in cases:
        batch = c.ids[:, K:K + kappa].contiguous()
        sb = c.base_dists[:, K:K + kappa].contiguous()
        nd, stats = screen_case(Qp, batch, band, thresh, sb, p, base, bd, label)
        # also a batch that mostly survives: the last kappa of the first k,
        # with every 8th row frozen (-inf) and every 8th unbounded (+inf)
        r8 = torch.arange(Q.shape[0], device=Q.device) % 8
        thr2 = torch.where(r8 == 1, -torch.inf, torch.where(r8 == 2, torch.inf, thresh))
        _, s_stats = screen_case(Qp, c.ids[:, K - kappa:K].contiguous(), band,
                                 thr2.contiguous(), c.base_dists[:, K - kappa:K].contiguous(),
                                 p, base, bd, label + " survivors")
        check(s_stats["survivors"] > 0, f"no screen survivors to compare at p={label}")
        t_stats = screen_tight(Qp, batch, band, sb, p, base, bd, label)
        ope = ops_per_element(p)
        ope_rows = np.broadcast_to(ope, (Q.shape[0],)) if ope.size > 1 else ope[0]
        scanned = nd.sum(1).cpu().numpy()
        live_rows = int((nd.sum(1) > 0).sum())
        nbytes = scanned.sum() + 4 * live_rows * d + 8 * d + 4 * (4 * batch.numel()
                                                                  + 2 * Q.shape[0])
        bnd = bound(nbytes, float(np.sum(scanned * (ope_rows + OPS_SCREEN_EXTRA))))
        row = {"p": label, "base_p": base, "shape": list(batch.shape), "block_d": bd, **stats,
               "survivor_case": s_stats, "tight_cases": t_stats,
               "band_frac": float(scanned.sum() / (batch.numel() * d)), "max_abs_err": 0.0,
               **kernel_ms(lambda: kd.gather_lp_screen(Qp, batch, band.codes, band.scale,
                                                       band.radius, thresh, sb, p, base, bd)),
               "plain_ms": median_ms(lambda: ref.gather_lp_screen_ref(
                   Qp, batch, band.codes, band.scale, band.radius, thresh, sb, p, base, bd),
                   reps=PLAIN_REPS, warmup=2),
               "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}
        rows.append(row)
    suffix = sum(r["tight_cases"]["base_bound"]["suffix_kills"] for r in rows)
    check(suffix > 0, "gather_lp_screen: the suffix test killed no candidate in any tight case")
    return rows, (band, Qp, bd, cases)


def screen_shapes(index, Q, band, Qp, bd, cases) -> dict:
    """gather_lp_screen at shapes the band path's defaults do not reach,
    keep and nd equal to the plain version's in each (screen_case): block_d
    8 and 16 (64 blocks, two chunks of the kernel's kill tests, and 32),
    C = 1 and 37, the kappa batch as strided column slices of the
    candidate ids and base sums (no copy), d = 37 (one block; band rows
    neither 16- nor 4-byte aligned), frozen (-inf) and +inf thresholds with
    padding ids, and query rows with a NaN coordinate (the lower sum turns
    NaN and kills nothing from its block on). Thresholds are the tight
    ones (tight_thresh), so candidates die at every depth."""
    import torch

    from repro_torch.index.compressed import build_band
    from repro_torch.kernels import ref

    X = index.X
    n, d = X.shape
    kappa = K // 2
    out = {}
    by_label = {label: (p, base, c, thr) for label, p, base, c, thr in cases}
    for label in ("0.8", "2.0", "mixed"):
        p, base, c, _ = by_label[label]
        batch = c.ids[:, K:K + kappa].contiguous()
        sb = c.base_dists[:, K:K + kappa].contiguous()
        thr = tight_thresh(Qp, batch, band, p)
        for w in (8, 16):
            for sbn, sbc in (("base_bound", sb), ("no_bound", torch.zeros_like(sb))):
                nd, st = screen_case(Qp, batch, band, thr, sbc, p, base, w,
                                     f"{label} block_d={w} {sbn}")
                st["kills_past_256_dims"] = int(((nd > 256) & (nd < d)).sum())
                out[f"block_d={w} p={label} {sbn}"] = st
    check(sum(v["kills_past_256_dims"] for k, v in out.items() if "block_d=8 " in k) > 0,
          "gather_lp_screen block_d = 8: no kill in the second chunk of 32 blocks")
    for label in ("1.25", "mixed"):
        p, base, c, thr_k = by_label[label]
        for width in (1, 37):
            batch = c.ids[:, K:K + width].contiguous()
            sb = c.base_dists[:, K:K + width].contiguous()
            for tn, thr in (("path", thr_k), ("tight", tight_thresh(Qp, batch, band, p))):
                out[f"C={width} p={label} {tn}"] = screen_case(
                    Qp, batch, band, thr, sb, p, base, bd, f"{label} C={width} {tn}")[1]
    for label in ("0.5", "mixed"):
        p, base, c, thr_k = by_label[label]
        batch = c.ids[:, K:K + kappa]                    # views: row stride t
        sb = c.base_dists[:, K:K + kappa]
        check(batch.stride(1) == 1 and batch.stride(0) > kappa, "strided slices")
        for tn, thr in (("path", thr_k), ("tight", tight_thresh(Qp, batch, band, p))):
            out[f"strided p={label} {tn}"] = screen_case(Qp, batch, band, thr, sb, p, base, bd,
                                                          f"{label} strided {tn}")[1]
    # d = 37: its own band over the corpus's first 37 coordinates
    X37, Q37 = X[:, :37].contiguous(), Q[:, :37].contiguous()
    band37 = build_band(X37)
    Qp37 = Q37[:, band37.perm].contiguous()
    for label in ("0.8", "2.0", "mixed"):
        p, base, c, _ = by_label[label]
        batch = c.ids[:, K:K + kappa].contiguous()
        sb = ref.gather_lp_ref(Q37, batch, X37, base).contiguous()
        thr = kth_smallest(ref.gather_lp_ref(Q37, c.ids[:, :K].contiguous(), X37, p))
        for tn, th in (("path", thr), ("tight", tight_thresh(Qp37, batch, band37, p))):
            out[f"d=37 p={label} {tn}"] = screen_case(Qp37, batch, band37, th, sb, p, base, 37,
                                                       f"{label} d=37 {tn}")[1]
    # frozen and +inf rows, padding ids, NaN coordinates
    rows = torch.arange(Q.shape[0], device=Q.device)
    for label in ("1.25", "mixed"):
        p, base, c, _ = by_label[label]
        batch = c.ids[:, K:K + kappa].clone()
        sb = c.base_dists[:, K:K + kappa].contiguous()
        pad = rows % 5 == 3
        batch[pad, 0] = -1
        batch[pad, 1] = n
        batch[pad, 2] = n + 7
        thr = tight_thresh(Qp, batch, band, p)
        thr = torch.where(rows % 8 == 1, -torch.inf, torch.where(rows % 8 == 2, torch.inf, thr))
        qn = Qp.clone()
        qn[4, 100] = float("nan")                        # in the fourth block
        qn[12, 0] = float("nan")                         # in the first
        qn[20, d - 1] = float("nan")                     # in the last
        for sbn, sbc in (("base_bound", sb), ("no_bound", torch.zeros_like(sb))):
            nd, st = screen_case(qn, batch, band, thr.contiguous(), sbc, p, base, bd,
                                 f"{label} frozen/inf/padding/NaN {sbn}")
            check(bool((nd[rows % 8 == 1] == 0).all()), "a frozen row scanned")
            st["nan_rows_nd"] = nd[[4, 12, 20]].tolist()
            out[f"frozen/inf/padding/NaN p={label} {sbn}"] = st
    return out


def phase_kernels_bulk(index, Q, build_rec):
    """pairwise_lp at every upper-level call of the bulk build and at the
    shared-ids form, gather_lp at the build's own scoring shape (its
    multi-p form on the build's recorded round-2 block and on random ids),
    gather_lp_screen at the band search's shapes, at thresholds that kill
    and at shapes the band search's defaults do not reach, each against
    its plain version."""
    import torch

    from repro_torch.kernels import lp_distance as kd
    from repro_torch.kernels import ref

    t0 = _now()
    X = index.X
    n, d = X.shape
    dev = X.device
    out = {"pairwise_lp": [], "gather_lp_screen": []}
    worst = {"pairwise_lp": 0.0, "gather_lp_screen": 0.0}
    node_rows, real_ids = build_rec["round2"]
    out["gather_lp_build"] = gather_build_block(X[node_rows].contiguous(), real_ids, X, "real")
    emit({"phase": "kernels_bulk", "kernel": "gather_lp", **out["gather_lp_build"]})
    rand_ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, n, real_ids.shape).astype(np.int32)).to(dev)
    out["gather_lp_build_random"] = gather_build_block(X[node_rows].contiguous(), rand_ids, X,
                                                       "random")
    emit({"phase": "kernels_bulk", "kernel": "gather_lp", **out["gather_lp_build_random"]})
    del rand_ids
    out["gather_lp_multi_cases"] = gather_multi_cases(X)
    emit({"phase": "kernels_bulk", "kernel": "gather_lp",
          "multi_cases": out["gather_lp_multi_cases"]})
    worst["gather_lp_build"] = max(out["gather_lp_build"]["max_abs_err"],
                                   out["gather_lp_build_random"]["max_abs_err"],
                                   *(r["max_abs_err"] for r in
                                     out["gather_lp_multi_cases"].values()))

    # every upper level's pass of the bulk build (levels are shared by G1
    # and G2), at both base metrics, as one launch each; timed at level 1
    levels = index.g1.levels
    for lvl in range(1, int(levels.max()) + 1):
        sub = X[torch.nonzero(levels >= lvl)[:, 0]].contiguous()
        if sub.shape[0] <= 1:
            continue                       # the build scores no single-node level
        for p in (1.0, 2.0):
            row = pairwise_level(sub, p, f"level {lvl} p={p}", timed=lvl == 1)
            out["pairwise_lp"].append(row)
            worst["pairwise_lp"] = max(worst["pairwise_lp"], row["max_abs_err"])
            emit({"phase": "kernels_bulk", "kernel": "pairwise_lp", **row})
    ids = torch.from_numpy(np.random.default_rng(0).choice(n, SHARED_IDS, replace=False)).to(dev)
    p_mix = torch.from_numpy(mixed_p(Q.shape[0])).to(dev)
    row = pairwise_case(Q, X[ids].contiguous(), p_mix, "shared ids, mixed p")
    out["pairwise_lp"].append(row)
    worst["pairwise_lp"] = max(worst["pairwise_lp"], row["max_abs_err"])
    emit({"phase": "kernels_bulk", "kernel": "pairwise_lp", **row})
    # ragged shapes: B and N not multiples of the 128-row tile, d not a
    # multiple of the 32-deep stage, and d % 4 != 0 (rows that are not
    # 16-byte aligned take the kernel's 4-byte staging)
    for (b, nn, dd), ps in (((1000, 777, 100), (1.0, 2.0, 0.8, "mixed")),
                            ((130, 129, 33), (1.5, 2.0, "mixed"))):
        q = X[:b, :dd].contiguous()
        x = X[b:b + nn, :dd].contiguous()
        for p in ps:
            pv = torch.from_numpy(mixed_p(b)).to(dev) if p == "mixed" else p
            errs = check_pairwise(f"ragged {b}x{nn}x{dd} p={p}",
                                  pairwise_errors(kd.pairwise_lp(q, x, pv),
                                                  ref.pairwise_lp_ref(q, x, pv), q, x, pv))
            worst["pairwise_lp"] = max(worst["pairwise_lp"], errs["max_abs_err"])
            emit({"phase": "kernels_bulk", "kernel": "pairwise_lp",
                  "case": f"ragged p={p}", "shape": [b, nn, dd], **errs})

    # the screen on the band search's kappa batches, then at shapes its
    # defaults do not reach
    out["gather_lp_screen"], setup = screen_path_rows(index, Q, p_mix)
    for row in out["gather_lp_screen"]:
        emit({"phase": "kernels_bulk", "kernel": "gather_lp_screen", **row})
    out["gather_lp_screen_shapes"] = screen_shapes(index, Q, *setup)
    emit({"phase": "kernels_bulk", "kernel": "gather_lp_screen",
          "shape_cases": out["gather_lp_screen_shapes"]})
    emit({"phase": "kernels_bulk", "seconds": _now() - t0})
    return out, worst


def phase_band(index, Q, default_results):
    """The bulk index searched with compressed_band=True, then with
    energy_perm=True, at every p and the mixed batch, each counted: ids
    equal the default abandon path's, dists agree within the tests'
    tolerance."""
    from dataclasses import replace

    import torch

    t0 = _now()
    prm0 = index.params
    report = {}
    band_counts = None
    for flag in ("compressed_band", "energy_perm"):
        index.params = replace(prm0, **{flag: True})
        _search(index, Q, 0.8)                     # builds the band or the view; not counted
        results, counts = counted(run_searches, index, Q)
        per_p = {}
        for p in (*P_SCALAR, "mixed"):
            ids, dists, st, secs, launched = results[p]
            d_ids, d_dists = default_results[p][:2]
            check(bool((ids == d_ids).all()), f"{flag}: ids differ from the default at p={p}")
            fin = d_dists.isfinite()
            check(bool((dists.isfinite() == fin).all()), f"{flag}: inf pattern at p={p}")
            err = (dists[fin].double() - d_dists[fin].double()).abs()
            check(bool((err <= RTOL * d_dists[fin].double().abs() + ATOL).all()),
                  f"{flag}: dists differ from the default at p={p}")
            per_p[str(p)] = {
                "ids_equal_default": True, "max_abs_err": float(err.max()) if err.numel() else 0.0,
                "n_f32_rows_frac": float(torch.as_tensor(st.n_f32_rows_frac).float().mean()),
                "n_band_frac": float(torch.as_tensor(st.n_band_frac).float().mean()),
                "n_dim_frac": float(torch.as_tensor(st.n_dim_frac).float().mean()),
                "mean_n_p": float(st.n_p.float().mean()), "batch_seconds": secs,
                "launches": launched}
        if flag == "compressed_band":
            check(counts["gather_lp_screen"] > 0 and counts["gather_lp"] > 0,
                  f"band path did not launch its kernels: {counts}")
            band_counts = counts
        report[flag] = {"per_p": per_p, "launches": counts}
    index.params = prm0
    emit({"phase": "band", "seconds": _now() - t0, **report})
    return band_counts


def topk_errors(got_d, got_i, want_d, want_i, all_d, k: int, label: str) -> dict:
    """lp_topk against its plain version: dists within RTOL; ids equal but
    where candidates tie at the k-th distance: every id that only one of
    the two returns must lie within RTOL of the k-th smallest of the
    row's root-free plain distances `all_d`."""
    rel, abs_err, mismatch = rel_err(got_d, want_d)
    check(mismatch == 0 and rel <= RTOL, f"lp_topk {label}: rel {rel} mismatch {mismatch}")
    differ = (got_i.sort(1).values != want_i.sort(1).values).any(1)
    kth = all_d.sort(1).values[:, k - 1].double()
    for row in differ.nonzero()[:, 0].tolist():
        extra = sorted(set(got_i[row].tolist()) ^ set(want_i[row].tolist()))
        gap = (all_d[row, extra].double() - kth[row]).abs()
        check(bool((gap <= RTOL * kth[row].abs()).all()),
              f"lp_topk {label}: ids differ away from a k-th tie in row {row}")
    return {"max_rel_err": rel, "max_abs_err": abs_err, "rows_differ_at_tie": int(differ.sum())}


def phase_kernels_rest(index, Q):
    """rowwise_lp and lp_topk through their entry points at the shared-pass
    index's candidates (t = 300): c = X[candidate ids], (256, 300, 512).
    The entry-point calls are the counted path; each output is then held
    against its plain version, and each kernel timed beside its bound."""
    import torch

    from repro_torch.kernels import lp_distance as kd
    from repro_torch.kernels import ref
    from repro_torch.kernels.lp_topk import lp_topk
    from repro_torch.kernels.ops import lp_rowwise_distance

    t0 = _now()
    X = index.X
    ids = index.search_stage_candidates(Q, 1.0, K).ids.long()
    check(bool((ids >= 0).all()), "kernels_rest: padding among the candidates")
    c = X[ids].contiguous()                                  # (B, t, d)
    b, t, d = c.shape
    p_mix = torch.from_numpy(mixed_p(b)).to(X.device)
    cases = [(str(p), p) for p in ROWWISE_P] + [("mixed", p_mix)]
    topk_cases = [(p, k) for p in P_SCALAR for k in (10, 50)]

    def path():
        return ({label: lp_rowwise_distance(Q, c, p, root=False) for label, p in cases},
                {(p, k): lp_topk(Q, c, p, k) for p, k in topk_cases})

    (rows_out, topk_out), launched = counted(path)
    check(launched["rowwise_lp"] == len(cases) and launched["lp_topk"] == len(topk_cases),
          f"kernels_rest: entry points did not launch their kernels: {launched}")
    out = {"rowwise_lp": [], "lp_topk": []}
    worst = {"rowwise_lp": 0.0, "lp_topk": 0.0}
    plain_d = {}
    for label, p in cases:
        want = ref.rowwise_lp_ref(Q, c, p)
        plain_d[label] = want
        r, a, mis = rel_err(rows_out[label], want)
        check(mis == 0 and r <= RTOL, f"rowwise_lp p={label}: rel {r} mismatch {mis}")
        worst["rowwise_lp"] = max(worst["rowwise_lp"], a)
        ops = float(np.broadcast_to(ops_per_element(p), (b,)).sum()) * t * d
        bnd = bound(4 * (c.numel() + Q.numel() + b * t + b), ops)
        row = {"p": label, "shape": [b, t, d], "max_rel_err": r, "max_abs_err": a,
               **kernel_ms(lambda: kd.rowwise_lp(Q, c, p), reps=20),
               "plain_ms": median_ms(lambda: ref.rowwise_lp_ref(Q, c, p), reps=5),
               "bound_ms": bnd[0], "bound_by": bnd[1],
               "library_ms": None if label == "mixed" else median_ms(
                   lambda: torch.cdist(Q[:, None], c, p=float(p)), reps=20)}
        out["rowwise_lp"].append(row)
        emit({"phase": "kernels_rest", "kernel": "rowwise_lp", **row})
    for p, k in topk_cases:
        got_d, got_i = topk_out[(p, k)]
        want_d, want_i = ref.lp_topk_ref(Q, c, p, k)
        errs = topk_errors(got_d, got_i, want_d, want_i, plain_d[str(p)], k, f"p={p} k={k}")
        worst["lp_topk"] = max(worst["lp_topk"], errs["max_abs_err"])
        row = {"p": p, "k": k, "shape": [b, t, d], **errs}
        if k == K:
            ope = float(ops_per_element(p)[0])
            bnd = bound(4 * (c.numel() + Q.numel() + 2 * b * k + b), ope * c.numel())
            row.update({**kernel_ms(lambda: lp_topk(Q, c, p, k), reps=20),
                        "plain_ms": median_ms(lambda: ref.lp_topk_ref(Q, c, p, k), reps=5),
                        "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None})
        out["lp_topk"].append(row)
        emit({"phase": "kernels_rest", "kernel": "lp_topk", **row})
    # ties: every candidate row again at index + t; a copy may come back
    # only after its original (the lower index wins the tie). Against the
    # plain version, as above: distinct rows that nearly tie at the k-th
    # distance may still swap.
    twin = torch.cat([c, c], 1)
    for p in P_SCALAR:
        twin_d = ref.rowwise_lp_ref(Q, twin, p)
        for k in (11, 50):
            got_d, got_i = lp_topk(Q, twin, p, k)
            want_d, want_i = ref.lp_topk_ref(Q, twin, p, k)
            topk_errors(got_d, got_i, want_d, want_i, twin_d, k, f"tie case p={p} k={k}")
            for slot in range(k):
                copy = got_i[:, slot] >= t
                first = (got_i[:, :slot] == (got_i[:, slot] - t)[:, None]).any(1)
                check(bool((~copy | first).all()),
                      f"lp_topk tie case p={p} k={k}: a copy came before its original")
    # k above the 64 the kernel once capped, up to k = C = t: the running
    # list sized by k in shared memory
    large_k = {}
    for p, k in ((1.25, 65), (0.8, 65), (1.25, t), (0.5, t)):
        got_d, got_i = lp_topk(Q, c, p, k)
        want_d, want_i = ref.lp_topk_ref(Q, c, p, k)
        errs = topk_errors(got_d, got_i, want_d, want_i, ref.rowwise_lp_ref(Q, c, p), k,
                           f"large k p={p} k={k}")
        worst["lp_topk"] = max(worst["lp_topk"], errs["max_abs_err"])
        large_k[f"p={p} k={k}"] = errs
    emit({"phase": "kernels_rest", "kernel": "lp_topk", "large_k_cases": large_k})
    # a block of 257 candidates: not a whole tile
    c257 = c[:, :257].contiguous()
    for p in P_SCALAR:
        got_d, got_i = lp_topk(Q, c257, p, K)
        want_d, want_i = ref.lp_topk_ref(Q, c257, p, K)
        topk_errors(got_d, got_i, want_d, want_i, ref.rowwise_lp_ref(Q, c257, p), K,
                    f"C=257 p={p}")
    # NaN and +inf rows among the candidates: +inf after every number, NaN
    # last, each in the plain version's place
    cn = c[:, :64].clone()
    cn[0, 7] = float("nan")
    cn[1, 3] = float("inf")
    cn[2, ::9] = float("nan")
    for p in P_SCALAR:
        for k in (K, 64):
            got_d, got_i = lp_topk(Q, cn, p, k)
            want_d, want_i = ref.lp_topk_ref(Q, cn, p, k)
            topk_errors(got_d, got_i, want_d, want_i, ref.rowwise_lp_ref(Q, cn, p), k,
                        f"NaN/inf p={p} k={k}")
            odd = want_d.isnan() | want_d.isinf()
            check(bool((got_d.isnan() == want_d.isnan()).all())
                  and bool((got_d.isinf() == want_d.isinf()).all())
                  and bool((got_i[odd] == want_i[odd]).all()),
                  f"lp_topk NaN/inf p={p} k={k}: a NaN or +inf out of place")
    # rows that are not 16-byte aligned (d = 37: 4-byte copies into the rings)
    q37, c37 = Q[:, :37].contiguous(), c[:, :64, :37].contiguous()
    # and rows wider than the rings take (d = 1,100: read from device memory)
    qw = torch.cat([Q, Q, Q[:, :76]], 1).contiguous()
    cw = torch.cat([c[:, :64], c[:, :64], c[:, :64, :76]], 2).contiguous()
    for p in (0.8, 2.0):
        for label, qq, cc in (("d=37", q37, c37), ("d=1100", qw, cw)):
            got_d, got_i = lp_topk(qq, cc, p, K)
            want_d, want_i = ref.lp_topk_ref(qq, cc, p, K)
            topk_errors(got_d, got_i, want_d, want_i, ref.rowwise_lp_ref(qq, cc, p), K,
                        f"{label} p={p}")
    emit({"phase": "kernels_rest", "seconds": _now() - t0, "launches": launched,
          "tie_cases": "passed", "c257_cases": "passed", "nan_inf_cases": "passed",
          "d37_d1100_cases": "passed"})
    del c, twin
    return out, worst, launched


SHARDED_P = (0.5, 1.25, 2.0)
ROWWISE_P = (0.5, 0.8, 1.0, 1.25, 1.5, 2.0)   # every p family of the rowwise kernel
SEGMENTS = 4
DELTA_ROWS = 256         # 512 until the mesh came (its seconds: PERF.md §4)
DELTA_CAPACITY = 1024


def check_candidates(idx, Q, base: float, label: str) -> dict:
    """A merged candidate list: ids unique in each row, -1 padding only at
    the end, distances ascending, and each real id at its exact base
    distance (within RTOL: the beam sums in other shapes)."""
    import torch

    from repro_torch.core.metrics import lp_distance

    c = idx.search_stage_candidates(Q, base, K)
    ids, d = c.ids.long(), c.base_dists
    real = ids >= 0
    check(bool((real[:, :-1] | ~real[:, 1:]).all()), f"{label}: padding before a real id")
    srt = ids.sort(1).values
    check(bool(((srt[:, 1:] != srt[:, :-1]) | (srt[:, 1:] < 0)).all()), f"{label}: repeated id")
    check(bool((d[:, 1:] >= d[:, :-1]).all()), f"{label}: distances not ascending")
    exact = lp_distance(Q[:, None, :], idx.X[ids.clamp(min=0)], base, root=False)
    r, a, mis = rel_err(torch.where(real, d, torch.inf), torch.where(real, exact, torch.inf))
    check(mis == 0 and r <= RTOL, f"{label}: base distances off by {r} (mismatch {mis})")
    return {"real_per_row_min": int(real.sum(1).min()), "max_rel_err": r}


def phase_sharded(X, Q, truth):
    """ShardedUHNSW.build(X, 4 segments, m = 16, method="bulk") searched
    under each policy at SHARDED_P and the mixed batch, counted: recall@10,
    N_b with its probe and spill shares, N_p, hops, seconds per batch and
    launches (the monolithic shared-pass index's are `search_bulk`'s).
    Checks: every policy's merged candidates are real, unique, ascending
    and at their exact base distances; the independent policy's ids with
    the kernels equal its ids with the plain versions at p = 0.5 and on the
    mixed batch. two_phase at thresh_rank = t is measured against the
    independent policy (rows equal), and must equal it wherever their
    merged candidate lists are equal."""
    import torch

    from repro_torch.core.metrics import base_metric_for
    from repro_torch.core.uhnsw import recall
    from repro_torch.index import ShardedParams, ShardedUHNSW

    torch.cuda.reset_peak_memory_stats()
    t0 = _now()
    idx, build_launched = counted(ShardedUHNSW.build, X, num_segments=SEGMENTS, m=M,
                                  method="bulk", seed=0, delta_capacity=DELTA_CAPACITY)
    build_seconds = _now() - t0
    check(build_launched["pairwise_lp"] > 0 and build_launched["gather_lp"] > 0,
          f"sharded build did not launch its kernels: {build_launched}")
    sizes = [g.n for g in idx.segments.graphs1]
    check(sum(sizes) == X.shape[0] and idx.num_segments == SEGMENTS, f"segments {sizes}")
    policies = {"independent": ShardedParams(),
                "two_phase": ShardedParams(policy="two_phase", probe=1),
                "round_robin": ShardedParams(policy="round_robin")}
    per_policy, results = {}, {}
    counts = None
    for name, sp in policies.items():
        idx.sharded_params = sp
        res, launched = counted(run_searches, idx, Q, SHARDED_P)
        results[name] = res
        if name == "independent":
            counts = launched
        per_p = {}
        for p in (*SHARDED_P, "mixed"):
            ids, dists, st, secs, l_p = res[p]
            tr = mixed_truth(truth, Q.shape[0]) if p == "mixed" else truth[p]
            n_b = st.n_b.double()
            nb_pr, nb_sp = st.phase_n_b()
            check(bool(dists.isfinite().all()) and ids.shape == (Q.shape[0], K),
                  f"sharded {name}: output at p={p}")
            check(bool((torch.as_tensor(nb_pr) + torch.as_tensor(nb_sp) == st.n_b).all()),
                  f"sharded {name}: n_b != probe + spill at p={p}")
            per_p[str(p)] = {
                "recall@10": recall(ids, tr),
                "mean_n_b": float(n_b.mean()),
                "n_b_probe_share": float(torch.as_tensor(nb_pr).double().sum() / n_b.sum()),
                "n_b_spill_share": float(torch.as_tensor(nb_sp).double().sum() / n_b.sum()),
                "mean_n_p": float(st.n_p.float().mean()),
                "mean_hops": float(st.hops.float().mean()),
                "batch_seconds": secs, "launches": l_p}
        per_policy[name] = {"per_p": per_p, "launches": launched}
        emit({"phase": "sharded", "policy": name, **per_policy[name]})
    check(counts["gather_lp"] > 0 and counts["gather_lp_abandon"] > 0,
          f"sharded: kernels not launched on the query path: {counts}")
    # every policy's merged candidates: real ids, unique and ascending, each
    # at its exact base distance (the fold's id offsets, on the card)
    cand_checks = {}
    for name, sp in policies.items():
        idx.sharded_params = sp
        for base in (1.0, 2.0):
            label = f"{name} base {base}"
            cand_checks[label] = check_candidates(idx, Q, base, label)
    # two_phase at the loosest admissible rank (thresh_rank = t): the bound
    # prunes nothing of the independent merged top-t, but a spill beam that
    # strands above the bound (its level-0 greedy walk stops at a local
    # minimum above it, and the cut admits no neighbour) finds nothing. So
    # the rows are counted, not required to be equal; where the merged
    # candidate lists are equal the final ids must be too.
    idx.sharded_params = ShardedParams(policy="two_phase", probe=1, thresh_rank=idx.params.t)
    safe = run_searches(idx, Q, SHARDED_P)
    rank_t = {}
    for p in (*SHARDED_P, "mixed"):
        ids_i, ids_s = results["independent"][p][0], safe[p][0]
        rank_t[str(p)] = {"rows_ids_equal_independent": int((ids_s == ids_i).all(1).sum()),
                          "mean_n_b": float(safe[p][2].n_b.float().mean()),
                          "recall@10": recall(ids_s, mixed_truth(truth, Q.shape[0])
                                              if p == "mixed" else truth[p])}
    for base in (1.0, 2.0):
        idx.sharded_params = policies["independent"]
        c_i = idx.search_stage_candidates(Q, base, K)
        idx.sharded_params = ShardedParams(policy="two_phase", probe=1, thresh_rank=idx.params.t)
        c_s = idx.search_stage_candidates(Q, base, K)
        same = (c_i.ids == c_s.ids).all(1)
        rank_t[f"rows_candidates_equal_base_{base}"] = int(same.sum())
        for p in (*SHARDED_P, "mixed"):
            if p != "mixed" and base_metric_for(p) != base:
                continue
            rows = same if p != "mixed" else same & torch.from_numpy(
                base_metric_for(mixed_p(Q.shape[0])) == base).to(same.device)
            check(bool((safe[p][0][rows] == results["independent"][p][0][rows]).all()),
                  f"sharded: equal candidates gave other ids at p={p}")
    idx.sharded_params = policies["independent"]
    # the two-band verification on the sharded index: the independent
    # policy's ids, through the screen
    from dataclasses import replace

    prm0 = idx.params
    idx.params = replace(prm0, compressed_band=True)
    _search(idx, Q, 0.8)                               # builds the band; not counted
    band_res, band_counts = counted(
        lambda: {p: _search(idx, Q, mixed_p(Q.shape[0]) if p == "mixed" else p)
                 for p in (1.25, "mixed")})
    idx.params = prm0
    check(band_counts["gather_lp_screen"] > 0,
          f"sharded band search did not launch gather_lp_screen: {band_counts}")
    band_report = {"launches": band_counts}
    for p, (ids, _, st, secs) in band_res.items():
        check(bool((ids == results["independent"][p][0]).all()),
              f"sharded band search: ids differ from the independent policy's at p={p}")
        band_report[str(p)] = {
            "ids_equal_independent": True, "batch_seconds": secs,
            "n_f32_rows_frac": float(torch.as_tensor(st.n_f32_rows_frac).float().mean()),
            "n_band_frac": float(torch.as_tensor(st.n_band_frac).float().mean()),
            "mean_n_p": float(st.n_p.float().mean())}
    with plain_versions():
        plain = {p: _search(idx, Q, mixed_p(Q.shape[0]) if p == "mixed" else p)
                 for p in (0.5, "mixed")}
    for p, out in plain.items():
        check(bool((out[0] == results["independent"][p][0]).all()),
              f"sharded: independent ids with the kernels differ from the plain versions at p={p}")
    emit({"phase": "sharded", "seconds": _now() - t0, "build_seconds": build_seconds,
          "segment_sizes": sizes, "peak_device_mib": torch.cuda.max_memory_allocated() / 2**20,
          "build_launches": build_launched, "candidate_checks": cand_checks,
          "two_phase_thresh_rank_t": rank_t, "ids_equal_plain": True,
          "compressed_band": band_report})
    return idx, counts


MESH_INDEX_P = (0.5, "mixed")
MESH_SERVE_REQUESTS = 128  # mixed-p requests through the engine on the placed index


def phase_mesh_index(idx, Q) -> None:
    """The sharded index placed over a one-rank NCCL group's (1, 1) mesh
    (`shard_over`: the segment axis over 'data', which 1 divides), searched
    at MESH_INDEX_P under the policy it has, counted: ids, dists and every
    counter equal to the unplaced search's. Then the engine's `serve` on
    the placed index, through the path that sends rank 0's orders over the
    group (`retrieval.engine.orders`: to no other rank here), with
    MESH_SERVE_REQUESTS mixed-p requests: ids and dists equal to
    `serve_grouped`'s on the same placed index. Then unplaced again and the
    group closed, so the later phases run as before."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import Runtime
    from repro_torch.launch.mesh import make_local_mesh

    t0 = _now()
    want = {p: _search(idx, Q, mixed_p(Q.shape[0]) if p == "mixed" else p)
            for p in MESH_INDEX_P}
    t = _now()
    mesh = make_local_mesh(1, 1, device="cuda")
    group_s = _now() - t
    backend = dist.get_backend()
    try:
        idx.shard_over(Runtime(mesh=mesh))
        placed = idx._place is not None
        got, launched = counted(lambda: {p: _search(idx, Q, mixed_p(Q.shape[0]) if p == "mixed"
                                                    else p) for p in MESH_INDEX_P})
        serve = mesh_serve(idx, Q)
    finally:
        idx.shard_over(None)
        dist.destroy_process_group()
    equal = {}
    for p in MESH_INDEX_P:
        a, b = got[p], want[p]
        equal[str(p)] = bool(torch_equal(a[0], b[0]) and torch_equal(a[1], b[1]) and all(
            torch_equal(getattr(a[2], f), getattr(b[2], f))
            for f in ("n_b", "n_p", "hops", "n_b_probe", "n_b_spill")))
    out = {"phase": "mesh_index", "backend": backend, "mesh": [1, 1], "placed": placed,
           "policy": idx.sharded_params.policy, "segments": idx.num_segments,
           "queries": Q.shape[0], "p": [str(p) for p in MESH_INDEX_P], "equal": equal,
           "batch_seconds": {str(p): got[p][3] for p in MESH_INDEX_P},
           "unplaced_batch_seconds": {str(p): want[p][3] for p in MESH_INDEX_P},
           "group_start_s": group_s, "launches": launched, "serve": serve,
           "seconds": _now() - t0}
    check(placed and all(equal.values()), f"mesh: shard_over's search differs: {out}")
    check(serve["equal_to_grouped"], f"mesh: the engine's serve differs: {serve}")
    check_launched(launched, ("gather_lp", "gather_lp_abandon"), "mesh_index")
    emit(out)


def mesh_serve(idx, Q) -> dict:
    """`UniversalVectorService.serve` on the placed index against its
    `serve_grouped`: MESH_SERVE_REQUESTS requests drawn as `serve_requests`
    draws them."""
    import torch.distributed as dist

    from repro_torch.retrieval.engine import orders
    from repro_torch.retrieval.service import QueryRequest, UniversalVectorService

    Qh = Q.cpu().numpy()
    rng = np.random.default_rng(2)
    reqs = [QueryRequest(vector=Qh[int(rng.integers(len(Qh)))], p=float(rng.choice(SERVE_P)),
                         k=K, request_id=i) for i in range(MESH_SERVE_REQUESTS)]
    svc = UniversalVectorService(index=idx)
    sent = []
    send = orders.send

    def counting(order):
        sent.append(order[0])
        send(order)

    orders.send = counting
    try:
        t = _now()
        got, launched = counted(svc.serve, reqs)
        serve_s = _now() - t
    finally:
        orders.send = send
    want = svc.serve_grouped(reqs)
    equal = sorted(got) == sorted(want) and all(
        np.array_equal(got[i][0], want[i][0]) and np.array_equal(got[i][1], want[i][1])
        for i in want)
    return {"requests": len(reqs), "served": len(got), "ranks": dist.get_world_size(),
            "orders": {k: sent.count(k) for k in sorted(set(sent))},
            "waves": svc.stats["batches"], "equal_to_grouped": bool(equal),
            "seconds": serve_s, "qps": len(got) / serve_s, "launches": launched}


def torch_equal(a, b) -> bool:
    import torch

    return bool(torch.equal(torch.as_tensor(a), torch.as_tensor(b)))


def phase_delta(idx):
    """Streaming inserts into the sharded index: DELTA_ROWS fresh rows of
    the corpus generator (the same mixture, not corpus members) go in with
    add(); each, searched for at every p, must come back at rank 0, with
    abandon on (the threshold scan, gather_lp_abandon; p = 2 keeps the
    pairwise form) and off (pairwise_lp). The delta scan's launches are
    each search's launches less those of the same search with the buffer
    empty. Then the buffer is filled to DELTA_CAPACITY, which compacts it
    into a fifth segment (shared-pass build); the graphs now find the rows,
    so each must come back at rank 0 wherever its beam found it among the
    merged candidates, and the misses are counted."""
    from dataclasses import replace

    import torch

    from repro_torch.core.datasets import make_dataset
    from repro_torch.core.metrics import base_metric_for
    from repro_torch.index import ShardedParams

    t0 = _now()
    dev = idx.X.device
    fresh = make_dataset("sun", n=N_SUN, n_queries=DELTA_CAPACITY, seed=0).queries
    rows = torch.from_numpy(fresh[:DELTA_ROWS]).to(dev)
    n0 = idx.n
    idx.sharded_params = ShardedParams()
    prm0 = idx.params

    def searches(abandon: bool):
        idx.params = replace(prm0, abandon=abandon)
        out = counted(run_searches, idx, rows, SHARDED_P)
        idx.params = prm0
        return out

    empty = {ab: searches(ab)[1] for ab in (True, False)}
    gids = torch.tensor([idx.add(v) for v in fresh[:DELTA_ROWS]], dtype=torch.int32, device=dev)
    check(len(idx.delta) == DELTA_ROWS and int(gids[0]) == n0, "delta adds")
    report, delta_launches = {}, {}
    for ab in (True, False):
        res, launched = searches(ab)
        per_p = {}
        for p in (*SHARDED_P, "mixed"):
            ids, dists, st, secs, _ = res[p]
            check(bool((ids[:, 0] == gids).all()),
                  f"delta (abandon={ab}): an inserted row is not its own top-1 at p={p}")
            per_p[str(p)] = {"batch_seconds": secs, "mean_n_p": float(st.n_p.float().mean()),
                             "n_dim_frac": float(torch.as_tensor(st.n_dim_frac).float().mean())}
        delta_launches[ab] = {k: launched[k] - empty[ab][k] for k in launched}
        report[f"abandon_{ab}"] = {"per_p": per_p, "delta_scan_launches": delta_launches[ab]}
    check(delta_launches[True]["gather_lp_abandon"] > 0,
          f"delta scan never launched gather_lp_abandon: {delta_launches}")
    check(delta_launches[True]["pairwise_lp"] > 0 and delta_launches[False]["pairwise_lp"] > 0,
          f"delta scan never launched pairwise_lp: {delta_launches}")
    t1 = _now()
    for v in fresh[DELTA_ROWS:]:
        idx.add(v)
    compact_seconds = _now() - t1
    check(idx.num_segments == SEGMENTS + 1 and len(idx.delta) == 0
          and idx.n == n0 + DELTA_CAPACITY, "compaction into a fifth segment")
    res, launched = counted(run_searches, idx, rows, SHARDED_P)
    # now the rows are found by the fifth segment's graphs, an approximate
    # search: a row must come back at rank 0 wherever its own id is among
    # its merged base-metric candidates, and the rows whose beam missed
    # them are counted
    in_cands = {b: (idx.search_stage_candidates(rows, b, K).ids == gids[:, None]).any(1)
                for b in (1.0, 2.0)}
    row_base = torch.from_numpy(base_metric_for(mixed_p(DELTA_ROWS))).to(dev)
    post = {}
    for p in (*SHARDED_P, "mixed"):
        ids, _, st, secs, _ = res[p]
        found = in_cands[base_metric_for(p)] if p != "mixed" else torch.where(
            row_base == 1.0, in_cands[1.0], in_cands[2.0])
        at0 = ids[:, 0] == gids
        check(bool((at0 | ~found).all()),
              f"delta: a row among its own candidates is not its top-1 after compaction at p={p}")
        post[str(p)] = {"rows_at_rank_0": int(at0.sum()), "rows_in_candidates": int(found.sum()),
                        "batch_seconds": secs, "mean_n_b": float(st.n_b.float().mean())}
    emit({"phase": "delta", "seconds": _now() - t0, "rows": DELTA_ROWS, **report,
          "fill_and_compact_seconds": compact_seconds,
          "segment_sizes": [g.n for g in idx.segments.graphs1], "after_compaction": post,
          "launches_after_compaction": launched})
    return delta_launches


NAN_CASES = ((1.0, 1.25), (1.0, "mixed"), (2.0, "mixed"))
DURABLE_P = (1.25,)       # SHARDED_P until the engine's serve over a mesh came: cut for time
DURABLE_ROWS = 1536      # inserts through DurableIndex.add: one compaction at DELTA_CAPACITY
SERVE_REQUESTS = 1024     # 2,048 until the LM phases came; cut for the smoke's time
SERVE_P = (0.5, 0.8, 1.0, 1.3, 1.7, 2.0)   # src/repro/launch/serve.py's draw
SERVE_BATCH = 256
POISON_SEGMENT = 1
CLI_N = 100_000          # the `deep` generator at its published width (d = 256); 200,000 until
                         # the LM phases came, cut for the smoke's time
CLI_REQUESTS = 1024
CLI_SEGMENTS = 4
# recall@10 floor of the serve phase at each p: its reading on the H100 at
# 1,024 requests (0.836, 0.981, 1.0, 0.970, 0.977, 0.991) less about 0.03 to 0.05
SERVE_RECALL_FLOOR = {0.5: 0.79, 0.8: 0.95, 1.0: 0.97, 1.3: 0.93, 1.7: 0.94, 2.0: 0.96}
SAMPLE_EVERY = 4         # sampled_kernels checks calls 0, 4, 8, ... of each kernel,
SAMPLE_MAX = 10          # at most this many of each,
SAMPLE_ROWS = 64         # on this many leading rows (pairwise_lp: SAMPLE_ROWS // 4)


def check_launched(counts: dict, names, label: str) -> None:
    check(all(counts[n] > 0 for n in names), f"{label}: kernels not launched: {counts}")


def nan_abandon(Q, ids, X, thresh, sb, p, base, bd, label, nan_slots) -> dict:
    """gather_lp_abandon against its plain version where NaN base sums or
    NaN rows are in play. On `nan_slots` (a NaN base sum or a NaN row) nd,
    +inf and NaN must agree slot for slot, and a NaN base sum must die at
    entry (nd 0, +inf). On the other slots, compare_abandon's rule: nd
    agrees on at least 99% (a partial sum may tie with the threshold), and
    where it does, +inf and NaN agree and finite distances within RTOL."""
    from repro_torch.kernels import lp_distance as kd
    from repro_torch.kernels import ref

    got, nd = kd.gather_lp_abandon(Q, ids, X, thresh, sb, p, base, bd)
    want, nd_ref = ref.gather_lp_abandon_ref(Q, ids, X, thresh, sb, p, base, bd)
    _sync()
    same = nd == nd_ref
    pattern = (got.isinf() == want.isinf()) & (got.isnan() == want.isnan())
    bad_nan = int((nan_slots & ~(same & pattern)).sum())
    agree = float(same[~nan_slots].float().mean())
    fin = same & got.isfinite() & want.isfinite()
    r, a, _ = rel_err(got[fin], want[fin]) if bool(fin.any()) else (0.0, 0.0, 0)
    check(bad_nan == 0, f"gather_lp_abandon NaN case {label}: {bad_nan} NaN slots differ")
    check(agree >= 0.99 and bool(pattern[same].all()) and r <= RTOL,
          f"gather_lp_abandon NaN case {label}: nd agreement {agree}, rel {r}")
    nan_sb = sb.isnan()
    check(bool((nd[nan_sb] == 0).all() & got[nan_sb].isinf().all()),
          f"gather_lp_abandon NaN case {label}: a NaN base sum was not killed at entry")
    return {"nan_slots": int(nan_slots.sum()), "nan_base_sums": int(nan_sb.sum()),
            "killed_at_entry": int((nd == 0).sum()), "nan_dists": int(got.isnan().sum()),
            "survivors": int(got.isfinite().sum()), "nd_agreement_other_slots": agree,
            "max_rel_err": r, "max_abs_err": a}


def phase_nan(index, Q):
    """The kernels' NaN cases. A NaN corpus row is what
    `engine.faults.poison_segment` writes; its base sum is NaN, and the
    plain versions (and the reference) kill such a candidate at entry.
    gather_lp_abandon and gather_lp_screen get, at each case of NAN_CASES
    (base metric, p): NaN corpus rows with their NaN base sums, NaN base
    sums planted on clean rows, and (abandon) NaN rows with the bound off
    (base sums 0, as the delta scan passes them), each at thresholds that
    kill only at entry and at the path's (each row's 5th-best exact
    distance of the first 10 candidates). pairwise_lp gets a NaN corpus
    row and a NaN query row at p = 2 (the product identity) and mixed p.
    Each must equal its plain version slot for slot. Not counted: these
    are comparisons, not a path."""
    import torch

    from repro_torch.kernels import lp_distance as kd
    from repro_torch.kernels import ref
    from repro_torch.kernels.ops import pick_abandon_block_d

    t0 = _now()
    X, dev = index.X, index.X.device
    b = Q.shape[0]
    bd = pick_abandon_block_d(X.shape[1])
    band = index.compressed_band()
    Qp = Q[:, band.perm].contiguous()
    loose = torch.full((b,), 3e38, device=dev)
    report = {"abandon": {}, "screen": {}, "pairwise": {}}
    for base, p in NAN_CASES:
        pv = torch.from_numpy(mixed_p(b)).to(dev) if p == "mixed" else p
        ids = index.search_stage_candidates(Q, base, K).ids[:, :10].contiguous()
        bad = torch.unique(ids[: b // 4, ::3].reshape(-1)).long()
        bad = bad[bad >= 0]
        Xn = X.clone()
        Xn[bad] = torch.nan
        row_nan = torch.isin(ids.long(), bad)
        sb_rows = ref.gather_lp_ref(Q, ids, Xn, base)
        sb_clean = ref.gather_lp_ref(Q, ids, X, base)
        sb_planted = sb_clean.clone()
        sb_planted[::7, 2] = torch.nan
        sb_planted[1::5, 7] = torch.nan
        path = torch.sort(ref.gather_lp_ref(Q, ids, X, pv), dim=1).values[:, 4].contiguous()
        label = f"base={base} p={p}"
        for tname, thr in (("entry", loose), ("path", path)):
            for cname, xs, sb in (("nan_rows", Xn, sb_rows), ("nan_base_sums", X, sb_planted),
                                  ("nan_rows_no_bound", Xn, torch.zeros_like(sb_rows))):
                report["abandon"][f"{label} {cname} {tname}"] = nan_abandon(
                    Q, ids, xs, thr, sb, pv, base, bd, f"{label} {cname} {tname}",
                    sb.isnan() | (row_nan if xs is Xn else torch.zeros_like(row_nan)))
            for cname, sb in (("nan_rows", sb_rows), ("nan_base_sums", sb_planted)):
                _, row = screen_case(Qp, ids, band, thr, sb, pv, base, bd,
                                     f"NaN {label} {cname} {tname}")
                check(row["survivors"] <= int((~sb.isnan()).sum()),
                      f"gather_lp_screen NaN {label} {cname} {tname}: a NaN base sum survived")
                report["screen"][f"{label} {cname} {tname}"] = {
                    "nan_base_sums": int(sb.isnan().sum()), **row}
    q = Q[:64].clone()
    q[5] = torch.nan
    x = X[:1024].clone()
    x[17] = torch.nan
    ok_r = torch.ones(q.shape[0], dtype=torch.bool, device=dev)
    ok_r[5] = False
    ok_c = torch.ones(x.shape[0], dtype=torch.bool, device=dev)
    ok_c[17] = False
    for label, p in (("2.0", 2.0), ("mixed", torch.from_numpy(mixed_p(q.shape[0])).to(dev))):
        got, want = kd.pairwise_lp(q, x, p), ref.pairwise_lp_ref(q, x, p)
        _sync()
        nan_diff = int((got.isnan() != want.isnan()).sum())
        check(nan_diff == 0 and bool(got[5].isnan().all() & got[:, 17].isnan().all()),
              f"pairwise_lp NaN case p={label}: NaN differs on {nan_diff} entries")
        pr = p if isinstance(p, float) else p[ok_r]
        errs = check_pairwise(f"NaN case p={label}", pairwise_errors(
            got[ok_r][:, ok_c], want[ok_r][:, ok_c], q[ok_r], x[ok_c], pr))
        report["pairwise"][label] = {"nan_entries": int(got.isnan().sum()), **errs}
    emit({"phase": "nan_cases", "seconds": _now() - t0, "cases": sum(
        len(v) for v in report.values()), **report})


def same_results(a: dict, b: dict, label: str) -> None:
    """Two run_searches results: ids, dists, N_b and N_p bitwise equal."""
    import torch

    for p in a:
        (ia, da, sa), (ib, db, sb_) = a[p][:3], b[p][:3]
        check(torch.equal(ia, ib) and torch.equal(da, db) and torch.equal(sa.n_b, sb_.n_b)
              and torch.equal(sa.n_p, sb_.n_p), f"{label}: results differ at p={p}")


def phase_durable(idx, Q):
    """The durability layer on the sharded index as the delta phase left
    it: DurableIndex.create in a temporary directory, DURABLE_ROWS fresh
    rows of the generator's mixture through add() (fsync per record; one
    compaction at DELTA_CAPACITY, whose rotation writes a second
    snapshot), searches at DURABLE_P and the mixed batch, then recover()
    into a fresh index, which must give ids, dists, N_b and N_p bitwise
    equal to the live index's. A copy of the directory with the newest WAL
    record cut short must recover to the adds before it. Then
    poison_segment(POISON_SEGMENT) on the live index (no poisoned id
    returned, the guard raised) and restore_segment from the snapshot:
    the ids equal the clean ones again. Returns the recovered index,
    re-armed as a DurableIndex (its own snapshot and WAL), and the
    directory."""
    import shutil
    import tempfile
    import warnings

    import torch

    from repro_torch.core.datasets import make_dataset
    from repro_torch.index.persist import DurableIndex, recover, restore_segment
    from repro_torch.index.wal import list_wals
    from repro_torch.retrieval.engine.faults import poison_segment

    t0 = _now()
    state = Path(tempfile.mkdtemp(prefix="uhnsw_state_"))
    fresh = make_dataset("sun", n=N_SUN, n_queries=DURABLE_ROWS, seed=1).queries
    segs0, n0 = idx.num_segments, idx.n
    t1 = _now()
    dur = DurableIndex.create(idx, state)
    create_s = _now() - t1
    snap_bytes = (state / "snapshot_00000000" / "arrays.npz").stat().st_size
    add_s = []

    def adds():
        for v in fresh:
            t = time.perf_counter()
            dur.add(v)
            add_s.append(time.perf_counter() - t)

    _, add_launches = counted(adds)
    check(idx.num_segments == segs0 + 1 and idx.n == n0 + DURABLE_ROWS
          and len(idx.delta) == (len(fresh) + n0 - idx.X.shape[0]),
          f"durable adds: {idx.num_segments} segments, n {idx.n}")
    # the compaction's shared pass: at 1,024 rows it takes the exact seed,
    # so no multi-p gather
    check_launched(add_launches, ("pairwise_lp", "gather_lp"), "durable adds' compaction")
    live, search_launches = counted(run_searches, idx, Q, DURABLE_P)
    dur.close()
    wal_bytes = {p.name: p.stat().st_size for _, p in list_wals(state)}
    # a crash mid-append: the newest record cut 7 bytes short
    torn = Path(tempfile.mkdtemp(prefix="uhnsw_torn_"))
    shutil.rmtree(torn)
    shutil.copytree(state, torn)
    newest = list_wals(torn)[-1][1]
    newest.write_bytes(newest.read_bytes()[:-7])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cut = recover(torn, device=idx.X.device)
    check(cut.n == idx.n - 1 and len(cut.delta) == len(idx.delta) - 1
          and any("torn" in str(w.message) for w in caught),
          f"torn WAL: recovered n {cut.n}, live n {idx.n}")
    check(torch.equal(torch.from_numpy(cut.delta.vectors()),
                      torch.from_numpy(idx.delta.vectors()[:-1])), "torn WAL: delta rows")
    del cut
    shutil.rmtree(torn)
    t2 = _now()
    rec = recover(state, device=idx.X.device)
    recover_s = _now() - t2
    got, rec_launches = counted(run_searches, rec, Q, DURABLE_P)
    same_results(live, got, "recovered index")
    t3 = _now()
    rdur = DurableIndex.create(rec, state)
    save_s = _now() - t3
    # poison, then restore from the snapshot
    gids = torch.from_numpy(poison_segment(idx, POISON_SEGMENT)).to(idx.X.device)
    ids_p, _, st_p = idx.search(Q, 1.25, K)
    check(not bool(torch.isin(ids_p.long(), gids).any()), "a poisoned id was returned")
    check(bool(torch.as_tensor(st_p.poisoned).any()), "the poison guard did not trip")
    check(restore_segment(idx, POISON_SEGMENT, state), "restore_segment found no snapshot")
    restored = run_searches(idx, Q, DURABLE_P)
    same_results(live, restored, "restored segment")
    emit({"phase": "durable", "seconds": _now() - t0, "state_dir_snapshot_bytes": snap_bytes,
          "wal_bytes": wal_bytes, "create_save_seconds": create_s,
          "adds": DURABLE_ROWS, "adds_seconds": sum(add_s),
          "adds_per_second": DURABLE_ROWS / sum(add_s),
          "add_seconds_median": float(np.median(add_s)),
          "add_seconds_max_compaction": max(add_s), "add_launches": add_launches,
          "recover_seconds": recover_s, "resave_seconds": save_s,
          "segments": rec.num_segments, "n": rec.n, "delta_rows": len(rec.delta),
          "recovered_bitwise_equal": True, "search_launches": search_launches,
          "recovered_search_launches": rec_launches, "torn_tail_recovered_to": idx.n - 1,
          "poisoned_rows": int(gids.numel()), "poisoned_query_rows": int(
              torch.as_tensor(st_p.poisoned).sum()), "restored_equal": True})
    return rdur, state


def serve_requests(Qh):
    """SERVE_REQUESTS requests drawn as src/repro/launch/serve.py draws
    them: a query with replacement, then p from SERVE_P, k = 10."""
    from repro_torch.retrieval.service import QueryRequest

    rng = np.random.default_rng(0)
    reqs, rows = [], []
    for i in range(SERVE_REQUESTS):
        row = int(rng.integers(len(Qh)))
        reqs.append(QueryRequest(vector=Qh[row], p=float(rng.choice(SERVE_P)), k=K,
                                 request_id=i))
        rows.append(row)
    return reqs, np.asarray(rows)


def stage_timer(pipe) -> dict:
    """Host seconds of every stage-A dispatch, stage-B dispatch and collect
    of one engine's pipeline (no extra synchronisation: a stage that blocks
    on the device on its own shows that in its own time), each with its
    wave's shape (base, k, exact, size)."""
    times = {"search": [], "finish": [], "collect": []}
    for attr, key in (("dispatch_search", "search"), ("dispatch_finish", "finish"),
                      ("collect", "collect")):
        fn = getattr(pipe, attr)

        def timed(wave, fn=fn, key=key):
            t = time.perf_counter()
            out = fn(wave)
            times[key].append(((wave.base, wave.k, wave.exact, wave.size),
                               time.perf_counter() - t))
            return out

        setattr(pipe, attr, timed)
    return times


def stage_summary(times: dict) -> dict:
    """Per stage: calls, seconds in all and a call; and for the whole wave
    (both stages and the collect), the first wave of each shape against
    the later waves of a shape already seen."""
    out = {k: {"calls": len(v), "sum": sum(t for _, t in v),
               "mean": float(np.mean([t for _, t in v]))} for k, v in times.items()}
    wave = [sum(ts) for ts in zip(*([t for _, t in times[k]]
                                    for k in ("search", "finish", "collect")))]
    seen, first, later = set(), [], []
    for (shape, _), secs in zip(times["search"], wave):
        (later if shape in seen else first).append(secs)
        seen.add(shape)
    out["wave_seconds"] = {"first_of_shape": {"waves": len(first), "mean": float(np.mean(first))},
                           "later": {"waves": len(later),
                                     "mean": float(np.mean(later)) if later else None}}
    return out


def served(svc, reqs, label: str):
    """One serve of the stream, timed: (results, seconds, launches)."""
    t = _now()
    out, launched = counted(svc.serve, reqs)
    return out, _now() - t, launched


def equal_results(a: dict, b: dict, label: str) -> None:
    check(set(a) == set(b), f"serve {label}: {len(a)} results against {len(b)}")
    for rid, (ids, dists) in a.items():
        check(np.array_equal(ids, b[rid][0]) and np.array_equal(dists, b[rid][1]),
              f"serve {label}: request {rid} differs")


def phase_serve(rdur, Q):
    """The serving tier over the recovered durable index: a
    UniversalVectorService (max_batch 256, the other defaults) serves
    SERVE_REQUESTS requests through the engine. Recall@10 against brute
    force for each p, held to SERVE_RECALL_FLOOR, qps, latency p50 / p95
    with the queue-wait / compute split, waves, flush reasons, padded
    rows, each kernel's launches, and each stage's host seconds against
    the collect's. Then the same stream with
    FaultInjector(rate=0.1, seed=0): the results equal the clean run's.
    Then per-segment injection (sites "segment", rate 0.05), segment
    POISON_SEGMENT NaN-poisoned and min_coverage 0.75: every request
    served, none failed, no poisoned id returned and the segment
    quarantined; the next pump restores it from the snapshot and the
    canary probes re-admit it. Last, serve_grouped serves the stream on
    the restored index: its ids and dists must equal the clean engine
    run's bitwise (the engine equals serve_grouped, and the restored
    index equals the clean one)."""
    import torch

    from repro_torch.core.hnsw import exact_topk
    from repro_torch.index import HEALTHY, QUARANTINED
    from repro_torch.retrieval.engine import FaultInjector
    from repro_torch.retrieval.engine.faults import poison_segment
    from repro_torch.retrieval.service import UniversalVectorService

    t0 = _now()
    dev = Q.device
    Qh = Q.cpu().numpy()
    reqs, rows = serve_requests(Qh)
    svc = UniversalVectorService(index=rdur, max_batch=SERVE_BATCH)
    stages = stage_timer(svc.engine.pipeline)
    clean, secs, launched = served(svc, reqs, "clean")
    check(len(clean) == SERVE_REQUESTS and not svc.engine.take_failures(), "serve: clean run")
    check_launched(launched, ("gather_lp", "gather_lp_abandon"), "serve path")
    st, lat = svc.stats, svc.latency_summary()
    # recall@10 of each p against a brute-force top-10 over every row
    corpus = torch.cat([rdur.X, torch.from_numpy(rdur.delta.vectors()).to(dev)])
    gid_of = torch.cat([torch.arange(rdur.X.shape[0], device=dev),
                        torch.from_numpy(rdur.delta.ids().astype(np.int64)).to(dev)])
    recall_p = {}
    for p in SERVE_P:
        truth = gid_of[exact_topk(corpus, Q, p, K)[0].long()].cpu().numpy()
        sel = [r for r in reqs if r.p == p]
        hits = sum(len(set(clean[r.request_id][0].tolist()) & set(truth[rows[r.request_id]]))
                   for r in sel)
        recall_p[str(p)] = hits / (K * max(len(sel), 1))
        check(recall_p[str(p)] >= SERVE_RECALL_FLOOR[p],
              f"serve: recall@10 {recall_p[str(p)]} at p={p}, below {SERVE_RECALL_FLOOR[p]}")
    # transient faults at every classic site
    inj = FaultInjector(rate=0.1, seed=0)
    svc_f = UniversalVectorService(index=rdur, max_batch=SERVE_BATCH, fault_injector=inj)
    faulted, faulted_s, _ = served(svc_f, reqs, "faulted")
    check(not svc_f.engine.take_failures(), "faulted serve: a request failed")
    equal_results(faulted, clean, "faulted vs clean")
    check(svc_f.stats["faults"] == inj.injected > 0, "faulted serve: fault accounting")
    # per-segment faults, a poisoned segment and a coverage floor
    inj_s = FaultInjector(rate=0.05, seed=0, sites=("segment",))
    svc_p = UniversalVectorService(index=rdur, max_batch=SERVE_BATCH, fault_injector=inj_s,
                                   min_coverage=0.75)
    gids = set(poison_segment(rdur, POISON_SEGMENT).tolist())
    poisoned, poisoned_s, _ = served(svc_p, reqs, "poisoned")
    failures = svc_p.engine.take_failures()
    leaked = sum(len(gids & set(ids.tolist())) for ids, _ in poisoned.values())
    check(leaked == 0, f"poisoned serve: {leaked} poisoned ids returned")
    check(rdur.health.state(POISON_SEGMENT) == QUARANTINED
          and svc_p.stats["poison_detected"] > 0, "poisoned serve: segment not quarantined")
    check(not failures and len(poisoned) == SERVE_REQUESTS,
          f"poisoned serve: {len(poisoned)} served, {len(failures)} failed")
    st_p = dict(svc_p.stats)
    svc_p.engine.pump()                     # the maintenance slot: restore + canaries
    check(rdur.health.state(POISON_SEGMENT) == HEALTHY
          and rdur.health.alive() == list(range(rdur.num_segments))
          and svc_p.stats["seg_recovered"] >= 1, "poisoned segment not restored and re-admitted")
    # serve_grouped on the restored index: equal to the clean engine run
    # both because the engine equals serve_grouped and because the
    # restored segment serves its old rows again
    t_g = _now()
    grouped = svc.serve_grouped(reqs)
    grouped_s = _now() - t_g
    equal_results(clean, grouped, "engine vs serve_grouped after recovery")
    fl = st["flushes"]
    emit({"phase": "serve", "seconds": _now() - t0, "requests": SERVE_REQUESTS,
          "serve_seconds": secs, "qps": SERVE_REQUESTS / secs, "waves": st["batches"],
          "flushes": fl, "padded_rows": st["padded_rows"], "queue_peak": st["queue_peak"],
          "latency_ms": {k: lat[k] for k in ("p50", "p95", "mean", "max")},
          "queue_ms": lat["queue_ms"], "compute_ms": lat["compute_ms"],
          "cold_requests": lat["cold_count"], "warm_latency_ms": lat["warm"],
          "stage_seconds": stage_summary(stages),
          "launches": launched, "recall@10": recall_p,
          "per_base": {k: {"queries": v["queries"], "batches": v["batches"]}
                       for k, v in st["per_base"].items()},
          "grouped_seconds": grouped_s, "ids_equal_serve_grouped": True,
          "faulted": {"seconds": faulted_s, "faults": svc_f.stats["faults"],
                      "retries": svc_f.stats["retries"],
                      "quarantine_splits": svc_f.stats["quarantine_splits"],
                      "equal_clean": True},
          "poisoned": {"seconds": poisoned_s, "served": len(poisoned), "failed": len(failures),
                       "poison_detected": st_p["poison_detected"],
                       "seg_quarantined": st_p["seg_quarantined"],
                       "segment_faults": inj_s.injected, "retries": st_p["retries"],
                       "coverage_mean": st_p["coverage_w"] / max(st_p["queries"], 1),
                       "poisoned_ids_returned": 0, "seg_recovered": svc_p.stats["seg_recovered"],
                       "final_equal_clean": True}})
    return launched


@contextmanager
def sampled_kernels():
    """Holds a sample of the calls a path makes against the plain versions,
    on the same inputs, while the path runs: calls 0, SAMPLE_EVERY, ... of
    gather_lp, gather_lp_multi, gather_lp_abandon and pairwise_lp (at most
    SAMPLE_MAX of each), on their first SAMPLE_ROWS rows (every kernel
    scores each row on its own). The rules are those of the kernel phases:
    gather_lp and gather_lp_multi within RTOL with +inf in the same
    places; gather_lp_abandon's nd equal on at least 99% of the slots and,
    where it is, distances within RTOL; pairwise_lp as check_pairwise.
    Yields {kernel: [one summary per checked call]}. The plain versions
    launch no kernel, so the path's counts stay its own."""
    import inspect

    import torch

    from repro_torch.kernels import lp_distance, ref

    def rows(t, r):
        return t[:r] if isinstance(t, torch.Tensor) and t.dim() > 0 else t

    def graded(name, a, pairs) -> dict:
        rel, err = 0.0, 0.0
        for got, want in pairs:
            r, e, mis = rel_err(got, want)
            check(mis == 0 and r <= RTOL,
                  f"{name} sampled call {list(a['ids'].shape)}: rel {r} mismatch {mis}")
            rel, err = max(rel, r), max(err, e)
        return {"max_rel_err": rel, "max_abs_err": err}

    def gather(a, out, r):
        return graded("gather_lp", a, [(out[:r], ref.gather_lp_ref(
            a["q"][:r], a["ids"][:r], a["x"], rows(a["p"], r)))])

    def multi(a, out, r):
        return graded("gather_lp_multi", a, [(out[i, :r], ref.gather_lp_ref(
            a["q"][:r], a["ids"][:r], a["x"], pv)) for i, pv in enumerate(a["ps"])])

    def abandon(a, out, r):
        got, nd = out[0][:r], out[1][:r]
        want, nd_ref = ref.gather_lp_abandon_ref(
            a["q"][:r], a["ids"][:r], a["x"], a["thresh"][:r], a["sb"][:r], rows(a["p"], r),
            a["base_p"], a["block_d"])
        same = nd == nd_ref
        agree = float(same.float().mean())
        rel, err, mis = rel_err(torch.where(same, got, 0.0), torch.where(same, want, 0.0))
        check(agree >= 0.99 and mis == 0 and rel <= RTOL,
              f"gather_lp_abandon sampled call {list(a['ids'].shape)}: nd agreement {agree}, "
              f"rel {rel}, mismatch {mis}")
        return {"nd_agreement": agree, "max_rel_err": rel, "max_abs_err": err}

    def pairwise(a, out, r):
        r //= 4
        q, p = a["q"][:r], rows(a["p"], r)
        return check_pairwise(f"sampled call {[a['q'].shape[0], *a['x'].shape]}",
                              pairwise_errors(out[:r], ref.pairwise_lp_ref(q, a["x"], p),
                                              q, a["x"], p))

    graders = {"gather_lp": gather, "gather_lp_multi": multi, "gather_lp_abandon": abandon,
               "pairwise_lp": pairwise}
    report = {name: [] for name in graders}
    saved = {}

    def shim(name, inner):
        sig = inspect.signature(inner)
        seen = [0]

        def call(*args, **kwargs):
            out = inner(*args, **kwargs)
            i = seen[0]
            seen[0] += 1
            if i % SAMPLE_EVERY == 0 and i // SAMPLE_EVERY < SAMPLE_MAX:
                a = sig.bind(*args, **kwargs).arguments
                shape = list(a["ids"].shape) if "ids" in a else [a["q"].shape[0],
                                                                 a["x"].shape[0]]
                report[name].append({"call": i, "shape": shape, "d": int(a["x"].shape[1]),
                                     **graders[name](a, out, SAMPLE_ROWS)})
            return out

        call.launches = inner.launches
        return call

    for name in graders:
        saved[name] = getattr(lp_distance, name)
        setattr(lp_distance, name, shim(name, saved[name]))
    try:
        yield report
    finally:
        for name, fn in saved.items():
            fn.launches = getattr(lp_distance, name).launches
            setattr(lp_distance, name, fn)


def phase_serve_cli():
    """The command line, `repro_torch.launch.serve.main(["--retrieval",
    "--n", CLI_N, "--requests", CLI_REQUESTS, "--state-dir", D])`, twice:
    the first run builds the `deep` index and snapshots it, the second
    recovers it. Both must return 0, report the same n, and serve every
    request (`served CLI_REQUESTS mixed-p requests`) with no fault caught
    and no request failed. The first run holds a sample of its kernel calls
    at d = 256 (the build's and the serving waves') against the plain
    versions (`sampled_kernels`); the second runs unobserved."""
    import contextlib
    import io
    import re
    import shutil
    import tempfile

    from repro_torch.launch import serve

    t0 = _now()
    state = Path(tempfile.mkdtemp(prefix="uhnsw_cli_")) / "state"
    runs = []
    for i in range(2):
        buf = io.StringIO()
        t = _now()
        with contextlib.redirect_stdout(buf), (
                sampled_kernels() if i == 0 else contextlib.nullcontext({})) as samples:
            rc, launched = counted(serve.main, [
                "--retrieval", "--n", str(CLI_N), "--requests", str(CLI_REQUESTS),
                "--segments", str(CLI_SEGMENTS), "--state-dir", str(state)])
        lines = buf.getvalue().splitlines()
        n = re.search(r"n=(\d+)", lines[0])
        done = [re.match(r"served (\d+) mixed-p requests", ln) for ln in lines]
        done = [int(m.group(1)) for m in done if m]
        runs.append({"rc": rc, "seconds": _now() - t, "n": int(n.group(1)) if n else None,
                     "served": done, "lines": lines, "launches": launched,
                     "sampled_calls": samples})
        check(done == [CLI_REQUESTS], f"serve_cli run {i}: served {done} of {CLI_REQUESTS}")
        check(not any("faults:" in ln or "FAILED" in ln for ln in lines),
              f"serve_cli run {i}: a fault was caught or a request failed")
    check(all(r["rc"] == 0 for r in runs), f"serve_cli: exit codes {[r['rc'] for r in runs]}")
    check(runs[0]["lines"][0].startswith("created durable index")
          and runs[1]["lines"][0].startswith("recovered durable index"),
          "serve_cli: the runs did not create, then recover")
    check(runs[0]["n"] == runs[1]["n"] == CLI_N, f"serve_cli: n {[r['n'] for r in runs]}")
    sampled = ("gather_lp", "gather_lp_abandon", "pairwise_lp", "gather_lp_multi")
    check_launched(runs[0]["launches"], sampled, "serve_cli's first run")
    check(all(runs[0]["sampled_calls"][name] for name in sampled),
          "serve_cli: a kernel with no call held against its plain version")
    check_launched(runs[1]["launches"], ("gather_lp", "gather_lp_abandon"), "serve_cli")
    shutil.rmtree(state.parent)
    emit({"phase": "serve_cli", "seconds": _now() - t0, "runs": runs})


LM_ARCH = "tinyllama_1_1b"  # src/repro/configs/tinyllama_1_1b.py, full width, all 22 layers
LM_TF_BATCH = 4          # teacher forcing: prefill LM_TF_PREFILL tokens, then
LM_TF_PREFILL = 256      # LM_TF_DECODE decode steps against the full forward
LM_TF_DECODE = 64
# f32: max |log-prob difference| and argmax agreement; read on the H100:
# 1.7e-5 and 1.0 (256 of 256)
LM_F32_MAX_ERR = 1e-4
LM_F32_MIN_AGREE = 0.996
LM_BF16_MIN_AGREE = 0.85  # bf16: tests/test_serve_consistency.py's rule
LM_CPU_TOKENS = 64       # the f32 forward held against the CPU, B = 1
LM_CPU_RTOL = 1e-5       # max |card - cpu| / max |cpu| of the hidden states (read: 1.8e-6)
LM_SERVE_BATCH = 8       # ServeEngine.generate, bf16, greedy
LM_SERVE_PROMPT = 128
LM_SERVE_STEPS = 128
LM_CLI = ("--arch", LM_ARCH, "--batch", "4", "--prompt-len", "16", "--steps", "32")
KNN_BATCH = 128          # one SyntheticTokenPipeline batch: 128 x 512 = 65,536 pairs
KNN_SEQ = 512
KNN_MICRO = 16           # sequences per forward while the datastore is made
KNN_M, KNN_K, KNN_LAM = 16, 8, 0.3   # examples/knn_lm_serving.py's lam
KNN_QUERIES = 256
KNN_MEM_P = (0.5, 1.0, 1.6)          # tests/test_retrieval.py's p values
KNN_NLL_P = (0.5, 0.8, 1.0, 1.4, 2.0)
KNN_TIMED_P = (0.5,)                 # the d = 2048 kernel rows
# memorized share and recall@8 floors of the knn_lm phase at each p, on the
# `train` phase's weights: the first reading on the H100 (0.699 / 0.694,
# 0.699 / 0.703, 0.703 / 0.707) less 0.05; the host bulk builder strands
# queries at this scale
KNN_FLOOR = {0.5: (0.64, 0.64), 1.0: (0.64, 0.65), 1.6: (0.65, 0.65)}
MLSH_M = 24              # benchmarks/table2_uhnsw_vs_mlsh.py's m
MLSH_P = (0.5, 0.8)
MLSH_CPU_QUERIES = 16
MLSH_NP_RTOL = 0.02      # card against CPU: N_p per query
MLSH_MIN_OVERLAP = 0.99  # card against CPU: mean top-10 overlap


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def start_lm_cli() -> subprocess.Popen:
    """`python -m repro_torch.launch.serve` with LM_CLI, started at the
    start of the LM paths so that its start-up overlaps them; phase `lm`
    reads it."""
    import os

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve", *LM_CLI],
                            cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def teacher_forcing(params, tokens, cfg, rt, prefill: int = LM_TF_PREFILL,
                    decoded: int | None = None) -> dict:
    """Prefill on the first `prefill` tokens, then one decode step per later
    token (`decoded` of them; all the rest when None), each step's log-probs
    against the full forward's at that position; the forward runs over all
    of `tokens`, which may reach past the decoded ones (causal: the extra
    positions change nothing before them). {"max_err", "argmax_agreement",
    "forward_s", "prefill_and_decode_s"}."""
    import torch

    from repro_torch.models import model

    v = cfg.vocab_size
    s0 = prefill
    s = tokens.shape[1] if decoded is None else s0 + decoded
    head = model._head_matrix(params, cfg)
    with torch.no_grad():
        t = _now()
        hidden = model.forward_train(params, {"tokens": tokens}, cfg, rt)
        full = torch.log_softmax(
            torch.einsum("bsd,dv->bsv", hidden[:, s0:s], head)[..., :v].float(), dim=-1)
        del hidden
        t_fwd = _now() - t
        t = _now()
        _, cache = model.prefill(params, {"tokens": tokens[:, :s0]}, cfg, rt, s_max=s)
        err = torch.zeros((), device=tokens.device)
        agree = torch.zeros((), dtype=torch.int64, device=tokens.device)
        for i, pos in enumerate(range(s0, s)):
            logits, cache = model.decode_step(params, tokens[:, pos:pos + 1], cache, pos, cfg,
                                              rt)
            g = torch.log_softmax(logits[:, 0, :v].float(), dim=-1)
            err = torch.maximum(err, (g - full[:, i]).abs().max())
            agree += (g.argmax(-1) == full[:, i].argmax(-1)).sum()
        t_dec = _now() - t
    return {"max_err": float(err), "argmax_agreement": int(agree) / (tokens.shape[0] * (s - s0)),
            "forward_s": t_fwd, "prefill_and_decode_s": t_dec}


def lm_weights(dev) -> dict:
    """LM_ARCH's config and weights: models.init_params with a
    torch.Generator seeded 0, in f32, and the same cast to bf16."""
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.models import model

    t0 = _now()
    cfg = get_arch(LM_ARCH)
    params32 = model.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                 dtype=torch.float32, device=dev)
    params16 = _tree_map(lambda t: t.to(torch.bfloat16) if t.dtype == torch.float32 else t,
                         params32)
    return {"cfg": cfg, "params32": params32, "params16": params16, "init_s": _now() - t0}


def phase_lm(lm: dict, cli: subprocess.Popen, dev):
    """The LM serving path at tinyllama_1_1b's full width, on `lm_weights`:
    teacher forcing in f32 and bf16; the f32 forward on the card against
    the CPU; a served bf16 run through ServeEngine.generate, twice; and the
    command line (`start_lm_cli`). The path is plain torch:
    it launches none of the repo's kernels, which the counts show. Drops
    the f32 weights."""
    import torch

    from repro_torch.dist.sharding import Runtime
    from repro_torch.models import model
    from repro_torch.models.params import count_params
    from repro_torch.serve.engine import ServeEngine

    t0 = _now()
    cfg, params32, params16 = lm["cfg"], lm.pop("params32"), lm["params16"]
    rt = Runtime()
    v = cfg.vocab_size
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, v, size=(
        LM_TF_BATCH, LM_TF_PREFILL + LM_TF_DECODE)).astype(np.int32)).to(dev)
    tf32, launched = counted(teacher_forcing, params32, tokens, cfg, rt)
    check(tf32["max_err"] <= LM_F32_MAX_ERR and tf32["argmax_agreement"] >= LM_F32_MIN_AGREE,
          f"lm f32 teacher forcing: {tf32}")
    tf16 = teacher_forcing(params16, tokens, cfg, rt)
    check(tf16["argmax_agreement"] >= LM_BF16_MIN_AGREE, f"lm bf16 teacher forcing: {tf16}")

    t = _now()
    with torch.no_grad():
        one = tokens[:1, :LM_CPU_TOKENS]
        h_card = model.forward_train(params32, {"tokens": one}, cfg, rt).cpu()
        params_cpu = _tree_map(lambda t: t.cpu(), params32)
        del params32
        h_cpu = model.forward_train(params_cpu, {"tokens": one.cpu()}, cfg, rt)
        del params_cpu
    cpu_rel = float((h_card - h_cpu).abs().max() / h_cpu.abs().max())
    check(bool(h_card.isfinite().all()) and cpu_rel <= LM_CPU_RTOL,
          f"lm: the card's f32 forward against the CPU's: {cpu_rel}")
    cpu_s = _now() - t

    eng = ServeEngine(cfg, rt, params16, max_seq=LM_SERVE_PROMPT + LM_SERVE_STEPS)
    prompts = rng.integers(0, v, size=(LM_SERVE_BATCH, LM_SERVE_PROMPT)).astype(np.int32)
    t = _now()
    out, served_launches = counted(eng.generate, prompts, LM_SERVE_STEPS)
    gen_s = _now() - t
    again = eng.generate(prompts, LM_SERVE_STEPS)
    check(out.shape == (LM_SERVE_BATCH, LM_SERVE_STEPS) and bool(((out >= 0) & (out < v)).all())
          and np.array_equal(out, again), "lm: served tokens out of range or not repeatable")
    ptok = torch.from_numpy(prompts).to(dev)
    with torch.no_grad():
        prefill_s = []
        for _ in range(3):
            t = _now()
            model.prefill(params16, {"tokens": ptok}, cfg, rt, s_max=LM_SERVE_PROMPT
                          + LM_SERVE_STEPS)
            prefill_s.append(_now() - t)
    # the served run less its prefill, over its decode steps (each with the
    # head product and the argmax)
    decode_ms = (gen_s - min(prefill_s)) / (LM_SERVE_STEPS - 1) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**20

    cli_out, cli_err = cli.communicate(timeout=600)
    cli_lines = cli_out.splitlines()
    check(cli.returncode == 0 and any(ln.startswith("generated (4, 32) tokens")
                                      for ln in cli_lines),
          f"lm: the command line exited {cli.returncode}: {cli_out[-2000:]} {cli_err[-2000:]}")
    for name, counts in (("teacher forcing", launched), ("served", served_launches)):
        check(not any(counts.values()), f"lm {name}: kernels launched on a plain-torch path")
    emit({"phase": "lm", "seconds": _now() - t0, "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "params": count_params(cfg), "init_s": lm["init_s"],
          "teacher_forcing_f32": tf32, "teacher_forcing_bf16": tf16,
          "card_vs_cpu_f32_rel": cpu_rel, "card_vs_cpu_s": cpu_s, "served": {
              "batch": LM_SERVE_BATCH, "prompt": LM_SERVE_PROMPT, "steps": LM_SERVE_STEPS,
              "generate_s": gen_s, "tokens_per_s": LM_SERVE_BATCH * LM_SERVE_STEPS / gen_s,
              "prefill_s": prefill_s, "prefill_tokens_per_s":
                  LM_SERVE_BATCH * LM_SERVE_PROMPT / min(prefill_s),
              "decode_ms_per_step": decode_ms,
              "decode_tokens_per_s": LM_SERVE_BATCH / decode_ms * 1e3,
              "sample": out[0, :16].tolist()},
          "peak_device_mib": peak, "launches": launched, "cli": cli_lines})


def phase_knn_store(lm: dict, params16: dict, dev) -> dict:
    """The kNN-LM's datastore: the bf16 forward (weights `params16`, the
    `train` phase's) final hidden states (d = 2048, f32) over one
    SyntheticTokenPipeline batch (step 0, which training never sees) and
    their next tokens, indexed by the host bulk builder
    (KnnLM.build_from_hidden), which launches no kernel."""
    import torch

    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.dist.sharding import Runtime
    from repro_torch.models import model
    from repro_torch.retrieval.knn_lm import KnnLM

    t0 = _now()
    cfg = lm["cfg"]
    rt = Runtime()
    d = cfg.d_model
    batch = SyntheticTokenPipeline(cfg, KNN_BATCH, KNN_SEQ, seed=0, device=dev).batch(0)
    t_data = _now() - t0
    t = _now()
    hidden = torch.empty((KNN_BATCH * KNN_SEQ, d), dtype=torch.float32, device=dev)
    with torch.no_grad():
        for i in range(0, KNN_BATCH, KNN_MICRO):
            h = model.forward_train(params16, {"tokens": batch["tokens"][i:i + KNN_MICRO]},
                                    cfg, rt)
            hidden[i * KNN_SEQ:(i + KNN_MICRO) * KNN_SEQ] = h.reshape(-1, d).float()
    values = batch["labels"].reshape(-1)
    t_fwd = _now() - t
    check(bool(hidden.isfinite().all()), "knn_store: datastore hidden states not finite")
    t = _now()
    knn, launched = counted(KnnLM.build_from_hidden, hidden, values, cfg.vocab_size, m=KNN_M,
                            k=KNN_K, lam=KNN_LAM)
    t_build = _now() - t
    check(not any(launched.values()), f"knn_store: the host bulk build launched {launched}")
    times = {"data_s": t_data, "forward_s": t_fwd, "build_s": t_build}
    emit({"phase": "knn_store", "seconds": _now() - t0, "n": hidden.shape[0], "d": d,
          "m": KNN_M, "datastore_mib": hidden.numel() * 4 / 2**20,
          "index_mib": knn.index.index_size_bytes() / 2**20, **times})
    return {"knn": knn, "hidden": hidden, "values": values,
            "tokens": batch["tokens"].reshape(-1).long(), **times}


def phase_knn_lm(lm: dict, params16: dict, store: dict, dev):
    """kNN-LM over the U-HNSW datastore of the model's own hidden states
    (`phase_knn_store`), with the same weights `params16` (the `train`
    phase's). T at each p is the median distance
    from 256 stored states to their nearest other stored state (exact).
    Memorized continuations: those 256 states as queries, at each KNN_MEM_P:
    the share whose p_kNN argmax is the stored next token and recall@8
    against an exact top-8, each held to KNN_FLOOR and to the same run with
    the kernels' plain versions (within MAX_RECALL_GAP), and the mixed NLL
    of the stored tokens, which must beat the LM's. Held-out NLL: the first
    KNN_QUERIES positions of pipeline step 1 at each KNN_NLL_P, counted
    (gather_lp, gather_lp_abandon at d = 2048), with a sample of the calls
    held against the plain versions; the mixed NLL must stay within the
    log(1 / (1 - lam)) that mixing can cost, and is reported beside the
    neighbours' share of the query's current token and of the gold token.
    Then the two kernels timed at this width."""
    import torch

    from repro_torch.core.hnsw import exact_topk
    from repro_torch.core.metrics import base_metric_for
    from repro_torch.core.uhnsw import recall
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.dist.sharding import Runtime
    from repro_torch.kernels.ops import pick_abandon_block_d
    from repro_torch.models import model

    t0 = _now()
    rt = Runtime()
    cfg = lm["cfg"]
    d = cfg.d_model
    knn, hidden, values = store["knn"], store["hidden"], store["values"]
    n = hidden.shape[0]

    t = _now()
    probe = torch.arange(0, n, n // KNN_QUERIES, device=dev)[:KNN_QUERIES]
    mem_q, mem_gold = hidden[probe], values[probe]
    truth, temps = {}, {}
    for p in sorted({*KNN_MEM_P, *KNN_NLL_P}):
        ids, dists = exact_topk(hidden, mem_q, p, KNN_K)
        truth[p] = ids
        other = torch.where(ids[:, 0].long() == probe, dists[:, 1], dists[:, 0])
        temps[p] = float(torch.quantile(other ** (1.0 / p), 0.5))
    t_truth = _now() - t

    head = model._head_matrix(params16, cfg)
    with torch.no_grad():
        mem_lm = torch.log_softmax((mem_q.to(torch.bfloat16) @ head)[:, :cfg.vocab_size].float(),
                                   dim=-1)
    rows = torch.arange(KNN_QUERIES, device=dev)
    mem_nll_lm = float(-mem_lm[rows, mem_gold].mean())

    def memorized(p):
        knn.temperature = temps[p]
        ids, dists, _ = knn.index.search(mem_q, p, KNN_K)
        lp = knn.neighbour_logprobs(ids, dists)
        mixed = knn.mix_logprobs(mem_lm, lp)
        return (float((lp.argmax(dim=1) == mem_gold).float().mean()), recall(ids, truth[p]),
                float(-mixed[rows, mem_gold].mean()))

    t = _now()
    mem = {}
    for p in KNN_MEM_P:
        share, rec, nll_mixed = memorized(p)
        with plain_versions():
            share_plain, rec_plain, _ = memorized(p)
        mem[str(p)] = {"T": temps[p], "memorized_share": share, "recall@8": rec,
                       "memorized_share_plain": share_plain, "recall@8_plain": rec_plain,
                       "nll_knn_lm": nll_mixed}
        check(nll_mixed < mem_nll_lm, f"knn_lm p={p}: mixed NLL {nll_mixed} of the memorized "
                                      f"continuations not below the LM's {mem_nll_lm}")
        floor_share, floor_rec = KNN_FLOOR[p]
        check(abs(share - share_plain) <= MAX_RECALL_GAP and abs(rec - rec_plain)
              <= MAX_RECALL_GAP, f"knn_lm p={p}: kernels {share}, {rec} vs plain "
                                 f"{share_plain}, {rec_plain}")
        check(share >= floor_share and rec >= floor_rec,
              f"knn_lm p={p}: memorized share {share} / recall@8 {rec} under the floor "
              f"{KNN_FLOOR[p]}")
    t_mem = _now() - t

    held = SyntheticTokenPipeline(cfg, 1, KNN_QUERIES, seed=0, device=dev).batch(1)
    with torch.no_grad():
        hq = model.forward_train(params16, {"tokens": held["tokens"]}, cfg, rt)[0]
        lm_lp = torch.log_softmax(
            (hq @ model._head_matrix(params16, cfg))[:, :cfg.vocab_size].float(), dim=-1)
    hq = hq.float().contiguous()
    gold = held["labels"][0].long()
    cur = held["tokens"][0].long()
    store_tok = store["tokens"]
    nll_lm = float(-lm_lp[rows, gold].mean())

    def held_out():
        out = {}
        for p in KNN_NLL_P:
            knn.temperature = temps[p]
            ids, dists, _ = knn.index.search(hq, p, KNN_K)
            knn_lp = knn.neighbour_logprobs(ids, dists)
            mixed = knn.mix_logprobs(lm_lp, knn_lp)
            # at the reference's default T = 1 every weight of such a query
            # underflows the normaliser's 1e-30 floor (finding 2)
            under = torch.exp(-dists.double()).sum(dim=1) < 1e-30
            nbr = ids.long()
            out[str(p)] = {"T": temps[p], "nll_knn_lm": float(-mixed[rows, gold].mean()),
                           "nll_knn_only": float(-knn_lp[rows, gold].mean()),
                           "gold_in_neighbours_share":
                               float((values[nbr] == gold[:, None]).any(dim=1).float().mean()),
                           "same_current_token_share":
                               float((store_tok[nbr] == cur[:, None]).float().mean()),
                           "nearest_dist_median": float(dists[:, 0].median()),
                           "weights_underflow_share_at_T1": float(under.float().mean())}
        return out

    t = _now()
    with sampled_kernels() as samples:
        nll, launched = counted(held_out)
    t_nll = _now() - t
    best = min(nll, key=lambda p: nll[p]["nll_knn_lm"])
    # mixing keeps (1 - lam) of the LM's probability, so it costs at most
    # log(1 / (1 - lam)) nats a token whatever the neighbours are
    check(all(r["nll_knn_lm"] <= nll_lm - np.log(1 - KNN_LAM) + 1e-6 for r in nll.values()),
          f"knn_lm: a held-out mixed NLL above the LM's {nll_lm} + log(1 / (1 - lam)): {nll}")
    check_launched(launched, ("gather_lp", "gather_lp_abandon"), "knn_lm held-out run")
    check(all(samples[name] for name in ("gather_lp", "gather_lp_abandon")),
          "knn_lm: a kernel with no call held against its plain version")
    check(all(c["d"] == d for calls in samples.values() for c in calls),
          "knn_lm: a sampled call not at the model's width")

    t = _now()
    bd = pick_abandon_block_d(d)
    kernel_rows = []
    for p in KNN_TIMED_P:
        base = base_metric_for(p)
        c = knn.index.search_stage_candidates(hq, base, KNN_K)
        kernel_rows.append(path_kernel_row(hq, knn.index.X, c, p, base, bd, str(p), k=KNN_K)[0])
    t_kernels = _now() - t
    emit({"phase": "knn_lm", "seconds": _now() - t0, "n": n, "d": d, "k": KNN_K,
          "lam": KNN_LAM, "truth_s": t_truth,
          "memorized_s": t_mem, "held_out_s": t_nll, "kernels_s": t_kernels,
          "memorized": mem, "memorized_nll_lm": mem_nll_lm, "nll_lm": nll_lm,
          "held_out": nll, "best_p": best,
          "launches": launched, "sampled_calls": samples, "kernel_rows": kernel_rows})
    return launched, kernel_rows


TRAIN_BATCH, TRAIN_SEQ = 8, 512    # the global batch of every training step
TRAIN_START = 2          # pipeline steps 0 and 1 are knn_store's and knn_lm's batches
TRAIN_STEPS = 20         # the loss rule holds with a margin of 1.8 after 40 steps and
#                          of 1.5 after 20 (PERF.md §6)
TRAIN_LOSS_DROP = 0.3    # tests/test_train_features.py:44: mean of the last 5 losses
#                          below the mean of the first 5 less this
TRAIN_MB_ATOL = 2e-2     # tests/test_train_features.py:67: microbatches, bf16 params
TRAIN_GRAD_TOKENS = 64   # loss_fn's gradients on the card against the CPU, f32, B = 1,
TRAIN_CUT_LAYERS = 2     # on the first 2 of the 22 layers; the checkpoint round trip
#                          holds the state of the same layers, embedding and head
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-4    # each gradient leaf within this share of its largest magnitude
FLASH_B, FLASH_S, FLASH_KV, FLASH_G, FLASH_HD = 2, 2048, 4, 8, 64   # tinyllama's heads
FLASH_TOL = 1e-4         # dq, dk, dv within this share of each one's largest magnitude
TRAIN_CLI = ("--arch", LM_ARCH, "--smoke", "--steps", "12", "--batch", "4", "--seq", "32",
             "--save-every", "5", "--log-every", "1")
TRAIN_CLI_FAIL_AT = 7
TRAIN_CLI_ATOL = 1e-2    # tests/test_train_features.py's crash-resume rule
# a command that exits 3 the first time (leaving its marker file), then 0
FAILS_ONCE = ("import pathlib, sys; p = pathlib.Path(sys.argv[1]); "
              "sys.exit(0 if p.exists() else (p.touch() or 3))")


def _bits(t):
    """A tensor's bits, comparable with torch.equal (bf16 as int16)."""
    import torch

    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _split(batch: dict, mb: int) -> dict:
    return {k: a.reshape(mb, a.shape[0] // mb, *a.shape[1:]) for k, a in batch.items()}


def _leaf_max_err(got, want) -> float:
    """The largest over leaves of max |got - want| / max |want|."""
    from repro_torch.tree import leaves

    worst = 0.0
    for a, b in zip(leaves(got), leaves(want), strict=True):
        worst = max(worst, float((a.float() - b.float()).abs().max())
                    / max(float(b.float().abs().max()), 1e-30))
    return worst


def flash_backward_check(dev) -> dict:
    """The flash backward alone at the model's attention shape (B 2, S 2048,
    32 / 4 heads, hd 64, f32, chunks of 512: the causal chunk skipping runs)
    against autograd through a plain causal softmax attention that
    materialises its (B, H, S, S) scores."""
    import torch

    from repro_torch.models import attention as attn

    b, s, kv, g, hd = FLASH_B, FLASH_S, FLASH_KV, FLASH_G, FLASH_HD
    gen = torch.Generator(device=dev).manual_seed(1)
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev) for shape in (
        (b, s, kv * g, hd), (b, s, kv, hd), (b, s, kv, hd), (b, s, kv * g, hd)))
    for t in (q, k, v):
        t.requires_grad_()
    _sync()
    t = _now()
    out = attn.flash_attention(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), do)
    _sync()
    flash_s = _now() - t
    # head h reads KV head h // g, as the (KV, G) reshape of the flash form
    ke, ve = (x.repeat_interleave(g, dim=2) for x in (k, v))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, ke) * hd ** -0.5
    causal = torch.ones((s, s), dtype=torch.bool, device=dev).tril()
    probs = torch.softmax(scores.masked_fill(~causal, -torch.inf), dim=-1)
    plain = torch.einsum("bhqk,bkhd->bqhd", probs, ve)
    want = torch.autograd.grad(plain, (q, k, v), do)
    errs = {name: float((a - w).abs().max() / w.abs().max())
            for name, a, w in zip(("dq", "dk", "dv"), grads, want)}
    out_err = float((out - plain).detach().abs().max() / plain.detach().abs().max())
    check(all(e <= FLASH_TOL for e in errs.values()) and out_err <= FLASH_TOL,
          f"train: the flash backward against plain autograd: {errs}, out {out_err}")
    return {"shape": [b, s, kv * g, kv, hd], "chunks": 512, "rel_err": errs,
            "out_rel_err": out_err, "flash_fwd_bwd_s": flash_s}


def first_layers(params: dict, cfg, n: int):
    """cfg cut to its first n layers, and params' leaves for them: the
    embedding, head and norms whole, and the first segment's stacked layer
    leaves sliced (views). The first segment must hold those n layers."""
    from repro_torch.models.params import layer_plan

    cut = cfg.with_overrides(n_layers=n)
    (unit, r), = layer_plan(cut)
    (unit0, r0) = layer_plan(cfg)[0]
    check(unit == unit0 and r <= r0, f"the first {n} layers of {cfg.name} span segments")
    sub = {k: v for k, v in params.items() if k != "segments"}
    sub["segments"] = [{"blocks": _tree_map(lambda t: t[:r], params["segments"][0]["blocks"])}]
    return cut, sub


def grads_card_vs_cpu(cfg, params32: dict, batch: dict, label: str) -> dict:
    """loss_fn's loss and gradients on the card against the CPU, f32 weights
    and a batch on the card: the loss within TRAIN_LOSS_RTOL relative and
    each gradient leaf within TRAIN_GRAD_TOL of its largest magnitude."""
    from repro_torch.dist.sharding import Runtime
    from repro_torch.train.step import TrainConfig, make_train_step

    compute = make_train_step(cfg, Runtime(), TrainConfig()).compute_grads
    t0 = _now()
    g_card, m_card = compute(params32, batch)
    _sync()
    card_s = _now() - t0
    t = _now()
    g_card = _tree_map(lambda t: t.cpu(), g_card)
    params_cpu = _tree_map(lambda t: t.cpu(), params32)
    copy_s = _now() - t
    t = _now()
    g_cpu, m_cpu = compute(params_cpu, {k: a.cpu() for k, a in batch.items()})
    cpu_s = _now() - t
    del params_cpu
    loss_rel = abs(float(m_card["loss"]) - float(m_cpu["loss"])) / abs(float(m_cpu["loss"]))
    grad_err = _leaf_max_err(g_card, g_cpu)
    check(loss_rel <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_GRAD_TOL,
          f"{label}: card against CPU: loss {loss_rel}, gradients {grad_err}")
    return {"layers": cfg.n_layers, "batch": list(batch["tokens"].shape),
            "loss": float(m_cpu["loss"]), "loss_rel_err": loss_rel,
            "grad_max_rel_err": grad_err, "card_s": card_s, "copy_s": copy_s, "cpu_s": cpu_s,
            "seconds": _now() - t0}


def compression_check(state: dict, batch: dict, cfg, rt, tc) -> dict:
    """One step with grad_compression, from `state` (a copy; it is
    changed): the gradients, their compression from a nonzero error buffer
    (the first compression's), and the AdamW update, as the train step runs
    them; new_err must equal (g + e) - deq bit for bit, deq being the int8
    values times the leaf's scale. Then the train step itself with
    compression: its loss, grad norm and error buffers finite."""
    import torch

    from repro_torch.optim.adamw import adamw_update, cosine_schedule
    from repro_torch.train.compression import compress_decompress_grads, compression_init
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import leaves

    t = _now()
    step_c = make_train_step(cfg, rt, tc)
    grads, _ = step_c.compute_grads(state["params"], batch)
    _, err = compress_decompress_grads(grads, compression_init(state["params"]))
    deq, new_err = compress_decompress_grads(grads, err)
    exact = True
    for g, e, d, ne in zip(leaves(grads), leaves(err), leaves(deq), leaves(new_err)):
        g32 = g.float() + e
        scale = torch.clamp_min(g32.abs().max(), 1e-12) / 127.0
        q = torch.clamp(torch.round(g32 / scale), -127, 127)
        deq32 = q * scale
        exact &= bool(torch.equal(ne, g32 - deq32)) and bool(torch.equal(d, deq32.to(d.dtype)))
    check(exact, "train: compression's new_err != (g + e) - deq")
    _, opt, om = adamw_update(state["params"], deq, state["opt"],
                              cosine_schedule(tc.lr, tc.warmup_steps, tc.total_steps))
    state["opt"] = opt
    del grads, deq
    state["err"] = new_err
    state, m = step_c(state, batch)
    err_max = max(float(e.abs().max()) for e in leaves(state["err"]))
    ok = all(np.isfinite(float(m[k])) for k in ("loss", "grad_norm")) and np.isfinite(err_max)
    check(ok, f"train: the compressed step: {m}, err {err_max}")
    return {"exact": exact, "grad_norm": float(om["grad_norm"]),
            "step_loss": float(m["loss"]), "step_grad_norm": float(m["grad_norm"]),
            "err_abs_max": err_max, "seconds": _now() - t}


def phase_train(lm: dict, dev) -> dict:
    """Training at LM_ARCH's full width: bf16 parameters from
    init_train_state (a torch.Generator seeded 0), f32 moments, the command
    line's TrainConfig (lr 3e-4, warm-up TRAIN_STEPS // 10, a cosine over
    the run), TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens from
    make_batch_iterator(seed 0, start_step TRAIN_START). The first step's
    batch also goes through one step with microbatches=2 from a copy of the
    state, and that copy then through the compression check. Then the
    reference's loss rule, loss_fn's gradients card against CPU on the
    first TRAIN_CUT_LAYERS layers (`grads_card_vs_cpu`), the flash backward
    alone (`flash_backward_check`) and a checkpoint round trip of the
    embedding's, head's, final norm's and first TRAIN_CUT_LAYERS layers'
    state (AsyncCheckpointer, restore_checkpoint: bitwise). Plain torch: no kernel of the repo launches, which the counts
    show. Returns the trained bf16 parameters; drops the moments."""
    import torch

    from repro_torch.checkpoint.store import AsyncCheckpointer, restore_checkpoint
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.dist.sharding import Runtime
    from repro_torch.kernels import lp_distance as kd
    from repro_torch.train.step import TrainConfig, init_train_state, make_train_step
    from repro_torch.tree import leaves

    t0 = _now()
    cfg, rt = lm["cfg"], Runtime()
    tc = TrainConfig(lr=3e-4, warmup_steps=max(TRAIN_STEPS // 10, 1), total_steps=TRAIN_STEPS)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, rt, tc, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    step_fn = make_train_step(cfg, rt, tc)
    batches = make_batch_iterator(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, start_step=TRAIN_START,
                                  device=dev)
    first_step, batch = next(batches)
    first_batch = batch
    _sync()
    setup_s = _now() - t0
    kd.reset_launch_counts()

    t = _now()
    copy = _tree_map(lambda x: x.clone(), state)
    copy, _ = make_train_step(cfg, rt, replace(tc, microbatches=2))(copy, _split(batch, 2))
    _sync()
    mb_s = _now() - t

    losses, gnorms, step_s = [], [], []
    for i in range(TRAIN_STEPS):
        t = _now()
        state, m = step_fn(state, batch)
        if i + 1 < TRAIN_STEPS:
            _, batch_next = next(batches)      # made on the host while the card works
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        step_s.append(_now() - t)
        if i == 0:
            mb_err = max(float((a.float() - b.float()).abs().max())
                         for a, b in zip(leaves(state["params"]), leaves(copy["params"])))
            check(mb_err <= TRAIN_MB_ATOL, f"train: microbatches=2 against 1: params {mb_err}")
            comp = compression_check(copy, batch, cfg, rt, replace(tc, grad_compression=True))
            del copy
        if i + 1 < TRAIN_STEPS:
            batch = batch_next
    launched = kd.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**20
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"train: a loss or grad norm not finite: {losses} {gnorms}")
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(last5 < first5 - TRAIN_LOSS_DROP,
          f"train: the mean of the last 5 losses {last5} not below the first 5's {first5} "
          f"less {TRAIN_LOSS_DROP}: {losses}")
    check(not any(launched.values()), f"train: kernels launched on a plain-torch path: {launched}")
    med = float(np.median(step_s))

    ck_dir = Path(__file__).resolve().parent / "build" / "smoke_train_ckpt"
    shutil.rmtree(ck_dir, ignore_errors=True)
    ck = AsyncCheckpointer(ck_dir)
    # the state of the embedding, head, final norm and first layers, at
    # full width (views of the trained state)
    ck_state = {"params": first_layers(state["params"], cfg, TRAIN_CUT_LAYERS)[1],
                "opt": {"m": first_layers(state["opt"]["m"], cfg, TRAIN_CUT_LAYERS)[1],
                        "v": first_layers(state["opt"]["v"], cfg, TRAIN_CUT_LAYERS)[1],
                        "step": state["opt"]["step"]}}
    t = _now()
    ck.save(TRAIN_STEPS - 1, ck_state)
    snapshot_s = _now() - t
    # beside the checkpoint's writer thread: the gradients and the flash backward
    cut, params_cut = first_layers(lm["params32"], cfg, TRAIN_CUT_LAYERS)
    card_cpu = grads_card_vs_cpu(cut, params_cut, {k: a[:1, :TRAIN_GRAD_TOKENS]
                                                   for k, a in first_batch.items()}, "train")
    del params_cut
    flash = flash_backward_check(dev)
    ck.wait()
    save_s = _now() - t
    nbytes = sum(f.stat().st_size for f in ck_dir.rglob("*") if f.is_file())
    t = _now()
    restored, step = restore_checkpoint(ck_dir, ck_state, dev)
    _sync()
    restore_s = _now() - t
    bitwise = step == TRAIN_STEPS - 1 and all(
        torch.equal(_bits(a), _bits(b)) for a, b in zip(leaves(restored), leaves(ck_state),
                                                      strict=True))
    check(bitwise, "train: the restored checkpoint differs from the state")
    del restored, ck_state
    shutil.rmtree(ck_dir)

    emit({"phase": "train", "seconds": _now() - t0, "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
          "first_pipeline_step": first_step, "lr": tc.lr, "warmup": tc.warmup_steps,
          "setup_s": setup_s, "losses_first5": losses[:5], "losses_last5": losses[-5:],
          "losses": losses, "mean_first5": first5, "mean_last5": last5,
          "grad_norms": gnorms, "step_s_median": med, "step_s_max": max(step_s),
          "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med, "peak_device_mib": peak,
          "microbatches_2": {"max_abs_param_diff": mb_err, "seconds": mb_s},
          "compression": comp, "card_vs_cpu": card_cpu, "flash_backward": flash,
          "checkpoint": {"layers": TRAIN_CUT_LAYERS, "bytes": nbytes,
                         "snapshot_s": snapshot_s, "save_s": save_s,
                         "restore_s": restore_s, "bitwise": bitwise},
          "launches": launched})
    params = state["params"]
    del state
    return params


DRYRUN_CELLS = (("tinyllama_1_1b", "train_4k", ("--optimized",)),
                ("qwen2_5_32b", "decode_32k", ()))
DRYRUN_PEAK_RTOL = 0.10   # the dry-run's peak against the card's, of the card's
DRYRUN_TIMEOUT = 600


def start_dryruns() -> dict:
    """`python -m repro_torch.launch.dryrun` on each of DRYRUN_CELLS (the
    production 16 x 16 mesh over a fake group, on the host), started
    beside the LM paths; `finish_dryruns` reads them."""
    import tempfile

    root = Path(__file__).resolve().parent
    out = Path(tempfile.mkdtemp(prefix="smoke_dryrun_"))
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    procs = []
    for arch, shape, extra in DRYRUN_CELLS:
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
             *extra, "--out", str(out)], cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    return {"procs": procs, "out": out, "t0": time.perf_counter()}


def phase_dryrun(lm: dict, dev) -> dict:
    """The dry-run of the train phase's own step (LM_ARCH, TRAIN_BATCH x
    TRAIN_SEQ, its TrainConfig, no mesh) against one real step of a fresh
    state on the card: the predicted peak (arguments + temp) within
    DRYRUN_PEAK_RTOL of the step's, which is the card's peak allocation
    after `reset_peak_memory_stats` less what the process held beside the
    step's arguments when it started. Prints the predicted flops and
    roofline terms beside the step's time and its share of the bf16 peak
    (not gated). Returns the figures for `finish_dryruns`."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.dist.sharding import Runtime
    from repro_torch.launch import dryrun
    from repro_torch.train.step import TrainConfig, init_train_state, make_train_step
    from repro_torch.tree import leaves

    t0 = _now()
    cfg, rt = lm["cfg"], Runtime()
    tc = TrainConfig(lr=3e-4, warmup_steps=max(TRAIN_STEPS // 10, 1), total_steps=TRAIN_STEPS)
    cost, trace_s = dryrun.trace(cfg, ShapeConfig("smoke_train", TRAIN_SEQ, TRAIN_BATCH,
                                                  "train"), rt, train_config=tc)
    pd = cost.report()
    predicted = pd["argument_bytes"] + pd["temp_bytes"]
    state = init_train_state(cfg, rt, tc, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    _, batch = next(make_batch_iterator(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0,
                                        start_step=TRAIN_START, device=dev))
    step = make_train_step(cfg, rt, tc)
    _sync()
    args = sum(t.numel() * t.element_size() for t in leaves((state, batch)))
    beside = torch.cuda.memory_allocated() - args
    torch.cuda.reset_peak_memory_stats()
    t = _now()
    state, _ = step(state, batch)
    _sync()
    step_s = _now() - t
    card_peak = torch.cuda.max_memory_allocated()
    measured = card_peak - beside
    del state, batch
    gap = (predicted - measured) / measured
    rf = dryrun.roofline(pd)
    out = {"arch": cfg.name, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "trace_s": trace_s,
           "ops": cost.ops, "argument_bytes": pd["argument_bytes"],
           "temp_bytes": pd["temp_bytes"], "predicted_peak_bytes": predicted,
           "card_peak_bytes": card_peak, "held_beside_bytes": beside,
           "measured_peak_bytes": measured, "peak_gap": gap, "argument_bytes_card": args,
           "flops": pd["flops"], "bytes_accessed": pd["bytes_accessed"],
           "bytes_min": pd["bytes_min"], "roofline_seconds": rf, "step_s": step_s,
           "bf16_peak_share": pd["flops"] / step_s / dryrun.PEAK_FLOPS,
           "seconds": _now() - t0}
    check(args == pd["argument_bytes"],
          f"dryrun: arguments {pd['argument_bytes']} predicted, {args} on the card")
    check(abs(gap) <= DRYRUN_PEAK_RTOL, f"dryrun: the predicted peak is off: {out}")
    return out


def finish_dryruns(runs: dict, peak: dict) -> None:
    """Waits for `start_dryruns`' cells: each must exit 0 with status ok;
    prints the `dryrun` line with their per-device figures beside
    `phase_dryrun`'s."""
    cells = []
    for (arch, shape, extra), proc in zip(DRYRUN_CELLS, runs["procs"]):
        out, err = proc.communicate(timeout=DRYRUN_TIMEOUT)
        check(proc.returncode == 0, f"dryrun {arch} x {shape} exited {proc.returncode}: "
              f"{err[-3000:]}")
        r = json.loads((runs["out"] / f"{arch}__{shape}__16x16.json").read_text())
        check(r["status"] == "ok", f"dryrun {arch} x {shape}: {r}")
        cells.append({"arch": arch, "shape": shape, "flags": list(extra), "mesh": r["mesh"],
                      "per_device": r["per_device"], "collectives": r["collectives"],
                      "roofline_seconds": r["roofline_seconds"], "trace_s": r["trace_s"]})
    shutil.rmtree(runs["out"], ignore_errors=True)
    emit({"phase": "dryrun", "train_step": peak, "cells": cells,
          "cells_read_after_s": time.perf_counter() - runs["t0"]})


def start_train_cli() -> dict:
    """The training command line (TRAIN_CLI, on the card) three ways on a
    thread: uninterrupted, and beside it a run that crashes at step
    TRAIN_CLI_FAIL_AT and then its resumption from the same checkpoint
    directory; then the supervisor around FAILS_ONCE. Started at the start
    of the LM paths; `phase_train_cli` reads it."""
    import threading

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    work = root / "build" / "smoke_train_cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    base = [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_CLI]
    runs: dict = {}
    procs: list = []
    stop = threading.Event()

    def run(name, cmd):
        if stop.is_set():
            raise RuntimeError(f"stopped before {name}")
        t = _now()
        p = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
        procs.append(p)
        out, err = p.communicate(timeout=600)
        runs[name] = {"rc": p.returncode, "out": out, "err": err, "s": _now() - t}

    def crash_then_resume():
        run("crash", base + ["--ckpt-dir", str(work / "ft"),
                             "--fail-at-step", str(TRAIN_CLI_FAIL_AT)])
        run("resumed", base + ["--ckpt-dir", str(work / "ft"), "--metrics-out",
                               str(work / "ft.json")])

    def all_runs():
        try:
            with ThreadPoolExecutor(2) as pool:
                futures = [pool.submit(run, "uninterrupted", base + [
                    "--ckpt-dir", str(work / "ref"), "--metrics-out", str(work / "ref.json")]),
                    pool.submit(crash_then_resume)]
                for f in futures:
                    f.result()
            run("supervisor", [sys.executable, "-m", "repro_torch.launch.supervisor",
                               "--retries", "2", "--backoff", "0.1", "--", sys.executable,
                               "-c", FAILS_ONCE, str(work / "marker")])
        except Exception as e:  # read by phase_train_cli
            runs["error"] = repr(e)

    thread = threading.Thread(target=all_runs)
    thread.start()
    return {"thread": thread, "runs": runs, "procs": procs, "stop": stop, "work": work,
            "t0": _now()}


def phase_train_cli(cli: dict) -> None:
    """Reads `start_train_cli`'s runs: the uninterrupted run exits 0, the
    crashing one 42 at TRAIN_CLI_FAIL_AT, the resumed one 0 with `resumed
    from step 4` and its last 3 losses within TRAIN_CLI_ATOL of the
    uninterrupted run's; the supervisor restarts FAILS_ONCE once and exits
    0."""
    t0 = _now()
    cli["thread"].join(timeout=600)
    runs, work = cli["runs"], cli["work"]
    check(not cli["thread"].is_alive() and "error" not in runs, f"train_cli: {runs.get('error')}")
    for name, rc in (("uninterrupted", 0), ("crash", 42), ("resumed", 0), ("supervisor", 0)):
        r = runs[name]
        check(r["rc"] == rc, f"train_cli {name} exited {r['rc']}: {r['out'][-2000:]} "
                             f"{r['err'][-2000:]}")
    check(f"FAULT-INJECTION: crashing at step {TRAIN_CLI_FAIL_AT}" in runs["crash"]["out"],
          "train_cli: the crash run did not inject its fault")
    check("resumed from step 4" in runs["resumed"]["out"], "train_cli: no `resumed from step 4`")
    ref = json.loads((work / "ref.json").read_text())["losses"]
    ft = json.loads((work / "ft.json").read_text())["losses"]
    diff = float(np.abs(np.asarray(ft[-3:]) - np.asarray(ref[-3:])).max())
    check(len(ref) == 12 and len(ft) == 7 and diff <= TRAIN_CLI_ATOL,
          f"train_cli: resumed losses {ft} against {ref}")
    sup = runs["supervisor"]["out"]
    check("exit code 3" in sup and "success after 1 restarts" in sup,
          f"train_cli: the supervisor did not restart once: {sup}")
    shutil.rmtree(work)
    emit({"phase": "train_cli", "seconds": _now() - t0, "beside_s": _now() - cli["t0"],
          "run_s": {name: r["s"] for name, r in runs.items()},
          "losses_uninterrupted": ref, "losses_resumed": ft, "max_abs_diff_last3": diff,
          "resumed_line": next(ln for ln in runs["resumed"]["out"].splitlines()
                               if ln.startswith("resumed")),
          "supervisor": sup.splitlines()})


KINDS_FLAG = "--lm-kinds"
KINDS_TIMEOUT = 600
# teacher forcing of the other block kinds at full width, f32: arch ->
# (layers kept, None for all; batch; prefill; decode steps; forward length,
# a multiple of the flash / SSD chunks past the decoded positions)
KINDS_TF = {
    "deepseek_v3_671b": (4, 1, 256, 64, 320),        # the 3 mla+ffn and the first mla+moe
    "llama4_scout_17b_a16e": (2, 2, 256, 64, 320),   # 2 of 48 gqa+moe
    "recurrentgemma_2b": (None, 2, 2560, 64, 3072),  # all 26: the 2,048 ring filled, wrapped
    "mamba2_1_3b": (None, 2, 1024, 64, 1152),        # all 48: chunks of 128
}
# MoE teacher forcing at capacity factor E / top_k: cap = t, no route can
# drop. The JAX smoke configs' 8.0 drops at full width (the drops it would
# make are printed beside, `moe_drops_at_8`): at random init the router
# sends most tokens to a few experts
KINDS_SMOKE_CAPACITY = 8.0
KINDS_TF_MAX_ERR = 1e-3    # tests/test_serve_consistency.py's f32 rule
KINDS_TF_MIN_AGREE = 0.99
KINDS_CAP_BATCH, KINDS_CAP_SEQ = 2, 512   # one prefill at the published capacity (1.25)
KINDS_GRADS = {"recurrentgemma_2b": (3, 128), "mamba2_1_3b": (1, 256)}   # layers, tokens; B 1
KINDS_SERVE_BATCH, KINDS_SERVE_PROMPT, KINDS_SERVE_STEPS = 8, 128, 33   # bf16, greedy
# the mesh (path 16) on the (1, 1) NCCL mesh, against the mesh-free calls
MESH_MOE_TOL = 1e-6        # moe_forward on the mesh, of the largest magnitude (f32)
MESH_DECODE_B = 8          # _moe_decode_gather's tokens (B 8, S 1)
MESH_DECODE_TOL = 1e-5
MESH_TRAIN = (8, 512, 3, 2)   # batch, seq, steps, microbatches: tinyllama_1_1b in f32
MESH_STEP_RTOL = 1e-6      # losses and grad norms (read: bit for bit)
MESH_TP_TOL = 1e-6
MESH_SERVE = (8, 128, 32)  # bf16 ServeEngine: batch, prompt, steps
# the sharded layouts on a (1, 2) mesh: two processes on the one card over
# gloo (NCCL refuses two ranks on one device; gloo carries every collective
# these layouts use on CUDA tensors, staged through the host), against the
# mesh-free path at tinyllama_1_1b's full width, f32
SPLIT_TRAIN_RTOL = 1e-4    # losses and grad norms: f32 sums over 'model' in another
#                            order, and the int8 compression's rounding can move an
#                            element of a gradient by one step
SPLIT_DECODE = (4, 32, 64, 128)   # batch, prefill, decode steps, cache slots: the rank
#                                   boundary at slot 64 is crossed at step 32
SPLIT_LOGP_TOL = 1e-3      # the decode's log-probs against the full forward (f32)
SPLIT_LAYERS = 4           # depth cut to 4 of 22 (full width): gloo stages every
#                            collective through the host, ~1 s a decode step at 22
SPLIT_TIMEOUT = 420
MESH_CKPT_LAYERS = 1       # the checkpoint's cut: the parameters of the embedding, head,
#                            final norm and layer 0 (with the moments, 2.10 GB, the
#                            part took 47.69 s of its 40)


@contextmanager
def moe_calls():
    """Records (params, x) of every `models.ffn.moe_forward` call made
    inside (the model looks it up at each call)."""
    from repro_torch.models import ffn

    seen, orig = [], ffn.moe_forward

    def recording(params, x, cfg, rt=None):
        seen.append((params, x))
        return orig(params, x, cfg, rt)

    ffn.moe_forward = recording
    try:
        yield seen
    finally:
        ffn.moe_forward = orig


def recount_drops(gate, cap: int):
    """(t, E) bool: the routes past cap, recounted by rank from the combine
    weights without a sort: a route (i, e) is dropped when at least cap
    routes to e weigh more, or as much from a lower token index."""
    import torch

    t, e = gate.shape
    idx = torch.arange(t, device=gate.device)
    out = torch.zeros_like(gate, dtype=torch.bool)
    for e0 in range(0, e, 32):
        g = gate[:, e0:e0 + 32].T                              # (c, t)
        above = (g[:, None, :] > g[:, :, None]) | (
            (g[:, None, :] == g[:, :, None]) & (idx[None, None, :] < idx[None, :, None]))
        out[:, e0:e0 + 32] = ((above & (g[:, None, :] > 0)).sum(-1) >= cap).T & (g.T > 0)
    return out


def chosen_by_rank(probs, k: int):
    """(t, E) bool: the experts each token's router chooses, by rank (higher
    probability, or equal and a lower expert index), without a sort."""
    import torch

    e = probs.shape[1]
    idx = torch.arange(e, device=probs.device)
    out = torch.zeros_like(probs, dtype=torch.bool)
    for e0 in range(0, e, 64):
        p = probs[:, e0:e0 + 64]                                # (t, c)
        above = (probs[:, None, :] > p[:, :, None]) | (
            (probs[:, None, :] == p[:, :, None]) & (idx[None, None, :] < idx[e0:e0 + 64][None, :,
                                                                                    None]))
        out[:, e0:e0 + 64] = above.sum(-1) < k
    return out


def moe_layer_drops(calls, cfg) -> list:
    """Each recorded MoE call's routes: the port's dropped routes
    (`ffn.moe_dropped`, the path's own selection) against `recount_drops`,
    and the router's chosen experts against `chosen_by_rank`."""
    import torch

    from repro_torch.models import ffn
    from repro_torch.models.attention import rmsnorm

    rows = []
    for layer, (params, x) in enumerate(calls):
        h = rmsnorm(x, params["ln"], cfg.norm_eps)
        xt = h.reshape(-1, h.shape[-1])
        cap = ffn._capacity(xt.shape[0], cfg)
        dropped = ffn.moe_dropped(params, h, cfg)
        gate = ffn._route(params["router"], xt, cfg)
        probs = torch.softmax(torch.einsum("td,de->te", xt.float(), params["router"]), dim=-1)
        recount = recount_drops(gate, cap)
        rows.append({"layer": layer, "tokens": xt.shape[0], "cap": cap,
                     "routes": int((gate > 0).sum()), "dropped": int(dropped.sum()),
                     "recount": int(recount.sum()),
                     "equal": bool(torch.equal(dropped, recount)),
                     "router_equal": bool(torch.equal(gate > 0,
                                                      chosen_by_rank(probs, cfg.moe.top_k)))})
    return rows


def mesh_moe(cfg, call, mesh) -> dict:
    """One recorded MoE call (its f32 layer, inputs at the published
    capacity) through the expert-parallel body on the (1, 1) mesh and the
    weights-stationary decode on MESH_DECODE_B of its tokens, against the
    mesh-free calls. The weights are the full ones (no copy): each rank
    slices its experts, here all of them."""
    import torch

    from repro_torch.dist.sharding import Runtime
    from repro_torch.models import ffn
    from repro_torch.models.attention import rmsnorm

    params, x = call
    t0 = _now()
    free, on_mesh = Runtime(), Runtime(mesh=mesh)
    with torch.no_grad():
        want = ffn.moe_forward(params, x, cfg, free)
        got = ffn.moe_forward(params, x, cfg, on_mesh)
        dropped = int(ffn.moe_dropped(params, rmsnorm(x, params["ln"], cfg.norm_eps), cfg).sum())
        err = float((got - want).abs().max() / want.abs().max())
        xd = x.reshape(-1, x.shape[-1])[:MESH_DECODE_B, None, :]
        want_d = ffn.moe_forward(params, xd, cfg, free)
        hd = rmsnorm(xd, params["ln"], cfg.norm_eps)
        got_d = ffn._moe_decode_gather(params, hd, cfg,
                                       Runtime(mesh=mesh, moe_decode_gather=True))
        if cfg.moe.n_shared:
            got_d = got_d + ffn._shared_expert(params, hd, cfg)
        err_d = float((got_d - want_d).abs().max() / want_d.abs().max())
    out = {"tokens": x.shape[0] * x.shape[1], "capacity_factor": cfg.moe.capacity_factor,
           "dropped": dropped, "max_rel_err": err, "bit_equal": bool(torch.equal(got, want)),
           "decode_tokens": MESH_DECODE_B, "decode_max_rel_err": err_d,
           "decode_bit_equal": bool(torch.equal(got_d, want_d)), "seconds": _now() - t0}
    check(err <= MESH_MOE_TOL and dropped > 0, f"mesh: {cfg.name} moe_forward on the mesh: {out}")
    check(err_d <= MESH_DECODE_TOL, f"mesh: {cfg.name} _moe_decode_gather: {out}")
    return out


def kinds_model(arch: str, dev, mesh=None) -> dict | None:
    """One arch of the other block kinds at full width (depth KINDS_TF):
    f32 weights from models.init_params (a torch.Generator seeded 0) and
    teacher forcing against the full forward (MoE at capacity factor E /
    top_k, where no route can drop: its drops must be 0, and the drops the
    smoke configs' 8.0 would make on the same calls are printed beside);
    for MoE archs one prefill at the
    published capacity, its drops against the recount; for the recurrent
    archs loss_fn's gradients card against CPU on their first layers; then
    the same weights in bf16 served through ServeEngine.generate at B 8
    (decode ms a step, no limit). Frees the card before it returns."""
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.dist.sharding import Runtime
    from repro_torch.models import model
    from repro_torch.models.params import count_params
    from repro_torch.serve.engine import ServeEngine

    t0 = _now()
    layers, b, s0, dec, s_fwd = KINDS_TF[arch]
    pub = get_arch(arch) if layers is None else get_arch(arch).with_overrides(n_layers=layers)
    cfg = pub if pub.moe is None else pub.with_overrides(
        moe=replace(pub.moe, capacity_factor=pub.moe.num_experts / pub.moe.top_k))
    rt = Runtime()
    free_mib = torch.cuda.mem_get_info()[0] / 2**20
    torch.cuda.reset_peak_memory_stats()
    params = model.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               dtype=torch.float32, device=dev)
    init_s = _now() - t0
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, s_fwd)).astype(
        np.int32)).to(dev)
    with moe_calls() as calls:
        tf, launched = counted(teacher_forcing, params, tokens, cfg, rt, s0, dec)
    drops_free = sum(r["dropped"] for r in moe_layer_drops(calls, cfg))
    drops_8 = None if cfg.moe is None else sum(r["dropped"] for r in moe_layer_drops(
        calls, cfg.with_overrides(moe=replace(cfg.moe, capacity_factor=KINDS_SMOKE_CAPACITY))))
    n_calls = len(calls)
    del calls
    check(drops_free == 0, f"lm_kinds {arch}: {drops_free} routes dropped at capacity "
                           f"{cfg.moe and cfg.moe.capacity_factor}")
    check(tf["max_err"] <= KINDS_TF_MAX_ERR and tf["argmax_agreement"] >= KINDS_TF_MIN_AGREE,
          f"lm_kinds {arch} f32 teacher forcing: {tf}")
    out = {"phase": "lm_kinds", "arch": arch, "n_layers": cfg.n_layers,
           "published_layers": get_arch(arch).n_layers, "d_model": cfg.d_model,
           "params": count_params(cfg), "dtype": "float32", "free_mib_at_start": free_mib,
           "init_s": init_s, "teacher_forcing": {"batch": b, "prefill": s0, "decoded": dec,
                                                  "forward_len": s_fwd, **tf}}
    if cfg.moe is not None:
        out["moe_drop_free_capacity"] = cfg.moe.capacity_factor
        out["moe_drops_at_drop_free_capacity"] = drops_free
        out["moe_calls"] = n_calls
        out["moe_drops_at_8"] = drops_8
        ptok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(
            KINDS_CAP_BATCH, KINDS_CAP_SEQ)).astype(np.int32)).to(dev)
        t = _now()
        with moe_calls() as calls, torch.no_grad():
            model.prefill(params, {"tokens": ptok}, pub, rt)
            rows = moe_layer_drops(calls, pub)
        check(all(r["equal"] and r["router_equal"] for r in rows),
              f"lm_kinds {arch}: dropped routes at capacity {pub.moe.capacity_factor} differ "
              f"from the recount: {rows}")
        out["published_capacity"] = {"capacity_factor": pub.moe.capacity_factor,
                                     "batch": KINDS_CAP_BATCH, "seq": KINDS_CAP_SEQ,
                                     "layers": rows, "seconds": _now() - t}
        # path 16: the first MoE layer's call through the mesh
        mesh_out = mesh_moe(pub, calls[0], mesh) if mesh is not None else None
        del calls
    else:
        mesh_out = None
    if arch in KINDS_GRADS:
        n, s_g = KINDS_GRADS[arch]
        cut, sub = first_layers(params, cfg, n)
        batch = SyntheticTokenPipeline(cut, 1, s_g, seed=0, device=dev).batch(0)
        out["card_vs_cpu"] = grads_card_vs_cpu(cut, sub, batch, f"lm_kinds {arch}")
        del sub
    del params, tokens
    torch.cuda.empty_cache()

    # serving: the same draws in bf16 (init_params rounds the f32 normals)
    params16 = model.init_params(pub, torch.Generator(device=dev).manual_seed(0), device=dev)
    eng = ServeEngine(pub, rt, params16, max_seq=KINDS_SERVE_PROMPT + KINDS_SERVE_STEPS)
    prompts = rng.integers(0, cfg.vocab_size, size=(KINDS_SERVE_BATCH, KINDS_SERVE_PROMPT)
                           ).astype(np.int32)
    eng.generate(prompts, 2)   # warm-up
    t = _now()
    served, served_launches = counted(eng.generate, prompts, KINDS_SERVE_STEPS)
    gen_s = _now() - t
    ptok = torch.from_numpy(prompts).to(dev)
    prefill_s = []
    with torch.no_grad():
        for _ in range(2):
            t = _now()
            model.prefill(params16, {"tokens": ptok}, pub, rt,
                          s_max=KINDS_SERVE_PROMPT + KINDS_SERVE_STEPS)
            prefill_s.append(_now() - t)
    decode_ms = (gen_s - min(prefill_s)) / (KINDS_SERVE_STEPS - 1) * 1e3
    check(served.shape == (KINDS_SERVE_BATCH, KINDS_SERVE_STEPS)
          and bool(((served >= 0) & (served < cfg.vocab_size)).all()),
          f"lm_kinds {arch}: served tokens {served.shape} out of range")
    for name, counts in (("teacher forcing", launched), ("served", served_launches)):
        check(not any(counts.values()), f"lm_kinds {arch} {name}: kernels launched on a "
                                        f"plain-torch path: {counts}")
    out["served_bf16"] = {"batch": KINDS_SERVE_BATCH, "prompt": KINDS_SERVE_PROMPT,
                          "steps": KINDS_SERVE_STEPS, "generate_s": gen_s,
                          "prefill_s": prefill_s, "decode_ms_per_step": decode_ms,
                          "decode_tokens_per_s": KINDS_SERVE_BATCH / decode_ms * 1e3,
                          "sample": served[0, :16].tolist()}
    out["peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
    out["launches"] = launched
    out["seconds"] = _now() - t0
    del eng, params16
    torch.cuda.empty_cache()
    emit(out)
    return mesh_out


def _cut(tree, r: int):
    """The first r layers of a tree of stacked (R, ...) DTensor or tensor
    leaves (a DTensor's local layers, placed as it is)."""
    from torch.distributed.tensor import DTensor

    def one(t):
        if not isinstance(t, DTensor):
            return t[:r]
        loc = t.to_local()[:r]
        return DTensor.from_local(loc, t.device_mesh, t.placements, run_check=False,
                                  shape=(r, *t.shape[1:]), stride=loc.stride())

    return _tree_map(one, tree)


def _params_cut(params: dict, n: int) -> dict:
    """The embedding, head, final norm and first n layers of a parameter
    tree (DTensor or tensor leaves): `train`'s checkpoint cut."""
    sub = {k: v for k, v in params.items() if k != "segments"}
    sub["segments"] = [{"blocks": _cut(params["segments"][0]["blocks"], n)}]
    return sub


def mesh_tinyllama(mesh, dev) -> dict:
    """tinyllama_1_1b at full width on the (1, 1) mesh against the
    mesh-free path: the explicit-TP FFN of layer 0, MESH_TRAIN's f32 steps
    from one initial state placed by `distribute_params` (and the same
    state whole), ServeEngine's bf16 tokens, and a checkpoint of the
    trained parameters' cut (MESH_CKPT_LAYERS) and step saved on the
    mesh, restored off it, saved again and restored onto the mesh, bit
    for bit."""
    import tempfile

    import torch

    from repro_torch.checkpoint.store import restore_checkpoint, save_checkpoint
    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.dist.sharding import Runtime, distribute_params, full, local
    from repro_torch.models import ffn, model
    from repro_torch.models.params import block_specs, param_specs
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train.compression import compression_init
    from repro_torch.train.step import TrainConfig, make_train_step
    from repro_torch.tree import leaves

    t0 = _now()
    cfg = get_arch(LM_ARCH)
    on_mesh, free = Runtime(mesh=mesh), Runtime()
    specs = param_specs(cfg)
    params = model.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               dtype=torch.float32, device=dev)
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model}

    # the explicit-TP FFN (col / row products) against ffn_forward
    t = _now()
    bp = {k: v[0] for k, v in params["segments"][0]["blocks"][0]["channel"].items()}
    tp = Runtime(mesh=mesh, explicit_tp=True)
    placed_bp = distribute_params(bp, block_specs(cfg, "gqa+ffn")["channel"], tp)
    x = torch.randn((MESH_TRAIN[0], MESH_TRAIN[1], cfg.d_model),
                    generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    with torch.no_grad():
        want = ffn.ffn_forward(bp, x, cfg, free)
        got = ffn.ffn_forward(placed_bp, x, cfg, tp)
    tp_err = float((got - want).abs().max() / want.abs().max())
    out["explicit_tp_ffn"] = {"shape": list(x.shape), "max_rel_err": tp_err,
                              "bit_equal": bool(torch.equal(got, want)), "seconds": _now() - t}
    check(tp_err <= MESH_TP_TOL, f"mesh: explicit-TP FFN {out['explicit_tp_ffn']}")
    del bp, placed_bp, x, want, got

    # training: the same initial state on the mesh and whole
    b, s, steps, mb = MESH_TRAIN
    tc = TrainConfig(lr=3e-4, warmup_steps=1, total_steps=steps + 1, microbatches=mb,
                     grad_compression=True)
    pipe = SyntheticTokenPipeline(cfg, b, s, seed=0, device=dev)
    batches = [_split(pipe.batch(i), mb) for i in range(steps)]
    placed = distribute_params(_tree_map(torch.clone, params), specs, on_mesh)
    runs = {}
    for name, rt, p in (("mesh", on_mesh, placed), ("free", free, params)):
        state = {"params": p, "opt": adamw_init(p), "err": compression_init(p)}
        step_fn = make_train_step(cfg, rt, tc)
        losses, norms, secs = [], [], []
        for batch in batches:
            t = _now()
            state, m = step_fn(state, batch)
            secs.append(_now() - t)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        runs[name] = (state, losses, norms, secs)
    (sm, lm_, nm, secs_m), (sf, lf, nf, secs_f) = runs["mesh"], runs["free"]
    bitwise = lm_ == lf and nm == nf and all(
        torch.equal(full(a), b) for a, b in zip(leaves(sm["params"]), leaves(sf["params"])))
    worst = max(max(abs(a - c) / abs(c) for a, c in zip(lm_, lf)),
                max(abs(a - c) / abs(c) for a, c in zip(nm, nf)))
    out["train"] = {"batch": b, "seq": s, "steps": steps, "microbatches": mb,
                    "grad_compression": True, "dtype": "float32", "losses": lm_,
                    "grad_norms": nm, "mesh_free_losses": lf, "mesh_free_grad_norms": nf,
                    "max_rel_diff": worst,
                    "bit_equal": bitwise, "step_s_mesh": secs_m, "step_s_free": secs_f}
    check(worst <= MESH_STEP_RTOL, f"mesh: train steps {out['train']}")
    del runs, sf, params
    torch.cuda.empty_cache()

    # a checkpoint: mesh -> no mesh -> mesh
    t = _now()
    ck = Path(tempfile.mkdtemp(prefix="smoke_mesh_"))
    cut = {"params": _params_cut(sm["params"], MESH_CKPT_LAYERS), "step": sm["opt"]["step"]}
    save_checkpoint(ck / "a", steps - 1, cut)
    off, step_a = restore_checkpoint(ck / "a", cut, dev)
    ok_a = step_a == steps - 1 and all(torch.equal(full(a), b) for a, b in
                                       zip(leaves(cut), leaves(off), strict=True))
    save_checkpoint(ck / "b", steps - 1, off)
    back, _ = restore_checkpoint(ck / "b", cut, on_mesh)
    ok_b = all(torch.equal(local(a), local(b)) and type(a) is type(b)
               for a, b in zip(leaves(cut), leaves(back), strict=True))
    nbytes = sum(f.stat().st_size for f in (ck / "a").rglob("*") if f.is_file())
    shutil.rmtree(ck)
    out["checkpoint"] = {"layers": MESH_CKPT_LAYERS, "bytes": nbytes,
                         "mesh_to_none_bitwise": ok_a, "none_to_mesh_bitwise": ok_b,
                         "seconds": _now() - t}
    check(ok_a and ok_b, f"mesh: checkpoint round trip {out['checkpoint']}")
    del sm, cut, off, back, placed
    torch.cuda.empty_cache()

    # serving: bf16 weights placed on the mesh against the same whole
    t = _now()
    sb, sp, sn = MESH_SERVE
    params16 = model.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(sb, sp)).astype(np.int32)
    toks = {}
    for name, rt, p in (("mesh", on_mesh, distribute_params(params16, specs, on_mesh)),
                        ("free", free, params16)):
        toks[name] = ServeEngine(cfg, rt, p, max_seq=sp + sn).generate(prompts, sn)
    out["serve"] = {"batch": sb, "prompt": sp, "steps": sn, "dtype": "bfloat16",
                    "tokens_equal": bool(np.array_equal(toks["mesh"], toks["free"])),
                    "sample": toks["mesh"][0, :16].tolist(), "seconds": _now() - t}
    check(out["serve"]["tokens_equal"], f"mesh: served tokens differ: {out['serve']}")
    del params16
    torch.cuda.empty_cache()
    out["peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
    out["seconds"] = _now() - t0
    return out


def mesh_split_rank(rank: int, world: int, store: str, out: str, free: dict) -> None:
    """One of the two ranks of the (1, 2) gloo mesh on the one card
    (`start_mesh_split`): tinyllama_1_1b at full width (SPLIT_LAYERS
    deep) with its weights placed by their specs (heads, f columns and
    vocabulary split over 'model'), MESH_TRAIN's f32 steps against the
    mesh-free run's (`free`, `split_baseline`), a prefill and
    SPLIT_DECODE's decode steps across the ranks' slot boundary against
    the full forward, ServeEngine's f32 tokens against the mesh-free
    engine's (both rank 0's), and every local shape of the weights, the
    gradients and the caches against its spec's window.
    Rank 0 writes the results to `out`."""
    from datetime import timedelta

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=300))
    try:
        res = _split_paths(torch.device("cuda", 0), free)
        if rank == 0:
            Path(out).write_text(json.dumps(res))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _split_paths(dev, free: dict) -> dict:
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.dist.sharding import (
        Runtime,
        distribute_params,
        local,
        logical_to_spec,
        window,
    )
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model
    from repro_torch.models.params import _map_specs, param_specs
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train.compression import compression_init
    from repro_torch.train.step import TrainConfig, make_train_step
    from repro_torch.tree import leaves

    t0 = time.perf_counter()
    mesh = make_local_mesh(1, 2, device=str(dev))
    rt, free_rt = Runtime(mesh=mesh), Runtime()
    cfg = get_arch(LM_ARCH).with_overrides(n_layers=SPLIT_LAYERS)
    specs = _map_specs(lambda s: s, param_specs(cfg))
    out = {"backend": dist.get_backend(), "mesh": [1, 2], "arch": cfg.name,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "n_heads": cfg.n_heads, "vocab": cfg.vocab_size, "start_s": time.perf_counter() - t0}

    def windows(tree, spec_tree) -> bool:
        return all(tuple(local(t).shape) == tuple(
            w.stop - w.start for w in window(s.shape, logical_to_spec(s.logical, s.shape, rt),
                                             rt))
            for t, s in zip(leaves(tree), leaves(spec_tree), strict=True))

    def weights(dtype):
        p = model.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dtype=dtype,
                              device=dev)
        return p, distribute_params(p, specs, rt)

    # training: MESH_TRAIN's steps from mesh_tinyllama's initial state
    t = _now()
    b, s, steps, mb = MESH_TRAIN
    tc = TrainConfig(lr=3e-4, warmup_steps=1, total_steps=steps + 1, microbatches=mb,
                     grad_compression=True)
    whole, placed = weights(torch.float32)
    del whole
    pipe = SyntheticTokenPipeline(cfg, b, s, seed=0, device=dev)
    state = {"params": placed, "opt": adamw_init(placed), "err": compression_init(placed)}
    step_fn = make_train_step(cfg, rt, tc)
    grads, _ = step_fn.compute_grads(placed, {k: v[0] for k, v in
                                              _split(pipe.batch(0), mb).items()})
    grad_shapes_ok = windows(grads, specs)
    del grads
    losses, norms, secs = [], [], []
    for i in range(steps):
        ts = _now()
        state, m = step_fn(state, _split(pipe.batch(i), mb))
        secs.append(_now() - ts)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    worst = max(max(abs(a - c) / abs(c) for a, c in zip(losses, free["losses"])),
                max(abs(a - c) / abs(c) for a, c in zip(norms, free["grad_norms"])))
    out["train"] = {"batch": b, "seq": s, "steps": steps, "microbatches": mb,
                    "grad_compression": True, "losses": losses, "grad_norms": norms,
                    "mesh_free_losses": free["losses"], "mesh_free_grad_norms":
                    free["grad_norms"], "max_rel_diff": worst, "step_s": secs,
                    "mesh_free_step_s": free["step_s"],
                    "param_shapes_equal_spec": windows(state["params"], specs),
                    "moment_shapes_equal_spec": windows(state["opt"]["m"], specs),
                    "grad_shapes_equal_spec": grad_shapes_ok, "seconds": _now() - t}
    del state, placed
    torch.cuda.empty_cache()

    # prefill + decode across the slot boundary, against the full forward
    t = _now()
    db, s0, n_dec, s_max = SPLIT_DECODE
    whole, placed = weights(torch.float32)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(db, s_max)).astype(np.int32)).to(dev)
    with torch.no_grad():
        last, cache = model.prefill(placed, {"tokens": toks[:, :s0]}, cfg, rt, s_max=s_max)
        cache_ok = windows(cache, model.cache_specs(cfg, db, s_max))
        got = [model.head_logits(placed, last, cfg, rt)]
        for pos in range(s0, s0 + n_dec):
            lg, cache = model.decode_step(placed, toks[:, pos:pos + 1], cache, pos, cfg, rt)
            got.append(lg)
        got = torch.cat(got, dim=1)[..., :cfg.vocab_size].float()
        want = model.head_logits(whole, model.forward_train(whole, {"tokens": toks}, cfg,
                                                            free_rt), cfg, free_rt)
        want = want[:, s0 - 1:s0 + n_dec, :cfg.vocab_size].float()
        err = float((torch.log_softmax(got, -1) - torch.log_softmax(want, -1)).abs().max())
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    out["decode"] = {"batch": db, "prefill": s0, "steps": n_dec, "cache_slots": s_max,
                     "boundary_slot": s_max // 2, "logp_max_err": err, "argmax_agreement": agree,
                     "cache_shapes_equal_spec": cache_ok,
                     "cache_local_bytes": sum(local(c).numel() * local(c).element_size()
                                              for c in leaves(cache)),
                     "seconds": _now() - t}
    del cache

    # serving: f32 weights placed on the mesh against the same whole (rank 0)
    t = _now()
    sb, sp, sn = MESH_SERVE
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(sb, sp)).astype(np.int32)
    ts = _now()
    served = ServeEngine(cfg, rt, placed, max_seq=sp + sn).generate(prompts, sn)
    mesh_s = _now() - ts
    ts = _now()
    free_tok = ServeEngine(cfg, free_rt, whole, max_seq=sp + sn).generate(prompts, sn)
    out["serve"] = {"batch": sb, "prompt": sp, "steps": sn, "dtype": "float32",
                    "tokens_equal": bool(np.array_equal(served, free_tok)),
                    "agreement": float((served == free_tok).mean()),
                    "sample": served[0, :16].tolist(), "generate_s_mesh": mesh_s,
                    "generate_s_free": _now() - ts, "seconds": _now() - t}
    out["peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
    out["seconds"] = time.perf_counter() - t0
    return out


def split_baseline(dev) -> dict:
    """The mesh-free f32 train steps of `mesh_split_rank`'s model and
    batches (MESH_TRAIN), run in this process before the ranks start."""
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.dist.sharding import Runtime
    from repro_torch.models import model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.compression import compression_init
    from repro_torch.train.step import TrainConfig, make_train_step

    cfg = get_arch(LM_ARCH).with_overrides(n_layers=SPLIT_LAYERS)
    b, s, steps, mb = MESH_TRAIN
    tc = TrainConfig(lr=3e-4, warmup_steps=1, total_steps=steps + 1, microbatches=mb,
                     grad_compression=True)
    p = model.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          dtype=torch.float32, device=dev)
    state = {"params": p, "opt": adamw_init(p), "err": compression_init(p)}
    pipe = SyntheticTokenPipeline(cfg, b, s, seed=0, device=dev)
    step_fn = make_train_step(cfg, Runtime(), tc)
    losses, norms, secs = [], [], []
    for i in range(steps):
        t = _now()
        state, m = step_fn(state, _split(pipe.batch(i), mb))
        secs.append(_now() - t)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    del state, p
    torch.cuda.empty_cache()
    return {"losses": losses, "grad_norms": norms, "step_s": secs}


def start_mesh_split(free: dict):
    """Starts the (1, 2) gloo mesh's two processes on the one card
    (`mesh_split_rank`) and returns what `finish_mesh_split` waits for."""
    import tempfile

    import torch.multiprocessing as mp

    tmp = Path(tempfile.mkdtemp(prefix="smoke_split_"))
    ctx = mp.start_processes(mesh_split_rank,
                             args=(2, str(tmp / "store"), str(tmp / "split.json"), free),
                             nprocs=2, join=False, start_method="spawn")
    return ctx, tmp, time.perf_counter()


def finish_mesh_split(job) -> dict:
    """Waits for the (1, 2) ranks and checks their results."""
    ctx, tmp, t = job
    deadline = t + SPLIT_TIMEOUT
    try:
        while not ctx.join(timeout=max(deadline - time.perf_counter(), 0.1)):
            check(time.perf_counter() < deadline, "mesh: the (1, 2) ranks timed out")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    out = json.loads((tmp / "split.json").read_text())
    shutil.rmtree(tmp)
    out["wall_s"] = time.perf_counter() - t
    tr, dec, srv = out["train"], out["decode"], out["serve"]
    check(tr["max_rel_diff"] <= SPLIT_TRAIN_RTOL, f"mesh (1, 2): train steps {tr}")
    check(tr["param_shapes_equal_spec"] and tr["moment_shapes_equal_spec"]
          and tr["grad_shapes_equal_spec"], f"mesh (1, 2): local shapes {tr}")
    check(dec["logp_max_err"] <= SPLIT_LOGP_TOL and dec["argmax_agreement"] >= KINDS_TF_MIN_AGREE
          and dec["cache_shapes_equal_spec"], f"mesh (1, 2): decode {dec}")
    check(srv["tokens_equal"], f"mesh (1, 2): served tokens differ: {srv}")
    return out


def lm_kinds(dev) -> None:
    """The other block kinds' paths (`kinds_model`), deepseek first while
    nothing large is on the card, then the mesh's LM part (`mesh_moe` on
    the MoE configs' layers while they are on the card, `mesh_tinyllama`
    last, once they have left it) on a one-rank NCCL group's (1, 1) mesh,
    made here first, and the (1, 2) gloo mesh's two processes
    (`start_mesh_split`), started once deepseek has left the card and
    read before `mesh_tinyllama`. `chip_smoke.py --lm-kinds` runs them in a process of
    their own, started at the smoke's start (no kernel); the LM paths'
    process starts only once it has exited."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    t = _now()
    mesh = make_local_mesh(1, 1, device="cuda")
    group_s = _now() - t
    split = None
    try:
        moe = {}
        for arch in KINDS_TF:
            got = kinds_model(arch, dev, mesh)
            if got is not None:
                moe[arch] = got
            if split is None:
                # once deepseek (the first, 67 GB) has left the card, the
                # (1, 2) ranks (~10 GB) run beside the other kinds (26 GB
                # at most); mesh_tinyllama's 51 GB waits for them, since
                # the first process's kernel phases (~18 GB) run beside it
                split = start_mesh_split(split_baseline(dev))
        split = finish_mesh_split(split)
        t = _now()
        lm = mesh_tinyllama(mesh, dev)
        emit({"phase": "mesh_lm", "backend": dist.get_backend(), "mesh": [1, 1],
              "axis_names": list(mesh.mesh_dim_names), "group_start_s": group_s,
              "moe": moe, "tinyllama": lm, "split": split,
              "seconds": group_s + sum(m["seconds"] for m in moe.values()) + _now() - t})
    finally:
        if isinstance(split, tuple):
            for p in split[0].processes:
                if p.is_alive():
                    p.kill()
        dist.destroy_process_group()


LM_PATHS_FLAG = "--lm-paths"
LM_PATHS_TIMEOUT = 900


SHARDED_FLAG = "--sharded-paths"
SHARDED_TIMEOUT = 900


def sharded_paths(dev) -> None:
    """Paths 5–8 on the same corpus, queries and truth made again: phases
    `sharded`, `delta`, `durable` and `serve` in order on one sharded
    index. `chip_smoke.py --sharded-paths` runs them in a process of its
    own, started once the kernels are built and timed; `serve`'s launches
    go to the kernels line."""
    X, Q, _, _ = corpus(dev)
    index, _ = phase_sharded(X, Q, exact_truth(X, Q))
    phase_mesh_index(index, Q)
    phase_delta(index)
    rdur, state = phase_durable(index, Q)
    del index
    phase_serve(rdur, Q)
    rdur.close()
    shutil.rmtree(state)


def finish_sharded_paths(proc) -> tuple[dict, dict]:
    """Waits for the sharded paths' process, relays its lines, and returns
    its serve phase's launches and its `mesh_index` line."""
    lines = finish_side(proc, SHARDED_TIMEOUT, "sharded paths")
    serve = next((json.loads(ln) for ln in lines if ln.startswith('{"phase": "serve"')), None)
    check(serve is not None, "the sharded paths printed no serve phase")
    mesh = next((json.loads(ln) for ln in lines if ln.startswith('{"phase": "mesh_index"')),
                None)
    check(mesh is not None, "the sharded paths printed no mesh_index line")
    return serve["launches"], mesh


def lm_paths(dev) -> None:
    """The LM-side paths: the LM's serving and training command lines and
    the dry-run's two production cells (beside them), the weights, phases
    `train`, `dryrun`'s step (`phase_dryrun`), `knn_store` (on the trained
    weights), `lm` (on the random ones), `knn_lm` (trained), `serve_cli`,
    `train_cli` and the dry-run's cells (`finish_dryruns`).
    `chip_smoke.py --lm-paths` runs them in a process beside the retrieval
    phases (`start_side`), so their seconds and rates share the card and
    the host with those."""
    dryruns = start_dryruns()
    cli = start_lm_cli()
    train_cli = start_train_cli()
    try:
        lm = lm_weights(dev)
        trained = phase_train(lm, dev)
        peak = phase_dryrun(lm, dev)
        store = phase_knn_store(lm, trained, dev)
        phase_lm(lm, cli, dev)
        phase_knn_lm(lm, trained, store, dev)
        phase_serve_cli()
        phase_train_cli(train_cli)
        finish_dryruns(dryruns, peak)
    finally:
        train_cli["stop"].set()
        for proc in (cli, *train_cli["procs"], *dryruns["procs"]):
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        train_cli["thread"].join(timeout=60)


def start_side(flag: str) -> subprocess.Popen:
    """`chip_smoke.py <flag>` in a process group of its own (so that what it
    starts goes with it), its output kept in temporary files for
    `finish_side`."""
    import tempfile

    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), flag],
                            cwd=Path(__file__).resolve().parent, stdout=out, stderr=err,
                            text=True, start_new_session=True)
    proc.out, proc.err = out, err
    return proc


def finish_side(proc, timeout: float, label: str) -> list:
    """Waits for a `start_side` process, relays its lines, fails unless it
    exited 0, and returns its lines."""
    rc = proc.wait(timeout=timeout)
    proc.out.seek(0)
    proc.err.seek(0)
    lines, err = proc.out.read().splitlines(), proc.err.read()
    for ln in lines:
        print(ln, flush=True)
    check(rc == 0, f"the {label} exited {rc}: {err[-4000:]}")
    return lines


def finish_lm_kinds(proc) -> dict:
    """Waits for the other block kinds' process (`lm_kinds`), relays its
    lines, checks that every arch printed its phase, and returns its
    `mesh_lm` line. Called before the LM paths start: the `train` phase's
    47 GB and deepseek's 60 GB never share the card."""
    lines = finish_side(proc, KINDS_TIMEOUT, "other block kinds' paths")
    done = {json.loads(ln)["arch"] for ln in lines if ln.startswith('{"phase": "lm_kinds"')}
    check(done == set(KINDS_TF), f"lm_kinds printed {sorted(done)}, not {sorted(KINDS_TF)}")
    mesh = next((json.loads(ln) for ln in lines if ln.startswith('{"phase": "mesh_lm"')), None)
    check(mesh is not None, "the other block kinds' process printed no mesh_lm line")
    return mesh


def emit_mesh(lm: dict, index: dict) -> None:
    """The `mesh` line: path 16's two parts, from the `--lm-kinds` and the
    `--sharded-paths` processes, each of which checked its own."""
    moe = lm["moe"]
    tl = lm["tinyllama"]
    check(set(moe) == {a for a in KINDS_TF if "deepseek" in a or "llama4" in a},
          f"mesh: MoE checks ran on {sorted(moe)}")
    emit({"phase": "mesh", "backend": lm["backend"], "mesh": lm["mesh"],
          "axis_names": lm["axis_names"],
          "moe": {a: {k: m[k] for k in ("max_rel_err", "bit_equal", "dropped",
                                          "decode_max_rel_err", "decode_bit_equal")}
                  for a, m in moe.items()},
          "tinyllama": {"n_layers": tl["n_layers"], "d_model": tl["d_model"],
                        "train_bit_equal": tl["train"]["bit_equal"],
                        "train_max_rel_diff": tl["train"]["max_rel_diff"],
                        "explicit_tp_max_rel_err": tl["explicit_tp_ffn"]["max_rel_err"],
                        "serve_tokens_equal": tl["serve"]["tokens_equal"],
                        "checkpoint_bitwise": tl["checkpoint"]["mesh_to_none_bitwise"]
                        and tl["checkpoint"]["none_to_mesh_bitwise"]},
          "split_1x2": {"backend": lm["split"]["backend"],
                        "train_max_rel_diff": lm["split"]["train"]["max_rel_diff"],
                        "decode_logp_max_err": lm["split"]["decode"]["logp_max_err"],
                        "serve_tokens_equal": lm["split"]["serve"]["tokens_equal"],
                        "shapes_equal_spec": lm["split"]["train"]["param_shapes_equal_spec"]
                        and lm["split"]["decode"]["cache_shapes_equal_spec"]},
          "shard_over_equal": index["equal"], "shard_over_launches": index["launches"],
          "seconds": {"lm_kinds_process": lm["seconds"], "sharded_process": index["seconds"]}})


def finish_lm_paths(proc) -> tuple[dict, list]:
    """Waits for the LM paths' process, relays its phase lines, and returns
    its knn_lm phase's (launches, kernel rows) for the kernels line."""
    lines = finish_side(proc, LM_PATHS_TIMEOUT, "LM paths")
    knn = next((json.loads(ln) for ln in lines if ln.startswith('{"phase": "knn_lm"')), None)
    check(knn is not None, "the LM paths printed no knn_lm phase")
    return knn["launches"], knn["kernel_rows"]


def phase_mlsh(X, Q, truth, bulk_results):
    """The MLSH baseline on the Sun corpus on the card (m = MLSH_M, seed 0),
    the smoke's queries at each MLSH_P, k = K: recall@10 against the
    smoke's truth, mean N_p and rounds beside U-HNSW's mean N_p on the
    shared-pass graphs (phase search_bulk), and the idealized cost N_p x T_p
    of both (paper §4.1.4). Then MLSH_CPU_QUERIES queries against the same
    code on the CPU. The card sums each projection in another order than
    the CPU, and a projection that moves across a window's edge moves one
    collision count by one, so the rule is: rounds equal on all queries but
    one at most, N_p within MLSH_NP_RTOL of the CPU's on every query, ids
    equal wherever N_p is (up to near-ties: dists within RTOL), and a mean
    top-10 overlap of at least MLSH_MIN_OVERLAP. Plain torch: no kernel of
    the repo runs."""
    import torch

    from repro_torch.core.metrics import lp_distance_cost_model
    from repro_torch.core.mlsh import MLSH
    from repro_torch.core.uhnsw import recall

    t0 = _now()
    mlsh, launched = counted(MLSH, X, m=MLSH_M, seed=0)
    build_s = _now() - t0
    cpu = MLSH(X.cpu(), m=MLSH_M, seed=0, device="cpu")
    d = X.shape[1]
    per_p = {}
    for p in MLSH_P:
        t = _now()
        (ids, dists, stats), searched = counted(mlsh.search_batch_stats, Q, p, K)
        secs = _now() - t
        n_p = np.array([s.n_p for s in stats])
        u_np = float(bulk_results[p][2].n_p.float().mean())
        c_ids, c_d, c_st = cpu.search_batch_stats(Q[:MLSH_CPU_QUERIES].cpu(), p, K)
        g_ids = ids[:MLSH_CPU_QUERIES].cpu()
        c_np = np.array([s.n_p for s in c_st])
        np_rel = np.abs(n_p[:MLSH_CPU_QUERIES] - c_np) / c_np
        rounds_equal = sum(s.rounds == stats[i].rounds for i, s in enumerate(c_st))
        overlap = float(np.mean([len(set(a.tolist()) & set(b.tolist())) / K
                                 for a, b in zip(g_ids, c_ids)]))
        for i in np.flatnonzero(np_rel == 0):
            dc, dg = c_d[i].double(), dists[i].double().cpu()
            check(torch.equal(c_ids[i], g_ids[i]) or bool(
                ((dc - dg).abs() <= RTOL * dc.abs()).all()),
                f"mlsh p={p} query {i}: same N_p as the CPU, other ids")
        check(rounds_equal >= MLSH_CPU_QUERIES - 1 and np_rel.max() <= MLSH_NP_RTOL
              and overlap >= MLSH_MIN_OVERLAP,
              f"mlsh p={p}: against the CPU, rounds equal on {rounds_equal}, N_p off by "
              f"{np_rel.max()}, top-10 overlap {overlap}")
        check(bool(dists.isfinite().all()) and not any(searched.values()),
              f"mlsh p={p}: output or launches {searched}")
        per_p[str(p)] = {
            "recall@10": recall(ids, truth[p]), "mean_n_p": float(n_p.mean()),
            "max_n_p": int(n_p.max()), "mean_rounds": float(np.mean([s.rounds for s in stats])),
            "batch_seconds": secs, "uhnsw_mean_n_p": u_np,
            "uhnsw_recall@10": recall(bulk_results[p][0], truth[p]),
            "idealized_cost": float(n_p.mean()) * lp_distance_cost_model(p, d),
            "uhnsw_idealized_cost": u_np * lp_distance_cost_model(p, d),
            "cpu_n_p_equal": int((np_rel == 0).sum()), "cpu_n_p_max_rel": float(np_rel.max()),
            "cpu_rounds_equal": int(rounds_equal), "cpu_top10_overlap": overlap}
    emit({"phase": "mlsh", "seconds": _now() - t0, "m": MLSH_M, "build_s": build_s,
          "index_mib": mlsh.index_size_bytes() / 2**20, "per_p": per_p, "launches": launched})

def kernels_line(kernel_rows, bulk_rows, rest_rows, launches, worst, serve_counts,
                 knn_counts, knn_rows) -> list:
    """The summary line's entries, one per kernel: the timed row of its
    path's case, its launches on its path's counted run (and on the serve
    phase's clean run, `serve_launches`), and its largest error against
    its plain version over every case. gather_lp and gather_lp_abandon also
    carry their launches on the kNN-LM's held-out run and their times at
    its width (d = 2048, p = KNN_TIMED_P[0]), under `knn_lm_*`."""
    mix_row = kernel_rows[-1]
    rows = {"gather_lp": mix_row["gather_lp"], "gather_lp_abandon": mix_row["gather_lp_abandon"],
            "pairwise_lp": bulk_rows["pairwise_lp"][0],
            "gather_lp_screen": bulk_rows["gather_lp_screen"][-1],
            "rowwise_lp": next(r for r in rest_rows["rowwise_lp"] if r["p"] == "1.25"),
            "lp_topk": next(r for r in rest_rows["lp_topk"] if r["p"] == 1.25 and r["k"] == K)}
    worst = dict(worst)
    worst["gather_lp"] = max(worst["gather_lp"], worst.pop("gather_lp_build"))
    for r in knn_rows:
        worst["gather_lp"] = max(worst["gather_lp"], r["gather_lp"]["max_abs_err"])
        worst["gather_lp_abandon"] = max(worst["gather_lp_abandon"],
                                         r["gather_lp_abandon"]["max_abs_err"],
                                         r["gather_lp_abandon"]["survivor_case"]["max_abs_err"])
    kernels = []
    for name, replaces in (("gather_lp", "src/repro/kernels/lp_distance.py:384"),
                           ("gather_lp_abandon", "src/repro/kernels/lp_distance.py:560"),
                           ("pairwise_lp", "src/repro/kernels/lp_distance.py:136"),
                           ("gather_lp_screen", "src/repro/kernels/lp_distance.py:761"),
                           ("rowwise_lp", "src/repro/kernels/lp_distance.py:240"),
                           ("lp_topk", "src/repro/kernels/lp_topk.py:60")):
        r = rows[name]
        check(launches[name] > 0, f"{name} launched no time on its path")
        kernels.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                        "replaces": replaces, "launches": launches[name],
                        "serve_launches": serve_counts[name],
                        "max_abs_err": worst[name], "ms": r["ms"], "device_ms": r["device_ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r.get("library_ms")})
        if name in ("gather_lp", "gather_lp_abandon"):    # the kNN-LM's path, d = 2048
            kr = knn_rows[0][name]
            check(knn_counts[name] > 0, f"{name} launched no time on the kNN-LM's path")
            kernels[-1].update({"knn_lm_launches": knn_counts[name], "knn_lm_d": knn_rows[0]["d"],
                                "knn_lm_shape": kr["shape"], "knn_lm_ms": kr["ms"],
                                "knn_lm_device_ms": kr["device_ms"],
                                "knn_lm_plain_ms": kr["plain_ms"],
                                "knn_lm_bound_ms": kr["bound_ms"],
                                "knn_lm_bound_by": kr["bound_by"]})
        if name == "gather_lp":     # the build's shared pass: one multi-p launch, both metrics
            check(launches["gather_lp_multi"] > 0, "gather_lp_multi launched no time in the build")
            bld = bulk_rows["gather_lp_build"]
            kernels[-1].update({"build_source": "src/repro_torch/kernels/csrc/gather_lp_multi.cu",
                                "build_launches": launches["gather_lp_multi"],
                                "build_ms": bld["ms"], "build_device_ms": bld["device_ms"],
                                "build_bound_ms": bld["bound_ms"],
                                "build_plain_ms_on_plain_rows": bld["plain_ms_on_plain_rows"],
                                "build_two_launches_device_ms":
                                    bld["gather_lp_two_launches_device_ms"]})
        if name == "pairwise_lp":   # the level-1 call at p = 2 beside p = 1's
            p2 = bulk_rows["pairwise_lp"][1]
            check(p2["case"] == "level 1 p=2.0", f"pairwise_lp p = 2 row: {p2['case']}")
            kernels[-1].update({"p2_ms": p2["ms"], "p2_device_ms": p2["device_ms"],
                                "p2_library_ms": p2["library_ms"],
                                "p2_bound_ms": p2["bound_ms"]})
    return kernels


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device, nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch  # noqa: F401  (fails outside the repository)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    if sys.argv[1:] == [LM_PATHS_FLAG]:
        lm_paths(dev)
        return 0
    if sys.argv[1:] == [SHARDED_FLAG]:
        sharded_paths(dev)
        return 0
    if sys.argv[1:] == [KINDS_FLAG]:
        # half the host's cores: nvcc and the host builder run beside it
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
        lm_kinds(dev)
        return 0
    t_start = time.perf_counter()
    from repro_torch.kernels import _build

    procs: list = []
    try:
        return run_phases(dev, t_start, _build, procs)
    finally:
        for proc in procs:
            try:    # the group: what the process started may outlive it
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()


def run_phases(dev, t_start: float, _build, procs: list) -> int:
    """The phases in order; `procs` collects the processes they start."""
    import torch

    kinds = start_side(KINDS_FLAG)     # plain torch: it needs no kernel
    procs.append(kinds)
    with ThreadPoolExecutor(1) as pool:
        libs = pool.submit(_build.build_all)
        X, Q = phase_data(dev)
        truth = phase_truth(X, Q)
        host_index, host = phase_index(X, Q, truth, lambda: phase_build(libs, t_start))
    bulk_index, build_counts, build_rec = phase_index_bulk(X, Q, truth, host)
    del X
    kernel_rows, worst = phase_kernels(host_index, Q)
    bulk_rows, worst_bulk = phase_kernels_bulk(bulk_index, Q, build_rec)
    del build_rec
    rest_rows, worst_rest, rest_counts = phase_kernels_rest(bulk_index, Q)
    # the kernels are built and timed: the sharded and LM paths load them
    # beside the phases below, the LM paths once the other block kinds'
    # models have left the card
    sharded = start_side(SHARDED_FLAG)
    procs.append(sharded)
    starts = {"sharded_paths_start_s": time.perf_counter() - t_start}
    mesh_lm = finish_lm_kinds(kinds)
    lm = start_side(LM_PATHS_FLAG)
    procs.append(lm)
    # how long the LM paths waited for the other kinds' process, if at all
    starts["lm_paths_start_s"] = time.perf_counter() - t_start
    emit({"phase": "side_starts", **starts,
          "lm_paths_waited_s": starts["lm_paths_start_s"] - starts["sharded_paths_start_s"]})
    results, counts = phase_search(host_index, Q, truth, "search", HOST_P)
    phase_mixed(results, "mixed")
    del host_index
    bulk_results, _ = phase_search(bulk_index, Q, truth, "search_bulk")
    phase_mixed(bulk_results, "mixed_bulk")
    band_counts = phase_band(bulk_index, Q, bulk_results)
    phase_nan(bulk_index, Q)
    phase_mlsh(bulk_index.X, Q, truth, bulk_results)
    serve_counts, mesh_index = finish_sharded_paths(sharded)
    knn_counts, knn_rows = finish_lm_paths(lm)
    emit_mesh(mesh_lm, mesh_index)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    kernels = kernels_line(kernel_rows, bulk_rows, rest_rows,
                           {"gather_lp": counts["gather_lp"],
                            "gather_lp_abandon": counts["gather_lp_abandon"],
                            "pairwise_lp": build_counts["pairwise_lp"],
                            "gather_lp_multi": build_counts["gather_lp_multi"],
                            "gather_lp_screen": band_counts["gather_lp_screen"],
                            "rowwise_lp": rest_counts["rowwise_lp"],
                            "lp_topk": rest_counts["lp_topk"]},
                           {**worst, **worst_bulk, **worst_rest}, serve_counts, knn_counts,
                           knn_rows)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
