"""Serving entry point: LM decode + optional universal-Lp retrieval tier.

Counterpart of `repro.launch.serve`:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama_1_1b \
      --batch 4 --prompt-len 16 --steps 32
  PYTHONPATH=src python -m repro_torch.launch.serve --retrieval --requests 64
  PYTHONPATH=src python -m repro_torch.launch.serve --retrieval \
      --n 200000 --requests 1024 --state-dir DIR

It runs on the CUDA card unless given --device cpu. The LM serves every
arch, on one card or on a mesh of --data x --model ranks started by
torch.distributed.run (weights placed by their specs, each rank given the
same prompts; only rank 0 prints):

  python -m torch.distributed.run --nproc-per-node 2 \
      -m repro_torch.launch.serve --smoke --data 2 --device cpu

So does the retrieval tier: every rank builds (or recovers) the same
index, places its segment axis over the mesh's data axis
(`ShardedUHNSW.shard_over`), and serves the same requests, rank 0 running
the engine and the others following its index calls; rank 0 prints:

  python -m torch.distributed.run --nproc-per-node 2 \
      -m repro_torch.launch.serve --retrieval --data 2 --segments 2 --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch.configs.base import get_arch


def serve_lm(args) -> int:
    """Random-init weights from --seed, greedy (or --temperature) decode of
    a batch of prompts drawn from np.random.default_rng(--seed), as the
    reference draws them; prints what the reference's `serve_lm` prints."""
    import torch

    from repro_torch.dist.sharding import distribute_params, process_index
    from repro_torch.launch.mesh import runtime_from_args
    from repro_torch.models.model import init_params
    from repro_torch.models.params import param_specs

    rt, dev = runtime_from_args(args, moe_decode_gather=args.moe_decode_gather)
    try:
        cfg = get_arch(args.arch, smoke=args.smoke)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
        if rt.distributed:
            params = distribute_params(params, param_specs(cfg), rt)
        return _serve_lm(args, cfg, rt, params, dev, process_index() == 0)
    finally:
        if rt.distributed:
            torch.distributed.destroy_process_group()


def _serve_lm(args, cfg, rt, params, dev, lead: bool) -> int:
    import torch

    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(cfg, rt, params, max_seq=args.prompt_len + args.steps)
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, size=(args.batch, args.prompt_len)
    ).astype(np.int32)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    out = eng.generate(prompts, steps=args.steps, temperature=args.temperature)
    dt = time.time() - t0
    tok = args.batch * args.steps
    if lead:
        print(f"generated {out.shape} tokens in {dt:.1f}s "
              f"({tok / dt:.1f} tok/s on {dev.type})")
        print("sample:", out[0][:16].tolist())
    return 0


def serve_retrieval(args) -> int:
    """The retrieval tier: a sharded index over the `deep` generator
    (durable under --state-dir), served through the engine; prints what
    the reference's `serve_retrieval` prints. On a mesh of --data x
    --model ranks the segment axis is placed over it and rank 0 prints."""
    import torch

    from repro_torch.dist.sharding import process_index
    from repro_torch.launch.mesh import runtime_from_args

    rt, dev = runtime_from_args(args)
    try:
        return _serve_retrieval(args, rt, dev, process_index() == 0)
    finally:
        if rt.distributed:
            torch.distributed.destroy_process_group()


def _serve_retrieval(args, rt, dev, lead: bool) -> int:
    import torch.distributed as dist

    from repro_torch.core.datasets import make_dataset
    from repro_torch.core.uhnsw import UHNSWParams
    from repro_torch.index.persist import DurableIndex, latest_durable_snapshot
    from repro_torch.index.sharded import ShardedUHNSW
    from repro_torch.retrieval.engine import FaultInjector
    from repro_torch.retrieval.service import QueryRequest, UniversalVectorService

    # chaos rehearsal (DESIGN.md §9, §11): a seeded injector at the
    # engine's device-call boundary; 0.0 leaves the happy path untouched.
    # --fault-sites segment adds the per-segment sites (opt-in — the
    # classic three-site schedules never shift), which exercises the
    # health tracker's EWMA quarantine path under the coverage floor.
    injector = None
    if args.fault_rate > 0:
        sites = tuple(args.fault_sites.split(",")) if args.fault_sites \
            else None
        injector = FaultInjector(rate=args.fault_rate, seed=args.fault_seed,
                                 sites=sites)
    ds = make_dataset("deep", n=args.n, n_queries=128, seed=args.seed)
    # --compressed: two-band verification (DESIGN.md §10) — candidates are
    # screened against the int8 band and only survivors gather f32 rows;
    # results are bitwise-identical, f32-rows tells what the screen saved
    params = UHNSWParams(t=200, compressed_band=args.compressed)
    say = print if lead else (lambda *a, **k: None)
    if args.state_dir:
        # durable lifecycle: recover an existing state dir (snapshot + WAL
        # replay, bit-identical) or snapshot a fresh build into it (rank 0
        # writes; every rank looks before any writes)
        exists = latest_durable_snapshot(args.state_dir) is not None
        if rt.distributed:
            dist.barrier()
        if exists:
            index = DurableIndex.recover(args.state_dir, params=params,
                                         device=dev)
            say(f"recovered durable index from {args.state_dir}: "
                f"n={index.n}, {index.num_segments} segments, "
                f"{len(index.delta)} delta-resident inserts")
        else:
            index = DurableIndex.create(
                ShardedUHNSW.build(ds.data, num_segments=args.segments,
                                   m=16, params=params, device=dev),
                args.state_dir)
            say(f"created durable index at {args.state_dir}: n={index.n}")
        if rt.distributed:
            index.index.shard_over(rt)
        service = UniversalVectorService(index=index,
                                         fault_injector=injector,
                                         min_coverage=args.min_coverage)
    else:
        service = UniversalVectorService.build(ds.data, params, m=16,
                                               num_segments=args.segments,
                                               device=dev,
                                               rt=rt if rt.distributed else None,
                                               fault_injector=injector,
                                               min_coverage=args.min_coverage)
    rng = np.random.default_rng(args.seed)
    reqs = [
        QueryRequest(
            vector=ds.queries[int(rng.integers(len(ds.queries)))],
            p=float(rng.choice([0.5, 0.8, 1.0, 1.3, 1.7, 2.0])),
            k=10, request_id=i,
        )
        for i in range(args.requests)
    ]
    t0 = time.time()
    out = service.serve(reqs)
    dt = time.time() - t0
    if not lead:
        return 0
    st = service.stats
    lat = service.latency_summary()
    print(f"served {len(out)} mixed-p requests in {dt:.1f}s "
          f"({len(out) / dt:.0f} qps, {st['batches']} ladder waves, "
          f"queue peak {st['queue_peak']}); "
          f"avg N_b={st['n_b'] / len(reqs):.0f} "
          # probe = threshold-free work, spill = work under an inherited
          # cross-segment bound (DESIGN.md §3); spill=0 off the
          # two_phase/round_robin policies
          f"(probe={st['n_b_probe'] / len(reqs):.0f} "
          f"spill={st['n_b_spill'] / len(reqs):.0f}) "
          f"N_p={st['n_p'] / len(reqs):.0f} "
          # effective T_p under early-abandoning verification (DESIGN.md
          # §8); no verification at all (n_p == 0) means full-dim = 1.0
          f"dim-scan="
          f"{st['dim_frac_w'] / st['n_p'] if st['n_p'] else 1.0:.2f} "
          # f32 rows gathered per scored candidate (DESIGN.md §10); 1.0
          # without --compressed, < 1 when the int8 screen is saving HBM
          f"f32-rows="
          f"{st['f32_rows_w'] / st['n_p'] if st['n_p'] else 1.0:.2f}; "
          f"latency p50={lat['p50']:.0f}ms p95={lat['p95']:.0f}ms")
    # engine scheduling outcomes (DESIGN.md §6): why batches dispatched,
    # what admission control did, and where each request's time went
    fl = st["flushes"]
    print(f"  flushes: full={fl['full']} deadline={fl['deadline']} "
          f"drain={fl['drain']}; shed={st['shed']} "
          f"degraded={st['degraded']} padded_rows={st['padded_rows']}")
    # fault tolerance (DESIGN.md §9): every admitted request ended DONE or
    # deterministic FAILED; the counters say what the recovery paid
    failures = service.engine.take_failures()
    if args.fault_rate > 0 or st["faults"]:
        print(f"  faults: caught={st['faults']} retries={st['retries']} "
              f"quarantine_splits={st['quarantine_splits']} "
              f"failed={st['failed']}"
              + (f" (injector: rate={args.fault_rate}, "
                 f"seed={args.fault_seed}, "
                 f"injected={injector.injected})" if injector else ""))
        for rid, err in sorted(failures.items())[:5]:
            print(f"    request {rid} FAILED: {err}")
    # degraded serving (DESIGN.md §11): achieved coverage, what the NaN
    # guard caught, and the quarantine/recovery/probe tallies — printed
    # whenever the engine ran degraded or the operator set a floor
    hl = lat.get("health") or {}
    tracker = hl.get("tracker")
    if hl and (args.min_coverage > 0 or hl.get("poison_detected")
               or hl.get("seg_quarantined") or hl.get("min_coverage_failed")
               or (tracker and tracker.get("quarantined"))):
        print(f"  health: coverage_mean={hl['coverage_mean']:.4f} "
              f"(floor {args.min_coverage}) "
              f"poison_detected={hl['poison_detected']} "
              f"quarantined={hl['seg_quarantined']} "
              f"recovered={hl['seg_recovered']} "
              f"min_coverage_failed={hl['min_coverage_failed']}")
        if tracker:
            print(f"    tracker: by_state={tracker['by_state']} "
                  f"probes={tracker['probes']} "
                  f"failures={tracker['failures']} "
                  f"generation={tracker['generation']}")
    qm, cm = lat.get("queue_ms") or {}, lat.get("compute_ms") or {}
    if qm and cm:
        warm = lat.get("warm") or {}
        warm_txt = (f", warm-only p50={warm['p50']:.0f}ms "
                    f"p95={warm['p95']:.0f}ms" if warm else "")
        print(f"  latency split: queue-wait p50={qm['p50']:.0f}ms "
              f"p95={qm['p95']:.0f}ms | device-compute p50={cm['p50']:.0f}ms "
              f"p95={cm['p95']:.0f}ms | {lat['cold_count']} requests rode a "
              f"batch shape's first wave{warm_txt}")
    for name, pb in st["per_base"].items():
        if pb["queries"]:
            print(f"  {name}: {pb['queries']} queries / {pb['batches']} "
                  f"batches, avg N_b={pb['n_b'] / pb['queries']:.0f} "
                  f"N_p={pb['n_p'] / pb['queries']:.0f} dim-scan="
                  f"{pb['dim_frac_w'] / pb['n_p'] if pb['n_p'] else 1.0:.2f}"
                  f" f32-rows="
                  f"{pb['f32_rows_w'] / pb['n_p'] if pb['n_p'] else 1.0:.2f}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama_1_1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--moe-decode-gather", action="store_true")
    ap.add_argument("--retrieval", action="store_true",
                    help="serve the universal-Lp vector search tier instead")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--n", type=int, default=5000)
    ap.add_argument("--segments", type=int, default=4,
                    help="frozen segments in the sharded index (the unit "
                         "of quarantine under --fault-sites segment)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="inject transient device-call faults at this "
                         "rate (seeded, deterministic; DESIGN.md §9)")
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--fault-sites", default=None,
                    help="comma-separated injector site filter, e.g. "
                         "'search' or 'segment' (the per-segment wildcard; "
                         "DESIGN.md §11). Default: the three classic sites")
    ap.add_argument("--min-coverage", type=float, default=0.0,
                    help="degraded-serving floor (DESIGN.md §11): waves "
                         "collected below this alive-coverage fraction "
                         "retry after segment recovery or FAIL their "
                         "requests with the achieved coverage attached")
    ap.add_argument("--state-dir", default=None,
                    help="durable index state: recover from this directory "
                         "if it holds a snapshot, else snapshot the fresh "
                         "build into it (inserts ride the WAL)")
    ap.add_argument("--compressed", action="store_true",
                    help="two-band verification over the int8 compressed "
                         "band (DESIGN.md §10): bitwise-identical results, "
                         "f32 row gathers only for screen survivors")
    ap.add_argument("--device", default="cuda",
                    help="where the model or the index lives and runs")
    args = ap.parse_args(argv)
    from repro_torch.launch.mesh import check_mesh_args

    check_mesh_args(ap, args)
    if args.retrieval:
        return serve_retrieval(args)
    return serve_lm(args)


if __name__ == "__main__":
    sys.exit(main())
