"""Training entry point with checkpoint/restart fault tolerance.

Counterpart of `repro.launch.train`, with its flags and its printed lines:

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama_1_1b \
      --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir CKPT_DIR
  # failure injection: crash at step 7 (exit code 42), then rerun with the
  # same --ckpt-dir to resume from the last checkpoint
  ... --fail-at-step 7

It runs on the CUDA card unless given --device cpu. Every arch trains. On
a mesh of --data x --model ranks, started by torch.distributed.run (the
ranks come from its environment), the state is placed by its specs and
only rank 0 prints and writes metrics:

  python -m torch.distributed.run --nproc-per-node 2 \
      -m repro_torch.launch.train --smoke --data 2 --device cpu ...

Use launch/supervisor.py for automatic restart on failure.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from repro_torch.configs.base import get_arch


def state_skeleton(cfg, tc) -> dict:
    """The training state's tree, leaves None (restore fills them)."""
    from repro_torch.models.params import _map_specs, param_specs

    tree = _map_specs(lambda s: None, param_specs(cfg))
    state = {"params": tree, "opt": {"m": tree, "v": tree, "step": None}}
    if tc.grad_compression:
        state["err"] = tree
    return state


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama_1_1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--data", type=int, default=1, help="data mesh axis size")
    ap.add_argument("--model", type=int, default=1, help="model mesh axis size")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--fail-at-step", type=int, default=-1,
                    help="crash deliberately at this step (fault-tolerance test)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--metrics-out", type=str, default=None)
    ap.add_argument("--device", default="cuda", help="where the model lives and trains")
    args = ap.parse_args(argv)

    from repro_torch.launch.mesh import check_mesh_args, runtime_from_args

    check_mesh_args(ap, args)
    cfg = get_arch(args.arch, smoke=args.smoke)

    import torch

    rt, dev = runtime_from_args(args, remat=args.remat)
    try:
        return _train(args, cfg, rt, dev)
    finally:
        if rt.distributed:
            torch.distributed.destroy_process_group()


def _train(args, cfg, rt, dev) -> int:
    import torch

    from repro_torch.checkpoint.store import AsyncCheckpointer, latest_step, restore_checkpoint
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.dist.sharding import process_index
    from repro_torch.train.monitor import HeartbeatMonitor
    from repro_torch.train.step import (
        TrainConfig,
        init_train_state,
        make_train_step,
        train_state_specs,
    )

    lead = process_index() == 0     # prints, heartbeats and writes metrics
    tc = TrainConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                     total_steps=args.steps, microbatches=args.microbatches,
                     grad_compression=args.grad_compression)
    pipe = SyntheticTokenPipeline(cfg, args.batch, args.seq, seed=args.seed, device=dev)
    step_fn = make_train_step(cfg, rt, tc)

    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        skeleton = train_state_specs(cfg, tc) if rt.distributed else state_skeleton(cfg, tc)
        state, start = restore_checkpoint(args.ckpt_dir, skeleton, rt if rt.distributed else dev)
        start += 1
        if lead:
            print(f"resumed from step {start - 1}", flush=True)
    else:
        state = init_train_state(cfg, rt, tc, torch.Generator(device=dev).manual_seed(args.seed),
                                 device=dev)

    ckpt = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    hb = HeartbeatMonitor(f"{args.ckpt_dir}/heartbeat.json") if args.ckpt_dir and lead else None
    losses = []
    for step in range(start, args.steps):
        if step == args.fail_at_step:
            if lead:
                print(f"FAULT-INJECTION: crashing at step {step}", flush=True)
            sys.stdout.flush()
            raise SystemExit(42)
        batch = pipe.batch(step)
        if tc.microbatches > 1:
            batch = {k: a.reshape(tc.microbatches, a.shape[0] // tc.microbatches, *a.shape[1:])
                     for k, a in batch.items()}
        t0 = time.time()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if hb:
            hb.beat(step, {"loss": loss})
        if lead and step % args.log_every == 0:
            print(f"step {step}: loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({time.time() - t0:.2f}s)", flush=True)
        if ckpt and (step + 1) % args.save_every == 0:
            ckpt.save(step, state)
    if ckpt:
        ckpt.save(args.steps - 1, state)
        ckpt.wait()
    if lead and args.metrics_out:
        Path(args.metrics_out).write_text(json.dumps({"losses": losses}))
    if lead:
        print(f"done: final loss {losses[-1] if losses else float('nan'):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
