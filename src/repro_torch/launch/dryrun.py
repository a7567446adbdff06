"""Multi-pod dry-run: trace every (architecture x input shape) cell on the
production meshes with meta tensors, and count its per-device cost.

Counterpart of `repro.launch.dryrun`, which lowers and compiles each cell
for 256 or 512 fake XLA devices. Here a cell starts a fake process group
of 256 or 512 ranks as rank 0 (backend "fake" over
`torch.testing._internal.distributed.fake_pg.FakeStore`: every collective
returns at once and moves nothing), builds the (16, 16) or (2, 16, 16)
`DeviceMesh` over it and a `Runtime` as the reference builds it, and runs
the port's own train step, prefill or decode step once on the stand-ins of
`launch.specs` (meta tensors: shapes, dtypes and strides, no storage)
under `launch.op_cost.OpCost`, which counts flops, bytes, collectives by
kind and peak memory per device as the ops dispatch. `--device` names the
mesh's device type (cuda by default); nothing is allocated on it, so no
card is needed.

The fake group replaces the process's default group, so a cell refuses to
start while a real one is up (the reference's "run it as its own
process"); importing this module starts nothing.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama_1_1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --optimized \\
      --device cpu --out build/dryrun
Options as the reference's: --multi-pod (2x16x16 instead of 16x16),
--no-remat, --microbatches N, --explicit-tp, --seq-shard,
--moe-decode-gather, --full-dp, --weights-once, --optimized (the per-cell
settings of `optimized_settings`); --out writes one JSON per cell.

The roofline terms use the NVIDIA H100 SXM's data-sheet rates (below), not
the TPU v5e's of the reference.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
from contextlib import contextmanager
from pathlib import Path

from repro_torch.configs.base import ARCH_IDS, SHAPES, ShapeConfig, get_arch

# NVIDIA H100 SXM (data sheet), per card
PEAK_FLOPS = 989.4e12    # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12         # HBM3 bytes/s
# NVLink, bytes/s per direction: the link within a node of 8 cards. A
# group that spans nodes runs over the slower network, so there the
# collective term is a lower bound.
LINK_BW = 450e9

SKIP_REASON = ("full-attention arch; long_500k needs sub-quadratic attention "
               "(DESIGN.md §Arch-applicability)")


def mesh_layout(multi_pod: bool) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """The production mesh's (sizes, axis names), as
    `launch.mesh.make_production_mesh` names them."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


@contextmanager
def fake_group(world: int):
    """A fake process group of `world` ranks, this process rank 0, for the
    duration of the block. Refuses while a real group is up: the fake one
    would replace it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.dist import comm

    if dist.is_initialized():
        raise RuntimeError("a process group is up: the dry-run's fake group would replace it; "
                           "run the dry-run in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        comm.forget_groups()
        dist.destroy_process_group()


def trace(cfg, shape: ShapeConfig, rt, *, microbatches: int = 1, weights_once: bool = False,
          train_config=None):
    """Run the cell's step once on the meta stand-ins of `launch.specs`
    under an OpCost.

    Returns (OpCost, seconds). train: `make_train_step(cfg, rt, tc)` on
    `state_specs` and `batch_specs` (tc: train_config, else a TrainConfig
    of microbatches and weights_once); prefill: `prefill` on the
    parameters and the batch; decode: `decode_step` on the parameters and
    `decode_specs`."""
    import torch

    from repro_torch.launch.op_cost import OpCost
    from repro_torch.launch.specs import batch_specs, decode_specs, state_specs
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.train.step import TrainConfig, make_train_step

    cost = OpCost()
    t0 = time.perf_counter()
    if shape.kind == "train":
        tc = train_config or TrainConfig(microbatches=microbatches, weights_once=weights_once)
        state = state_specs(cfg, rt, tc.grad_compression)
        batch = batch_specs(cfg, shape, rt, microbatches=tc.microbatches)
        step = make_train_step(cfg, rt, tc)
        cost.track(state, batch)
        with cost:
            out = step(state, batch)
    elif shape.kind == "prefill":
        params = state_specs(cfg, rt)["params"]
        batch = batch_specs(cfg, shape, rt)
        cost.track(params, batch)
        with cost, torch.no_grad():
            out = prefill(params, batch, cfg, rt)
    else:
        params = state_specs(cfg, rt)["params"]
        tokens, cache, pos = decode_specs(cfg, shape, rt)
        cost.track(params, tokens, cache)
        with cost, torch.no_grad():
            out = decode_step(params, tokens, cache, pos, cfg, rt)
    cost.outputs(out)
    return cost, time.perf_counter() - t0


def roofline(per_device: dict) -> dict:
    """The three roofline terms, seconds: flops over the bf16 peak, eager
    bytes over HBM, collective bytes over NVLink."""
    return {
        "compute": per_device["flops"] / PEAK_FLOPS,
        "memory": per_device["bytes_accessed"] / HBM_BW,
        "collective": per_device["collective_bytes"] / LINK_BW,
    }


def run_cell(arch_id: str, shape_name: str, *, multi_pod: bool,
             remat: bool = True, microbatches: int = 1,
             rules: dict | None = None, verbose: bool = True,
             explicit_tp: bool = False, seq_shard: bool = False,
             moe_decode_gather: bool = False, full_dp: bool = False,
             weights_once: bool = False, device: str = "cuda") -> dict:
    """One cell on the production mesh: the reference's result keys, with
    `trace_s` for its `lower_s` / `compile_s`."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist.sharding import Runtime

    cfg = get_arch(arch_id)
    shape = SHAPES[shape_name]
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return {"arch": arch_id, "shape": shape_name,
                "mesh": "2x16x16" if multi_pod else "16x16", "status": "skipped",
                "reason": SKIP_REASON}
    sizes, names = mesh_layout(multi_pod)
    n_chips = math.prod(sizes)
    with fake_group(n_chips):
        mesh = init_device_mesh(torch.device(device).type, sizes, mesh_dim_names=names)
        rt = Runtime(mesh=mesh, remat=remat and shape.kind == "train",
                     rules=rules or {}, explicit_tp=explicit_tp,
                     seq_shard=seq_shard, moe_decode_gather=moe_decode_gather,
                     full_dp=full_dp)
        cost, seconds = trace(cfg, shape, rt, microbatches=microbatches,
                              weights_once=weights_once)
    per_device = cost.report()
    result = {
        "arch": arch_id,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "status": "ok",
        "trace_s": round(seconds, 1),
        "remat": rt.remat,
        "microbatches": microbatches,
        "n_chips": n_chips,
        "per_device": per_device,
        "collectives": cost.collectives,
        "roofline_seconds": roofline(per_device),
        "ops": cost.ops,
        "fallbacks": spec_fallbacks(cfg, shape, rt),
    }
    if verbose:
        pd, rf = per_device, result["roofline_seconds"]
        print(f"  {arch_id} x {shape_name} [{result['mesh']}]: "
              f"args={pd['argument_bytes'] / 2**30:.2f}GiB "
              f"temp={pd['temp_bytes'] / 2**30:.2f}GiB "
              f"flops={pd['flops']:.3g} coll={pd['collective_bytes'] / 2**20:.1f}MiB | "
              f"roofline c/m/x = {rf['compute']:.3g}/{rf['memory']:.3g}/"
              f"{rf['collective']:.3g}s (trace {seconds:.0f}s)", flush=True)
    return result


def spec_fallbacks(cfg, shape: ShapeConfig, rt) -> list:
    """The (logical axis, dim, axis size) of every dim of the cell's
    parameters (and decode caches) that its mesh axes do not divide, so
    that it stays whole (the reference's second fallback): a body whose
    heads, channels or columns fall back runs replicated over 'model'.
    Each triple once, in the specs' order."""
    from repro_torch.dist.sharding import logical_to_spec
    from repro_torch.models.model import cache_specs
    from repro_torch.models.params import _map_specs, param_specs
    from repro_torch.tree import leaves

    specs = leaves(_map_specs(lambda s: s, param_specs(cfg)))
    if shape.kind == "decode":
        specs += leaves(cache_specs(cfg, shape.global_batch, shape.seq_len))
    found: list = []
    for s in specs:
        logical_to_spec(s.logical, s.shape, rt, found)
    return [list(f) for f in dict.fromkeys(found)]


def optimized_settings(arch_id: str, shape_name: str) -> dict:
    """The reference's per-family winning settings, entry for entry:
      * weights-stationary MoE for all MoE decode cells;
      * full-DP (ZeRO-3, no TP) for <10B dense train cells;
      * gradient-accumulation microbatching for every other train cell
        (16 microbatches; deepseek 4).
    """
    cfg = get_arch(arch_id)
    shape = SHAPES[shape_name]
    s: dict = {}
    if cfg.moe and shape.kind == "decode":
        s["moe_decode_gather"] = True
    small = cfg.moe is None and cfg.param_count() < 10e9 and cfg.family == "dense"
    if small and shape.kind == "train":
        s["full_dp"] = True
    if shape.kind == "train":
        if s.get("full_dp"):
            pass     # one sequence a device already: no microbatching
        elif arch_id == "deepseek_v3_671b":
            s["microbatches"] = 4
        else:
            s["microbatches"] = 16
    return s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--explicit-tp", action="store_true")
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--moe-decode-gather", action="store_true")
    ap.add_argument("--full-dp", action="store_true")
    ap.add_argument("--weights-once", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the per-family winning settings (optimized_settings)")
    ap.add_argument("--out", type=str, default=None, help="write one JSON per cell here")
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device type (nothing is allocated on it)")
    args = ap.parse_args(argv)

    if args.all:
        todo = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all, required")
        todo = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results = []
    t0 = time.perf_counter()
    for arch_id, shape_name in todo:
        for mp in meshes:
            kw = dict(
                remat=not args.no_remat,
                microbatches=args.microbatches,
                explicit_tp=args.explicit_tp,
                seq_shard=args.seq_shard,
                moe_decode_gather=args.moe_decode_gather,
                full_dp=args.full_dp,
                weights_once=args.weights_once,
                device=args.device,
            )
            if args.optimized:
                kw.update(optimized_settings(arch_id, shape_name))
            try:
                r = run_cell(arch_id, shape_name, multi_pod=mp, **kw)
            except Exception as e:  # a failure here is a bug in the system
                traceback.print_exc()
                r = {"arch": arch_id, "shape": shape_name,
                     "mesh": "2x16x16" if mp else "16x16",
                     "status": "error", "error": f"{type(e).__name__}: {e}"}
            results.append(r)
            if args.out:
                path = Path(args.out)
                path.mkdir(parents=True, exist_ok=True)
                name = f"{arch_id}__{shape_name}__{r.get('mesh', 'na')}.json"
                (path / name).write_text(json.dumps(r, indent=2))
    bad = [r for r in results if r["status"] == "error"]
    print(f"\ndry-run: {len(results)} cells, {len(bad)} errors, "
          f"{time.perf_counter() - t0:.0f}s", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
