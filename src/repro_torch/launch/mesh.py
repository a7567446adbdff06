"""Mesh construction (counterpart of `repro.launch.mesh`).

`make_local_mesh` builds a `DeviceMesh` of named axes ("data", "model")
over the initialised process group. Started by `torch.distributed.run`,
the group comes from its environment (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
`MASTER_ADDR` / `MASTER_PORT`); a one-rank mesh with no group starts a
group of its own over a file store in a temporary directory, so that
concurrent test workers never race for a TCP port. On the CUDA card the
group is NCCL, on the CPU gloo.

The production meshes (16 x 16, or 2 x 16 x 16 with a 'pod' axis) have
256 or 512 ranks, which exist only as `AbstractMesh`es: axis names and
sizes for the sharding rules and the dry-run.
"""

from __future__ import annotations

import os
import tempfile
from datetime import timedelta

from repro_torch.dist.sharding import AbstractMesh, abstract_mesh

GROUP_TIMEOUT = timedelta(seconds=120)   # a rank left waiting fails instead of hanging


def _start_group(device) -> None:
    import torch
    import torch.distributed as dist

    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {}
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)
        kw["device_id"] = dev
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, timeout=GROUP_TIMEOUT, **kw)
        return
    path = os.path.join(tempfile.mkdtemp(prefix="repro_torch_store_"), "store")
    store = dist.FileStore(path, 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1,
                            timeout=GROUP_TIMEOUT, **kw)


def make_local_mesh(data: int = 1, model: int = 1, device="cuda"):
    """A (data, model) DeviceMesh over the process group, started here when
    none is up (from `torch.distributed.run`'s environment, or one rank
    over a file store when data * model == 1). Raises when data * model
    is not the group's size."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        if data * model != 1 and "RANK" not in os.environ:
            raise RuntimeError(f"a ({data}, {model}) mesh needs {data * model} ranks: start "
                               f"them with torch.distributed.run")
        _start_group(device)
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"a ({data}, {model}) mesh over a group of {world} ranks")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else int(os.environ.get("LOCAL_RANK", 0)))
    return init_device_mesh(dev.type, (data, model), mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16x16 single pod (256 ranks) or 2x16x16 two-pod (512 ranks).

    Axis semantics: 'pod' = inter-pod DP, 'data' = intra-pod DP/FSDP,
    'model' = tensor/expert parallelism."""
    if multi_pod:
        return abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    return abstract_mesh((16, 16), ("data", "model"))


def mesh_with_stage_axis(stages: int, data: int, model: int) -> AbstractMesh:
    """The reference's pipeline-parallel mesh hook (unused by its baseline)."""
    return abstract_mesh((stages, data, model), ("stage", "data", "model"))


def check_mesh_args(ap, args) -> None:
    """A command line's --data x --model of more than one rank needs
    `torch.distributed.run` to have started the ranks: else ap.error."""
    if args.data * args.model > 1 and "RANK" not in os.environ:
        ap.error(f"--data {args.data} --model {args.model}: a mesh of "
                 f"{args.data * args.model} ranks; start them with "
                 f"python -m torch.distributed.run --nproc-per-node "
                 f"{args.data * args.model} -m ...")


def runtime_from_args(args, **flags):
    """(Runtime, device) of a command line's --data, --model and --device:
    no mesh for 1 x 1 outside `torch.distributed.run` (one card, no
    group), else a `make_local_mesh` over the launcher's ranks, each on its
    LOCAL_RANK's card. flags: the Runtime's other fields."""
    import torch

    from repro_torch.dist.sharding import Runtime

    dev = torch.device(args.device)
    if dev.type == "cuda":
        # keep every f32 and bf16 product's partial sums in f32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    if args.data * args.model == 1 and "RANK" not in os.environ:
        return Runtime(**flags), dev
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return Runtime(mesh=make_local_mesh(args.data, args.model, device=dev), **flags), dev
