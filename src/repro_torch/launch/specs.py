"""Zero-allocation stand-ins for every model input: the dry-run contract.

Counterpart of `repro.launch.specs`, whose `ShapeDtypeStruct`s carry a
global shape, a dtype and a sharding. Here each stand-in is a tensor on
the meta device (shape, dtype and strides, no storage): on a mesh a
DTensor over a meta local shard, `DTensor.from_local(shard, mesh,
placements(...), shape=..., stride=...)`, placed by `logical_to_spec` as
the reference places it; with no mesh a plain meta tensor. Meta rather
than `FakeTensorMode` tensors: ops on them dispatch as on real tensors
(a FakeTensor's device query dispatches an op of its own), and
`launch.op_cost` can answer repeated ops from a metadata cache, which
makes a 32k-token prefill's trace about five times quicker.

`decode_specs` places the caches by their own specs (`cache_specs`'
logical axes: batch over dp, cache_seq and inner over 'model'), as
`models.model._place_cache` and the reference's `init_cache` place them.
Its position is a Python int, as `models.model.decode_step` takes it:
the last slot of the cache (the decode attends every slot whatever it is).
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.dist.sharding import (
    Runtime,
    logical_to_spec,
    mesh_shape,
    placements,
    spec_axes,
)
from repro_torch.models.model import cache_specs
from repro_torch.models.params import _map_specs


def _sds(shape, dtype, rt: Runtime, logical):
    """One stand-in of global `shape` and `dtype`, placed by `logical`."""
    shape = tuple(int(s) for s in shape)
    if not rt.distributed:
        return torch.empty(shape, dtype=dtype, device="meta")
    from torch.distributed.tensor import DTensor

    spec = logical_to_spec(logical, shape, rt)
    sizes = mesh_shape(rt.mesh)
    local = tuple(d // math.prod(sizes[a] for a in spec_axes(e)) for d, e in zip(shape, spec))
    shard = torch.empty(local, dtype=dtype, device="meta")
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(shard, rt.mesh, placements(spec, rt.mesh), run_check=False,
                              shape=torch.Size(shape), stride=stride)


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, rt: Runtime, microbatches: int = 1) -> dict:
    """Train / prefill batch stand-ins (tokens or stub-frontend frames, and
    labels for training), batch over dp; with microbatches > 1 each leaf
    is (microbatches, global_batch / microbatches, ...)."""
    gb, s = shape.global_batch, shape.seq_len
    if microbatches > 1:
        if gb % microbatches:
            raise ValueError(f"global batch {gb} does not divide into {microbatches} "
                             f"microbatches")
        gb = gb // microbatches

    def lead(dims, logical):
        if microbatches > 1:
            return (microbatches, *dims), (None, *logical)
        return dims, logical

    out = {}
    if cfg.frontend and shape.kind in ("train", "prefill"):
        dims, logical = lead((gb, s, cfg.frontend_dim), ("batch", None, None))
        out["frames"] = _sds(dims, torch.bfloat16, rt, logical)
    else:
        dims, logical = lead((gb, s), ("batch", None))
        out["tokens"] = _sds(dims, torch.int32, rt, logical)
    if shape.kind == "train":
        dims, logical = lead((gb, s), ("batch", None))
        out["labels"] = _sds(dims, torch.int32, rt, logical)
    return out


def decode_specs(cfg: ArchConfig, shape: ShapeConfig, rt: Runtime):
    """(tokens, cache, pos) for `decode_step`: tokens (B, 1) over dp, the
    cache tree of `cache_specs` placed by its specs, and pos = seq_len - 1."""
    gb, s = shape.global_batch, shape.seq_len
    tokens = _sds((gb, 1), torch.int32, rt, ("batch", None))
    cache = _map_specs(lambda spec: _sds(spec.shape, spec.dtype, rt, spec.logical),
                       cache_specs(cfg, gb, s))
    return tokens, cache, s - 1


def state_specs(cfg: ArchConfig, rt: Runtime, grad_compression: bool = False) -> dict:
    """Train-state stand-ins from `train.step.train_state_specs`: the
    parameters at their specs' dtypes (bf16 but for a few f32 leaves), f32
    AdamW moments (and error buffers under grad_compression) placed like
    their parameters, and a 0-d int32 step."""
    from repro_torch.train.step import TrainConfig, train_state_specs

    specs = train_state_specs(cfg, TrainConfig(grad_compression=grad_compression))
    step = specs["opt"].pop("step")
    state = _map_specs(lambda s: _sds(s.shape, s.dtype, rt, s.logical), specs)
    # a plain tensor on every rank, as `optim.adamw.adamw_init` makes it
    state["opt"]["step"] = _sds(step.shape, step.dtype, Runtime(), step.logical)
    return state
