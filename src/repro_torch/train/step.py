"""Train step factory: loss -> grads -> (compress) -> AdamW, with optional
microbatch gradient accumulation and activation remat (`Runtime.remat`).

Counterpart of `repro.train.step`. The reference jits the step and donates
the state; here the step runs eagerly and AdamW updates the parameters and
moments in place, so the state is held once.

On a mesh the state's leaves are DTensors placed by `logical_to_spec`
(`init_train_state`, `dist.sharding.distribute_params`), and every rank
is given the same global batch. A (micro)batch's gradient is taken with
respect to each rank's shards, on this rank's dp rows of the microbatch
(`models.model._rows`: the reference's `_constrain_mb`, dp on the rows
of each (microbatches, gb / mb) slice). Each weight is gathered inside
the layer that uses it (`dist.sharding.at_use`: over dp, and over
'model' only where the body that consumes it is not split there; under
remat the recompute gathers again), and the gather's backward
reduce-scatters the gradient back to this rank's shard: no weight and no
gradient exists whole, beyond one layer's weights at a time. The
microbatches accumulate the shards in f32, and `_reduce_grads` adds the
all-reduce for the leaves replicated over dp. Under weights_once the
weights are gathered over dp once a step, outside the microbatch loop
(the reference's `_pregather`; the 'model' shards stay), and the
accumulated gradients are reduce-scattered over dp at the end.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import comm
from repro_torch.dist.sharding import Runtime, is_dtensor, local
from repro_torch.models.model import _layer, loss_fn
from repro_torch.optim.adamw import adamw_update, cosine_schedule
from repro_torch.train.compression import compress_decompress_grads
from repro_torch.tree import leaves, unflatten


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    microbatches: int = 1          # gradient accumulation factor
    grad_compression: bool = False  # int8 + error feedback
    weights_once: bool = False     # gather the sharded weights once a step,
    #                                outside the microbatch loop (a full copy
    #                                resident across it); off a mesh the
    #                                weights are whole and it does nothing
    b1: float = 0.9
    b2: float = 0.95


def _reduce_grads(grads: list, params: list, rt: Runtime, used: list | None = None) -> list:
    """Each leaf's gradient of this rank's shard -> its sum over dp, as
    DTensors placed like the parameters.

    The gathers at use (`dist.sharding.at_use`) already reduce-scatter
    over the dp axes a leaf is sharded on, so what is left is the
    all-reduce over the dp axes it is replicated on (each dp rank's rows
    gave a part). used: the placements the gradients were taken against,
    where they differ from the parameters' (weights_once's copy gathered
    over dp): a dp axis the parameter is sharded on and the copy was not
    is reduce-scattered here."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.dist.sharding import mesh_names

    names = mesh_names(rt.mesh)
    dp = set(rt.dp_axes)
    out = []
    for i, (g, p) in enumerate(zip(grads, params)):
        pl = p.placements
        upl = pl if used is None else used[i]
        rep = tuple(a for a, q in zip(names, pl) if a in dp and not isinstance(q, Shard))
        if rep:
            g = comm.all_reduce(g, rt, rep)
        by_dim: dict[int, list[str]] = {}
        for a, q, u in zip(names, pl, upl):
            if isinstance(q, Shard) and a in dp and not isinstance(u, Shard):
                by_dim.setdefault(q.dim, []).append(a)
        for dim, axes in by_dim.items():
            g = comm.reduce_scatter(g, rt, tuple(axes), dim)
        out.append(DTensor.from_local(g.contiguous(), p.device_mesh, pl, run_check=False,
                                      shape=p.shape, stride=p.stride()))
    return out


def _placed(local_tensor: torch.Tensor, like, placements=None):
    """local_tensor as a DTensor placed like `like` (or by `placements`),
    differentiable to the local tensor; a plain tensor as it is."""
    if not is_dtensor(like):
        return local_tensor
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local_tensor, like.device_mesh, placements or like.placements,
                              run_check=False, shape=like.shape, stride=like.stride())


def _gathered_over_dp(p, rt: Runtime):
    """(this rank's shard of p gathered over the dp axes it is sharded on,
    its placements: Replicate on those axes): weights_once's copy, which
    keeps the 'model' shards."""
    if not is_dtensor(p):
        return p, None
    from torch.distributed.tensor import Replicate, Shard

    names = p.device_mesh.mesh_dim_names
    dp = set(rt.dp_axes)
    y = p.to_local()
    pl = list(p.placements)
    for i in reversed(range(len(names))):
        if names[i] in dp and isinstance(pl[i], Shard):
            y = comm.all_gather(y, rt, (names[i],), pl[i].dim)
            pl[i] = Replicate()
    return _placed(y, p, tuple(pl)), tuple(pl)


def make_train_step(cfg: ArchConfig, rt: Runtime, tc: TrainConfig):
    """Returns train_step(state, batch) -> (state, metrics).

    state = {"params", "opt" {m, v, step}, ["err"]}; the step updates the
    parameters and moments in place. batch leaves have leading dim
    global_batch, or (microbatches, global_batch / microbatches) when
    accumulating. metrics: the loss metrics (of the last microbatch, as in
    the reference), "grad_norm" and "lr", as 0-d tensors.

    `train_step.compute_grads(params, batch)` -> (grads, metrics) is the
    step's gradient of one (micro)batch: a tree of params' structure at the
    parameters' dtypes (on a mesh, the gradient of this rank's shard of
    each leaf: summed over the dp axes the leaf is sharded on, not yet
    over those it is replicated on)."""
    schedule = cosine_schedule(tc.lr, tc.warmup_steps, tc.total_steps)

    def compute_grads(params, batch):
        p_l = leaves(params)
        live = [local(p).detach().requires_grad_() for p in p_l]
        with torch.enable_grad():
            placed = [_placed(x, p) for x, p in zip(live, p_l)]
            loss, metrics = loss_fn(unflatten(params, placed), batch, cfg, rt)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        # a leaf the loss does not reach (a frontend arch's embedding) gets
        # zeros, as jax.grad gives it
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(live, grads)]
        return unflatten(params, grads), {k: v.detach() for k, v in metrics.items()}

    def train_step(state, batch):
        params = state["params"]
        sharded = any(is_dtensor(p) for p in leaves(params))
        fwd, used = params, None
        if sharded and tc.weights_once:
            pairs = [_gathered_over_dp(p, rt) for p in leaves(params)]
            fwd, used = unflatten(params, [a for a, _ in pairs]), [b for _, b in pairs]
        if tc.microbatches > 1:
            g_acc = None
            for i in range(tc.microbatches):
                g, metrics = compute_grads(fwd, {k: _layer(v, i) for k, v in batch.items()})
                if g_acc is None:
                    g_acc = [torch.zeros(b.shape, dtype=torch.float32, device=b.device)
                             for b in leaves(g)]
                for a, b in zip(g_acc, leaves(g)):
                    a.add_(b.float())
                del g
            grads = [a / tc.microbatches for a in g_acc]
            del g_acc
        else:
            grads, metrics = compute_grads(fwd, batch)
            grads = leaves(grads)
        del fwd
        if sharded:
            grads = _reduce_grads(grads, leaves(params), rt, used)
        grads = unflatten(params, grads)

        if tc.grad_compression:
            grads, new_err = compress_decompress_grads(grads, state["err"])
        new_params, new_opt, opt_metrics = adamw_update(
            params, grads, state["opt"], schedule, b1=tc.b1, b2=tc.b2,
            weight_decay=tc.weight_decay, grad_clip=tc.grad_clip)
        new_state = {"params": new_params, "opt": new_opt}
        if tc.grad_compression:
            new_state["err"] = new_err
        return new_state, {**metrics, **opt_metrics}

    train_step.compute_grads = compute_grads
    return train_step


def init_train_state(cfg: ArchConfig, rt: Runtime, tc: TrainConfig,
                     generator: torch.Generator, device="cuda") -> dict:
    """{"params": bf16 init_params from generator, "opt": adamw_init, and
    "err" (f32 zeros) under grad_compression}, on device; on a mesh every
    leaf placed by its spec (the moments and error buffers like their
    parameters)."""
    from repro_torch.dist.sharding import distribute_params
    from repro_torch.models.model import init_params
    from repro_torch.models.params import param_specs
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.compression import compression_init

    params = init_params(cfg, generator, device=device)
    if rt.distributed:
        params = distribute_params(params, param_specs(cfg), rt)
    state = {"params": params, "opt": adamw_init(params)}
    if tc.grad_compression:
        state["err"] = compression_init(params)
    return state


def train_state_specs(cfg: ArchConfig, tc: TrainConfig):
    """The training state's ParamSpec tree (moments and error buffers f32
    under their parameters' logical axes, the step a 0-d int32):
    `checkpoint.store.restore_checkpoint`'s skeleton for placing a state
    on a mesh."""
    from dataclasses import replace

    from repro_torch.models.params import ParamSpec, _map_specs, param_specs

    p = _map_specs(lambda s: s, param_specs(cfg))
    f32 = _map_specs(lambda s: replace(s, dtype=torch.float32), p)
    state = {"params": p, "opt": {"m": f32, "v": f32,
                                  "step": ParamSpec((), (), torch.int32)}}
    if tc.grad_compression:
        state["err"] = f32
    return state
