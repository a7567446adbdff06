"""Train step factory: loss -> grads -> (compress) -> AdamW, with optional
microbatch gradient accumulation and activation remat (`Runtime.remat`).

Counterpart of `repro.train.step`, on one card. The reference jits the
step and donates the state; here the step runs eagerly and AdamW updates
the parameters and moments in place, so the state is held once.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.sharding import Runtime
from repro_torch.models.model import loss_fn
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
    weights_once: bool = False     # the reference pre-gathers the FSDP-sharded
    #                                weights once a step; on one card the
    #                                weights are whole, so it does nothing
    b1: float = 0.9
    b2: float = 0.95


def make_train_step(cfg: ArchConfig, rt: Runtime, tc: TrainConfig):
    """Returns train_step(state, batch) -> (state, metrics).

    state = {"params", "opt" {m, v, step}, ["err"]}; the step updates the
    parameters and moments in place. batch leaves have leading dim
    global_batch, or (microbatches, global_batch / microbatches) when
    accumulating. metrics: the loss metrics (of the last microbatch, as in
    the reference), "grad_norm" and "lr", as 0-d tensors.

    `train_step.compute_grads(params, batch)` -> (grads, metrics) is the
    step's gradient of one (micro)batch: a tree of params' structure at the
    parameters' dtypes."""
    schedule = cosine_schedule(tc.lr, tc.warmup_steps, tc.total_steps)

    def compute_grads(params, batch):
        p_l = leaves(params)
        live = [p.detach().requires_grad_() for p in p_l]
        with torch.enable_grad():
            loss, metrics = loss_fn(unflatten(params, live), batch, cfg, rt)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        # a leaf the loss does not reach (a frontend arch's embedding) gets
        # zeros, as jax.grad gives it
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(p_l, grads)]
        return unflatten(params, grads), {k: v.detach() for k, v in metrics.items()}

    def train_step(state, batch):
        params = state["params"]
        # tc.weights_once: the pre-gather is the identity on one card
        if tc.microbatches > 1:
            g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in leaves(params)]
            for i in range(tc.microbatches):
                g, metrics = compute_grads(params, {k: v[i] for k, v in batch.items()})
                for a, b in zip(g_acc, leaves(g)):
                    a.add_(b.float())
                del g
            grads = unflatten(params, [a / tc.microbatches for a in g_acc])
            del g_acc
        else:
            grads, metrics = compute_grads(params, batch)

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
    "err" (f32 zeros) under grad_compression}, on device."""
    from repro_torch.models.model import init_params
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.compression import compression_init

    del rt
    params = init_params(cfg, generator, device=device)
    state = {"params": params, "opt": adamw_init(params)}
    if tc.grad_compression:
        state["err"] = compression_init(params)
    return state
