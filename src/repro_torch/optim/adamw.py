"""AdamW with f32 moments over bf16 (or f32) parameters.

Counterpart of `repro.optim.adamw`, with its formula: a global-norm clip in
f32 (1e-12 inside the square root), bias correction,
u = (m / bc1) / (sqrt(v / bc2) + eps), weight decay only on leaves with
ndim >= 2 and added to u (not applied before the update, as
`torch.optim.AdamW` does, nor to every leaf), the update in f32 and cast
back to the parameter's dtype.

The reference donates its state, so a step holds one copy of it; here the
update writes the parameters and moments in place (under `no_grad`), one
leaf at a time, for the same memory. Every value stays on the parameters'
device: the step count, the learning rate and the grad norm are 0-d
tensors, so a step needs no host sync.

On a mesh the leaves are DTensors and each rank updates its shards: the
global norm sums each leaf's local squares over the mesh axes that leaf is
sharded on (and only those: a replicated dim's squares are the same on
every rank), one all-reduce per set of axes (`sharded_sum`).
"""

from __future__ import annotations

import math

import torch

from repro_torch.dist.sharding import is_dtensor, local
from repro_torch.tree import leaves, tree_map


def zeros_like_f32(p):
    """f32 zeros shaped and placed like p (a tensor or a DTensor)."""
    if is_dtensor(p):
        from torch.distributed.tensor import DTensor

        z = torch.zeros(p.to_local().shape, dtype=torch.float32, device=p.to_local().device)
        return DTensor.from_local(z, p.device_mesh, p.placements, run_check=False,
                                  shape=p.shape, stride=p.stride())
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def sharded_sum(values: list, params: list) -> list:
    """Each 0-d local value summed over the mesh axes its parameter is
    sharded on (one all-reduce per set of axes); off a mesh as it is."""
    from torch.distributed.tensor import Shard

    from repro_torch.dist import comm
    from repro_torch.dist.sharding import Runtime

    out = list(values)
    groups: dict = {}
    for i, p in enumerate(params):
        if is_dtensor(p):
            axes = tuple(a for a, q in zip(p.device_mesh.mesh_dim_names, p.placements)
                         if isinstance(q, Shard))
            if axes:
                groups.setdefault((p.device_mesh, axes), []).append(i)
    for (mesh, axes), idx in groups.items():
        summed = comm.all_reduce(torch.stack([values[i] for i in idx]), Runtime(mesh=mesh), axes)
        for j, i in enumerate(idx):
            out[i] = summed[j]
    return out


def adamw_init(params) -> dict:
    """{"m", "v": f32 zeros shaped (and placed) like each leaf, "step":
    int32 0-d 0}."""
    device = local(leaves(params)[0]).device
    return {"m": tree_map(zeros_like_f32, params), "v": tree_map(zeros_like_f32, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """lr(step): linear warm-up over `warmup` steps, then a cosine from
    base_lr to 0 at `total`; step an int tensor, the result f32."""

    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return lr


@torch.no_grad()
def adamw_update(params, grads, state: dict, lr, *, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1, grad_clip: float = 1.0):
    """One AdamW step, in place. lr: a float, or a schedule fn of the new
    step count. grads: a tree of params' structure, any float dtype.

    Returns (params, {"m", "v", "step"}, {"grad_norm", "lr"}): the same
    parameter and moment tensors, updated, and a new step tensor."""
    step = state["step"] + 1
    lr_t = lr(step) if callable(lr) else lr
    p_tree = leaves(params)
    p_l, g_l, m_l, v_l = ([local(x) for x in leaves(t)]
                          for t in (params, grads, state["m"], state["v"]))

    # global-norm clip in f32
    sq = sharded_sum([torch.sum(g.float() * g.float()) for g in g_l], p_tree)
    gnorm = torch.sqrt(sum(sq) + 1e-12)
    scale = torch.clamp(grad_clip / gnorm, max=1.0)
    step_f = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, step_f)
    bc2 = 1 - torch.pow(b2, step_f)
    for p, g, m, v in zip(p_l, g_l, m_l, v_l):
        g32 = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * g32 * g32)
        del g32
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        p32 = p.float()
        if p.ndim >= 2:
            u += weight_decay * p32
        p.copy_((p32 - lr_t * u).to(p.dtype))
    return params, {"m": state["m"], "v": state["v"], "step": step}, {
        "grad_norm": gnorm, "lr": lr_t}
