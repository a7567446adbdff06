"""Explicit collectives over a Runtime's mesh axes.

The reference writes its collectives inside `shard_map` (`all_gather`,
`psum`, `all_to_all` over named axes) or lets GSPMD place them. Here each
is one `torch.distributed` call on the process group of the named mesh
axes: `DeviceMesh.get_group` for one axis, a group made once per mesh for a
tuple of axes (ranks in the tuple's linearized order, the first axis
major). On a (1, 1) mesh every call is still a real launch of size 1.

Under autograd, a collective's backward depends on what consumes its
output. Two ops carry the Megatron pair for the 'model' axis, where every
rank runs the same computation on the same values outside the explicitly
split bodies:

  copy_to(x)    identity forward, sum over the axes in the backward: a
                replicated tensor entering a body that each rank computes
                only a part of (its experts, its f-columns);
  reduce_from(x)  sum forward, identity backward: a body's partial
                outputs summed into a value that every rank then consumes
                alike (its cotangent is already the same on every rank).

`gather_grad` (all-gather forward, reduce-scatter backward) and
`sum_grad` (sum both ways) serve the weights-stationary decode MoE, whose
gathered tokens and dp-summed products feed computations that differ per
rank, and the SSD's gated norm, whose sum of squares spans the 'model'
ranks' heads. `all_to_all` inverts itself in the backward.

A weight is gathered at its use (`gather_at_use`, called by
`dist.sharding.at_use` and `full`) over one mesh dim's group: the
backward either reduce-scatters the cotangent back to this rank's shard
(the ranks along that dim computed on different rows, or on different
parts of a split body, so their cotangents are partial sums), or keeps
this rank's slice of it (the ranks computed alike: every one holds the
whole cotangent already).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import _disable_current_modes

_GROUPS: dict = {}


def group(rt, axes: tuple[str, ...]):
    """The process group over `axes` of rt.mesh (made on first use: every
    rank must ask for the same groups in the same order)."""
    mesh = rt.mesh
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(dist.group.WORLD), mesh, tuple(axes))   # a new default group makes new groups
    if key not in _GROUPS:
        names = list(mesh.mesh_dim_names)
        rest = [i for i, a in enumerate(names) if a not in axes]
        sel = [names.index(a) for a in axes]
        # the rank grid read with every dispatch mode off and arranged in
        # numpy: inside the dry-run's cost counter it is no op of the step
        with _disable_current_modes():
            grid = mesh.mesh.tolist()
        ranks = np.array(grid).transpose(*rest, *sel)
        _GROUPS[key], _ = dist.new_subgroups_by_enumeration(
            ranks.reshape(-1, _prod(mesh, axes)).tolist())
    return _GROUPS[key]


def forget_groups() -> None:
    """Drop the groups made so far (their process group is gone)."""
    _GROUPS.clear()


def _prod(mesh, axes) -> int:
    names = list(mesh.mesh_dim_names)
    n = 1
    for a in axes:
        n *= mesh.shape[names.index(a)]
    return n


def all_reduce(x: torch.Tensor, rt, axes: tuple[str, ...], op: str = "sum") -> torch.Tensor:
    """Out-of-place sum (or max) over the axes' group."""
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                    group=group(rt, axes))
    return y


def all_gather(x: torch.Tensor, rt, axes: tuple[str, ...], dim: int) -> torch.Tensor:
    """The group's pieces concatenated along dim, in group-rank order."""
    return _gather(x, group(rt, axes), dim)


def _gather(x: torch.Tensor, g, dim: int) -> torch.Tensor:
    x = x.contiguous()     # empty_like keeps a permuted input's strides
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(g))]
    dist.all_gather(parts, x, group=g)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def reduce_scatter(x: torch.Tensor, rt, axes: tuple[str, ...], dim: int) -> torch.Tensor:
    """The sum over the group, of which this rank keeps its 1/n of dim."""
    return _reduce_scatter(x, group(rt, axes), dim)


def _reduce_scatter(x: torch.Tensor, g, dim: int) -> torch.Tensor:
    n = dist.get_world_size(g)
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((xm.shape[0] // n, *xm.shape[1:]), dtype=x.dtype, device=x.device)
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, xm, group=g)
    return out.movedim(0, dim)


def _all_to_all(x: torch.Tensor, rt, axes) -> torch.Tensor:
    x = x.contiguous()     # empty_like keeps a permuted input's strides
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group(rt, axes))
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rt, axes):
        ctx.rt, ctx.axes = rt, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.rt, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rt, axes):
        return all_reduce(x, rt, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rt, axes):
        ctx.rt, ctx.axes = rt, axes
        return all_reduce(x, rt, axes)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.rt, ctx.axes), None, None


class _GatherGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rt, axes, dim):
        ctx.rt, ctx.axes, ctx.dim = rt, axes, dim
        return all_gather(x, rt, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.rt, ctx.axes, ctx.dim), None, None, None


class _GatherAtUse(torch.autograd.Function):
    """All-gather along dim over group g; the backward reduce-scatters the
    cotangent (summed) or keeps this rank's slice of it."""

    @staticmethod
    def forward(ctx, x, g, dim, summed):
        ctx.g, ctx.dim, ctx.summed = g, dim, summed
        return _gather(x, g, dim)

    @staticmethod
    def backward(ctx, grad):
        g, dim = ctx.g, ctx.dim
        if ctx.summed:
            return _reduce_scatter(grad, g, dim), None, None, None
        n = grad.shape[dim] // dist.get_world_size(g)
        return grad.narrow(dim, dist.get_rank(g) * n, n), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rt, axes):
        ctx.rt, ctx.axes = rt, axes
        return _all_to_all(x, rt, axes)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.rt, ctx.axes), None, None


class _SeqReshard(torch.autograd.Function):
    """Keep this rank's slice of dim, then all-gather it back: the value
    is unchanged; so is the cotangent, whose slices are gathered alike."""

    @staticmethod
    def forward(ctx, x, rt, axes, dim):
        ctx.rt, ctx.axes, ctx.dim = rt, axes, dim
        return all_gather(_mine(x, rt, axes, dim), rt, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(_mine(g, ctx.rt, ctx.axes, ctx.dim), ctx.rt, ctx.axes,
                          ctx.dim), None, None, None


def _mine(x, rt, axes, dim):
    n = dist.get_world_size(group(rt, axes))
    step = x.shape[dim] // n
    return x.narrow(dim, rt.linear_rank(axes) * step, step)


def copy_to(x, rt, axes):
    return _CopyTo.apply(x, rt, tuple(axes))


def reduce_from(x, rt, axes):
    return _ReduceFrom.apply(x, rt, tuple(axes))


def sum_grad(x, rt, axes):
    return _SumGrad.apply(x, rt, tuple(axes))


def gather_grad(x, rt, axes, dim: int):
    return _GatherGrad.apply(x, rt, tuple(axes), dim)


def gather_at_use(x, g, dim: int, summed: bool):
    """x's pieces over group g concatenated along dim (`_GatherAtUse`)."""
    return _GatherAtUse.apply(x, g, dim, summed)


def all_to_all(x, rt, axes):
    """Split dim 0 into the group's n blocks, send block j to rank j, and
    stack what arrives by source rank (the reference's tiled all_to_all
    on axis 0)."""
    return _AllToAll.apply(x, rt, tuple(axes))


def seq_reshard(x, rt, axes, dim: int):
    return _SeqReshard.apply(x, rt, tuple(axes), dim)


def gather_shards(local: torch.Tensor, placements, mesh) -> torch.Tensor:
    """A DTensor's local shard -> the full tensor: an all-gather over each
    mesh dim the tensor is sharded on, the last mesh dim first, so a dim
    split over two mesh dims reassembles in their order."""
    from torch.distributed.tensor import Shard

    x = local
    for i in reversed(range(len(placements))):
        p = placements[i]
        if isinstance(p, Shard):
            x = _gather(x, mesh.get_group(mesh.mesh_dim_names[i]), p.dim)
    return x
