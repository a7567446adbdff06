"""Tensor-parallel FFN products: the dense FFN's and the shared experts'
split over 'ff' on a mesh (whenever the spec shards 'ff'), and the
rt.explicit_tp path.

Counterpart of `repro.dist.tp`. Layout contract of the param specs:

  wi (d, f)  logical ('embed', 'ff')  -> (dp-sharded, 'model'-sharded)
  wo (f, d)  logical ('ff', 'embed')  -> ('model'-sharded, dp-sharded)

col_matmul_ffn produces activations column-sharded on f over 'model';
row_matmul_ffn contracts the f shards and completes with a sum over
'model', returning the activation replicated over 'model' (batch stays
dp-sharded throughout). The reference's `shard_map` bodies see local
shards; here the caller's tensors are this rank's batch rows, and a weight
is a DTensor (its local shard, all-gathered over dp on d, as the reference
does) or a full tensor (this rank's f columns are sliced from it), taken
by `dist.sharding.at_use`. Off a mesh, and under full_dp (no 'model' split),
both are the plain products on the full weight.

Gradients: x enters the column product through `comm.copy_to` (its
cotangent is summed over 'model', since each rank's columns reach only part
of it) and the row product leaves through `comm.reduce_from` (its
cotangent is already the same on every 'model' rank).
"""

from __future__ import annotations

import torch

from repro_torch.dist import comm
from repro_torch.dist.sharding import at_use


def model_slice(w: torch.Tensor, rt, dim: int) -> torch.Tensor:
    """This 'model' rank's slice of w's dim `dim` (1 / tp_size of it), full
    on the other dims, for a body split over 'model' (`at_use`: its
    gradient comes back as this rank's shard)."""
    return at_use(w, rt, keep=dim, split=True)


def body_weights(params: dict, x: torch.Tensor, rt, split: bool, keep: dict):
    """(a mixer's weights at use, its input x) for a body split over
    'model' or not: split, each weight through `at_use` with its window
    dim from keep (the rest whole, their gradients summed over 'model')
    and x through `comm.copy_to`; else every weight gathered whole."""
    if not split:
        return {k: at_use(v, rt) for k, v in params.items()}, x
    return ({k: at_use(v, rt, keep=keep.get(k), split=True) for k, v in params.items()},
            comm.copy_to(x, rt, (rt.tp_axis,)))


def split_out(y: torch.Tensor, rt, split: bool) -> torch.Tensor:
    """A split body's output projection, its partial sums summed over
    'model' (`comm.reduce_from`); an unsplit body's as it is."""
    return comm.reduce_from(y, rt, (rt.tp_axis,)) if split else y


def col_matmul_ffn(x: torch.Tensor, w: torch.Tensor, rt) -> torch.Tensor:
    """x (B, S, d) @ w (d, f) -> (B, S, f / tp) this rank's columns."""
    if not rt.distributed or rt.full_dp:
        return torch.einsum("bsd,df->bsf", x, at_use(w, rt))
    xl = comm.copy_to(x, rt, (rt.tp_axis,))
    return torch.einsum("bsd,df->bsf", xl, model_slice(w, rt, 1))


def row_matmul_ffn(x: torch.Tensor, w: torch.Tensor, rt) -> torch.Tensor:
    """x (B, S, f / tp) this rank's columns @ w (f, d) -> (B, S, d), summed
    over 'model'."""
    if not rt.distributed or rt.full_dp:
        return torch.einsum("bsf,fd->bsd", x, at_use(w, rt))
    y = torch.einsum("bsf,fd->bsd", x, model_slice(w, rt, 0))
    return comm.reduce_from(y, rt, (rt.tp_axis,))
