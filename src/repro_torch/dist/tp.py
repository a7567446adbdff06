"""Explicit tensor-parallel FFN products: the rt.explicit_tp path.

Counterpart of `repro.dist.tp`. Layout contract of the param specs:

  wi (d, f)  logical ('embed', 'ff')  -> (dp-sharded, 'model'-sharded)
  wo (f, d)  logical ('ff', 'embed')  -> ('model'-sharded, dp-sharded)

col_matmul_ffn produces activations column-sharded on f over 'model';
row_matmul_ffn contracts the f shards and completes with a sum over
'model', returning the activation replicated over 'model' (batch stays
dp-sharded throughout). The reference's `shard_map` bodies see local
shards; here the caller's tensors are this rank's batch rows, and a weight
is a DTensor (its local shard, all-gathered over dp on d, as the reference
does) or a full tensor (training's gathered copy: this rank's f columns
are sliced from it). Off a mesh, and under full_dp (no 'model' split),
both are the plain products on the full weight.

Gradients: x enters the column product through `comm.copy_to` (its
cotangent is summed over 'model', since each rank's columns reach only part
of it) and the row product leaves through `comm.reduce_from` (its
cotangent is already the same on every 'model' rank).
"""

from __future__ import annotations

import torch

from repro_torch.dist import comm
from repro_torch.dist.sharding import full, is_dtensor


def model_slice(w: torch.Tensor, rt, dim: int) -> torch.Tensor:
    """This 'model' rank's slice of w's dim `dim` (1 / tp_size of it), full
    on the other dim."""
    if is_dtensor(w):
        from torch.distributed.tensor import Replicate, Shard

        names = list(w.device_mesh.mesh_dim_names)
        pl = list(w.placements)
        kept = rt.tp_size > 1 and pl[names.index(rt.tp_axis)] == Shard(dim)
        if kept:      # already this rank's columns: gather the rest only
            pl[names.index(rt.tp_axis)] = Replicate()
        w = comm.gather_shards(w.to_local(), pl, w.device_mesh)
        if kept:
            return w
    n = w.shape[dim] // rt.tp_size
    return w.narrow(dim, rt.tp_rank * n, n)


def col_matmul_ffn(x: torch.Tensor, w: torch.Tensor, rt) -> torch.Tensor:
    """x (B, S, d) @ w (d, f) -> (B, S, f / tp) this rank's columns."""
    if not rt.distributed or rt.full_dp:
        return torch.einsum("bsd,df->bsf", x, full(w))
    xl = comm.copy_to(x, rt, (rt.tp_axis,))
    return torch.einsum("bsd,df->bsf", xl, model_slice(w, rt, 1))


def row_matmul_ffn(x: torch.Tensor, w: torch.Tensor, rt) -> torch.Tensor:
    """x (B, S, f / tp) this rank's columns @ w (f, d) -> (B, S, d), summed
    over 'model'."""
    if not rt.distributed or rt.full_dp:
        return torch.einsum("bsf,fd->bsd", x, full(w))
    y = torch.einsum("bsf,fd->bsd", x, model_slice(w, rt, 0))
    return comm.reduce_from(y, rt, (rt.tp_axis,))
