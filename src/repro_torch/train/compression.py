"""Gradient compression: int8 quantization with error feedback.

Counterpart of `repro.train.compression`. Each gradient leaf, plus its
carried error, is quantized to int8 with one per-leaf scale
(max(max |g|, 1e-12) / 127; round half to even, as `jnp.round` and
`torch.round` both do; clipped to +-127), dequantized, and the
quantization error is carried into the next step (error feedback). On one
card there is no all-reduce for the int8 form to shrink; the semantic
contract (the int8 values and the error feedback) is what the port keeps.

On a mesh the leaves are DTensors: each rank quantizes its shard with the
scale of the whole leaf, the max over its shards (an all-reduce MAX over
the mesh axes the leaf is sharded on), as the reference quantizes the
global gradient.
"""

from __future__ import annotations

import torch

from repro_torch.dist.sharding import is_dtensor, local
from repro_torch.optim.adamw import zeros_like_f32
from repro_torch.tree import leaves, unflatten


def compression_init(params):
    """Error-feedback buffers, f32 zeros shaped (and placed) like each
    parameter leaf."""
    return unflatten(params, [zeros_like_f32(p) for p in leaves(params)])


def _quantize_leaf(g: torch.Tensor, amax: torch.Tensor | None = None):
    """(int8 values, f32 0-d scale) of an f32 leaf; amax: the leaf's max
    |value| when g is one shard of it."""
    if amax is None:
        amax = torch.max(torch.abs(g))
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _sharded_max(values: list, grads: list) -> list:
    """Each local 0-d max over the mesh axes its leaf is sharded on."""
    from torch.distributed.tensor import Shard

    from repro_torch.dist import comm
    from repro_torch.dist.sharding import Runtime

    out = list(values)
    groups: dict = {}
    for i, g in enumerate(grads):
        if is_dtensor(g):
            axes = tuple(a for a, q in zip(g.device_mesh.mesh_dim_names, g.placements)
                         if isinstance(q, Shard))
            if axes:
                groups.setdefault((g.device_mesh, axes), []).append(i)
    for (mesh, axes), idx in groups.items():
        got = comm.all_reduce(torch.stack([values[i] for i in idx]), Runtime(mesh=mesh), axes,
                              op="max")
        for j, i in enumerate(idx):
            out[i] = got[j]
    return out


@torch.no_grad()
def compress_decompress_grads(grads, error_buf):
    """Returns (dequantized grads in each gradient's dtype, new f32 error
    buffers): new_error = (g + e) - dequant(quant(g + e))."""
    g_tree, e_tree = leaves(grads), leaves(error_buf)
    g32 = [local(g).float() + local(e) for g, e in zip(g_tree, e_tree)]
    amax = _sharded_max([torch.max(torch.abs(x)) for x in g32], g_tree)
    deq, err = [], []
    for g, x, a, e in zip(g_tree, g32, amax, e_tree):
        q, scale = _quantize_leaf(x, a)
        d = q.float() * scale
        deq.append(_like(g, d.to(g.dtype)))
        err.append(_like(e, x - d))
    return unflatten(grads, deq), unflatten(grads, err)


def _like(ref, t: torch.Tensor):
    """t (a local shard) placed as ref is."""
    if not is_dtensor(ref):
        return t
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, ref.device_mesh, ref.placements, run_check=False,
                              shape=ref.shape, stride=ref.stride())
