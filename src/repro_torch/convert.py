"""Carries state from the reference package into the port.

U-HNSW has no weights: its state is the corpus and the two graphs.
`graph_from_reference` turns a reference `repro.core.build.HNSWGraph`'s
fields, handed over as numpy arrays, into the port's `HNSWGraph` on a
chosen device, so that both packages can search the same index. The LM
scaffold does have weights: `lm_params_from_reference` turns the
reference's parameter tree, as numpy arrays, into the port's, so that both
packages run the same model, and `train_state_from_reference` does the
same for a whole training state (parameters, AdamW moments and step, and
the compression's error buffers). It imports nothing of `repro`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.build import HNSWGraph


def graph_from_reference(adjacency, level_nodes, local_index, entry_point: int,
                         max_level: int, levels, data, metric_p: float, m: int, m0: int,
                         device="cuda", ef_construction: int = -1) -> HNSWGraph:
    """The port's HNSWGraph from a reference graph's fields (numpy arrays).

    adjacency / level_nodes / local_index are per-level lists in the
    reference layout (-1 padded global ids; global -> local maps with -1 for
    absent nodes); data (n, d) float32; levels (n,) per-node top level.
    """
    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return HNSWGraph(
        metric_p=float(metric_p), m=int(m), m0=int(m0),
        ef_construction=int(ef_construction),
        entry_point=int(entry_point), max_level=int(max_level),
        adjacency=[put(a, torch.int32) for a in adjacency],
        level_nodes=[put(a, torch.int32) for a in level_nodes],
        local_index=[put(a, torch.int32) for a in local_index],
        data=put(data, torch.float32).contiguous(),
        levels=put(levels, torch.int32),
    )


def _leaf_to_torch(a, device, dtype) -> torch.Tensor:
    """One numpy leaf as a tensor. A bfloat16 array (numpy's extension
    dtype, which torch.as_tensor refuses) goes through its 16-bit pattern."""
    a = np.array(a)     # a writable copy: a JAX array's buffer is read-only
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def lm_params_from_reference(tree, device="cuda", dtype=None):
    """The port's LM parameter tree from the reference's, leaf for leaf.

    tree: the reference's tree with its leaves as numpy arrays (bf16 leaves
    as numpy's bfloat16 extension dtype): {"embed", "final_norm", ...,
    "segments": [{"blocks": [per-kind dicts of (R, ...) stacked leaves]}]}
    (`repro.models.params._map_specs` has already dropped `kinds` and
    `repeats`). dtype: cast every floating-point leaf to it (None keeps
    the reference's dtypes).
    """
    if isinstance(tree, dict):
        return {k: lm_params_from_reference(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [lm_params_from_reference(v, device, dtype) for v in tree]
    return _leaf_to_torch(tree, device, dtype)


def train_state_from_reference(state_np, device="cuda", dtype=None) -> dict:
    """The port's training state from the reference's, leaf for leaf.

    state_np: {"params", "opt": {"m", "v", "step"}, ["err"]} with numpy
    leaves (bf16 ones as numpy's bfloat16). dtype casts the parameters'
    floating-point leaves only; the moments and error buffers keep f32 and
    the step its int32 (a 0-d tensor)."""
    out = {"params": lm_params_from_reference(state_np["params"], device, dtype),
           "opt": {"m": lm_params_from_reference(state_np["opt"]["m"], device),
                   "v": lm_params_from_reference(state_np["opt"]["v"], device),
                   "step": _leaf_to_torch(state_np["opt"]["step"], device, None)}}
    if "err" in state_np:
        out["err"] = lm_params_from_reference(state_np["err"], device)
    return out
