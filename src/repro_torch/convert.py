"""Carries index state from the reference package into the port.

U-HNSW has no weights: its state is the corpus and the two graphs. This
module turns a reference `repro.core.build.HNSWGraph`'s fields, handed over
as numpy arrays, into the port's `HNSWGraph` on a chosen device, so that
both packages can search the same index. It imports nothing of `repro`.
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
