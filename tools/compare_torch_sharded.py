"""Compares the port's sharded candidate generation with the reference's on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/compare_torch_sharded.py --n 20000

Builds a 4-segment `repro.index.ShardedUHNSW` over the synthetic Sun
corpus (n rows, seed 0, m = 16, the host bulk builder), carries its
segments into `repro_torch.index.ShardedUHNSW`, and for each base metric
prints, over 64 queries (t = 300): the rows whose merged candidate lists
are equal in the two packages under the independent policy and under
two_phase at thresh_rank = t, and in each package the rows where two_phase
at thresh_rank = t gives the independent policy's list. The reference's
build takes about 4 minutes at n = 20,000.
"""

import argparse
import json
import time

import jax.numpy as jnp
import numpy as np
import torch

from repro.index import ShardedParams as RShardedParams
from repro.index import ShardedUHNSW as RShardedUHNSW
from repro_torch.convert import graph_from_reference
from repro_torch.core.datasets import make_dataset
from repro_torch.index import SegmentedGraphs, ShardedParams, ShardedUHNSW


def to_port(g):
    return graph_from_reference(g.adjacency, g.level_nodes, g.local_index, g.entry_point,
                                g.max_level, g.levels, g.data, g.metric_p, g.m, g.m0,
                                device="cpu")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=20_000)
    args = ap.parse_args()
    ds = make_dataset("sun", n=args.n, n_queries=64, seed=0)
    t0 = time.perf_counter()
    ref = RShardedUHNSW.build(ds.data, num_segments=4, m=16, seed=0, method="bulk_host")
    build_s = time.perf_counter() - t0
    segs = ref.segments
    port = ShardedUHNSW(SegmentedGraphs([to_port(g) for g in segs.graphs1],
                                        [to_port(g) for g in segs.graphs2],
                                        [i.copy() for i in segs.global_ids]), ds.data)
    t = ref.params.t
    policies = {"independent": {}, "two_phase_rank_t": {"policy": "two_phase", "probe": 1,
                                                        "thresh_rank": t}}
    out = {"n": args.n, "queries": len(ds.queries), "ref_build_s": build_s}
    for base in (1.0, 2.0):
        lists = {}
        for name, kw in policies.items():
            ref.sharded_params = RShardedParams(**kw)
            port.sharded_params = ShardedParams(**kw)
            r = np.asarray(ref.search_stage_candidates(jnp.asarray(ds.queries), base, k=10).ids)
            g = port.search_stage_candidates(torch.from_numpy(ds.queries), base, k=10).ids.numpy()
            lists[name] = (r, g)
            out[f"base_{base}_{name}_rows_port_equal_ref"] = int((r == g).all(1).sum())
        for i, pkg in enumerate(("ref", "port")):
            same = (lists["two_phase_rank_t"][i] == lists["independent"][i]).all(1)
            out[f"base_{base}_{pkg}_rows_rank_t_equal_independent"] = int(same.sum())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
