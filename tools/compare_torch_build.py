"""Compares the port's bulk builder with the reference's on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/compare_torch_build.py --n 12000 --p 2

Builds one base graph over the synthetic Sun corpus (n rows, seed 0) with
`repro.core.build.build_hnsw_bulk` and with the port's
`repro_torch.core.build.build_hnsw_bulk` (dense steps in torch on the CPU),
then prints the share of equal adjacency entries per level and the beam
recall@10 of each graph under its own metric (ef = 600, t = 300, 64
queries) with the per-query histogram of hits. The reference's build takes
about 20 s at n = 12,000 under L2 and much longer under L1.
"""

import argparse
import json
import time

import jax.numpy as jnp
import numpy as np
import torch

from repro.core.build import build_hnsw_bulk as ref_build
from repro.core.hnsw import GraphArrays as RGraphArrays
from repro.core.hnsw import knn_search as ref_knn_search
from repro_torch.core.build import build_hnsw_bulk
from repro_torch.core.datasets import make_dataset
from repro_torch.core.hnsw import GraphArrays, exact_topk, knn_search
from repro_torch.core.uhnsw import recall


def hits(ids, truth):
    return np.array([len(set(a[:10].tolist()) & set(b.tolist())) for a, b in zip(ids, truth)])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=12_000)
    ap.add_argument("--p", type=float, default=2.0)
    ap.add_argument("--m", type=int, default=16)
    args = ap.parse_args()
    ds = make_dataset("sun", n=args.n, n_queries=64, seed=0)
    t0 = time.perf_counter()
    port = build_hnsw_bulk(ds.data, args.p, m=args.m, seed=1, device="cpu")
    t1 = time.perf_counter()
    ref = ref_build(ds.data, args.p, m=args.m, seed=1)
    t2 = time.perf_counter()
    truth = exact_topk(torch.from_numpy(ds.data), torch.from_numpy(ds.queries), args.p, 10)[0]
    port_ids = knn_search(GraphArrays.from_graph(port), port.data,
                          torch.from_numpy(ds.queries), ef=600, t=300)[0].numpy()
    ref_ids = np.asarray(ref_knn_search(RGraphArrays.from_graph(ref), jnp.asarray(ds.data),
                                        jnp.asarray(ds.queries), ef=600, t=300)[0])
    truth = truth.numpy()
    print(json.dumps({
        "n": args.n, "p": args.p, "m": args.m,
        "port_build_s": t1 - t0, "ref_build_s": t2 - t1,
        "equal_entries_per_level": [float(np.mean(a.numpy() == b))
                                    for a, b in zip(port.adjacency, ref.adjacency)],
        "port_beam_recall@10": recall(port_ids[:, :10], truth),
        "ref_beam_recall@10": recall(ref_ids[:, :10], truth),
        "port_hits_hist": np.bincount(hits(port_ids, truth), minlength=11).tolist(),
        "ref_hits_hist": np.bincount(hits(ref_ids, truth), minlength=11).tolist(),
    }))


if __name__ == "__main__":
    main()
