"""The port's datasets, bulk builder and graph carry-over against `repro`.

The builder runs its dense steps in PyTorch (on the CPU here) and its
ragged steps in NumPy; the reference runs all of it in NumPy. Both take the
same data and seeds.

Tolerances: graphs are compared as arrays. They are expected to be equal.
The dense steps sum in another order than NumPy's, which can flip a choice
between two candidates whose distances tie to the last ulp; where that
happens the test holds >= 99% of each level's adjacency entries equal and
the recall of a search over the two graphs equal within 0.01. Distances
agree to rtol 1e-5, atol 1e-6 (the same summation-order reason).
"""

import pickle
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build as rbuild
from repro.core.datasets import make_dataset as r_make_dataset
from repro.core.hnsw import GraphArrays as RGraphArrays
from repro.core.hnsw import exact_topk as r_exact_topk
from repro.core.hnsw import knn_search as r_knn_search
from repro.core.uhnsw import recall as r_recall
from repro_torch.convert import graph_from_reference
from repro_torch.core import build as tbuild
from repro_torch.core.datasets import PAPER_DATASETS
from repro_torch.core.datasets import make_dataset as t_make_dataset
from repro_torch.core.hnsw import GraphArrays, knn_search
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

VERIFY_DS = Path(__file__).resolve().parents[1] / "results/bench_cache/verify_ds_d96_n1500_q16.pkl"
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def verify_corpus():
    """ROADMAP's verify corpus: d = 96, n = 1500, 16 queries."""
    with open(VERIFY_DS, "rb") as f:
        data, queries = pickle.load(f)
    return np.ascontiguousarray(data, np.float32), np.ascontiguousarray(queries, np.float32)


def to_port(g, device="cpu"):
    return graph_from_reference(g.adjacency, g.level_nodes, g.local_index, g.entry_point,
                                g.max_level, g.levels, g.data, g.metric_p, g.m, g.m0,
                                device=device, ef_construction=g.ef_construction)


@pytest.mark.parametrize("name,n", [("sun", 700), ("sift", 500), ("glove", 400), ("trevi", 60)])
def test_datasets_equal_reference(name, n):
    a = t_make_dataset(name, n=n, n_queries=7, seed=11)
    b = r_make_dataset(name, n=n, n_queries=7, seed=11)
    np.testing.assert_array_equal(a.data, b.data)
    np.testing.assert_array_equal(a.queries, b.queries)
    assert (a.d, a.n, a.name) == (b.d, b.n, b.name)
    assert PAPER_DATASETS["sun"] == (78_306, 512, "image")


@pytest.mark.parametrize("p", [1.0, 2.0])
def test_bulk_build_matches_reference(verify_corpus, p):
    data, queries = verify_corpus
    seed = 0 if p == 1.0 else 1
    ref = rbuild.build_hnsw_bulk(data, p, m=16, seed=seed)
    got = tbuild.build_hnsw_bulk(data, p, m=16, seed=seed, device="cpu")
    assert (got.entry_point, got.max_level, got.m, got.m0, got.ef_construction) == \
        (ref.entry_point, ref.max_level, ref.m, ref.m0, ref.ef_construction)
    np.testing.assert_array_equal(got.levels.numpy(), ref.levels)
    assert len(got.adjacency) == len(ref.adjacency)
    exact = True
    for l in range(ref.max_level + 1):
        np.testing.assert_array_equal(got.level_nodes[l].numpy(), ref.level_nodes[l])
        np.testing.assert_array_equal(got.local_index[l].numpy(), ref.local_index[l])
        a, b = got.adjacency[l].numpy(), ref.adjacency[l]
        assert a.shape == b.shape and a.dtype == b.dtype
        same = float(np.mean(a == b))
        assert same >= 0.99, (l, same)
        exact &= same == 1.0
    np.testing.assert_array_equal(got.data.numpy(), ref.data)
    assert got.index_size_bytes() == ref.index_size_bytes()
    if not exact:  # a near-tie flipped: the graphs must still search alike
        truth = np.asarray(r_exact_topk(jnp.asarray(data), jnp.asarray(queries), p, 10)[0])
        r_ids = r_knn_search(RGraphArrays.from_graph(ref), jnp.asarray(data),
                             jnp.asarray(queries), ef=64, t=10)[0]
        t_ids = knn_search(GraphArrays.from_graph(got), got.data, torch.from_numpy(queries),
                           ef=64, t=10)[0]
        assert abs(r_recall(np.asarray(r_ids), truth) - r_recall(t_ids.numpy(), truth)) <= 0.01


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(21)
    data = (rng.standard_normal((300, 24)) * np.exp(rng.standard_normal(24))).astype(np.float32)
    return data


def test_l2_pools_match_reference(small):
    nodes = np.arange(0, 300, 2, dtype=np.int32)
    want = rbuild._chunked_l2_topk(small, nodes, 20, chunk=64)
    got = tbuild._chunked_l2_topk(torch.from_numpy(small[nodes]), 20)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p", [1.0, 0.5])
def test_rerank_pool_matches_reference(small, p):
    nodes = np.arange(300, dtype=np.int32)
    pool = rbuild._chunked_l2_topk(small, nodes, 40)
    want_ids, want_d = rbuild._rerank_pool(small, nodes, pool, p, 12)
    got_ids, got_d = tbuild._rerank_pool(torch.from_numpy(small), torch.from_numpy(pool), p, 12)
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("backfill", [False, True])
def test_heuristic_prune_matches_reference(small, backfill):
    nodes = np.arange(300, dtype=np.int32)
    cand = rbuild._chunked_l2_topk(small, nodes, 24).copy()
    # ragged rows: -1 padding after a random number of valid entries
    rng = np.random.default_rng(22)
    for u, keep in enumerate(rng.integers(0, 25, size=300)):
        cand[u, keep:] = -1
    want = rbuild._vectorized_heuristic_prune(small, cand, 8, alpha=1.2, backfill=backfill,
                                              chunk=37)
    got = tbuild._vectorized_heuristic_prune(torch.from_numpy(small), torch.from_numpy(cand), 8,
                                             alpha=1.2, backfill=backfill)
    np.testing.assert_array_equal(got.numpy(), want)


def test_symmetrize_and_sort_match_reference(small):
    rng = np.random.default_rng(23)
    sel = rng.integers(-1, 300, size=(300, 6))
    sel[np.arange(300)[:, None] == sel] = -1           # no self edges, as the pools give
    lists = [list(r[r >= 0]) for r in sel]              # the reference's symmetrize loop
    for u, row in enumerate(sel):
        for v in row[row >= 0]:
            if u not in lists[v]:
                lists[int(v)].append(u)
    for p in (1.0, 2.0):
        want = rbuild._sort_ragged_by_base(small, lists, p)
        got = tbuild._sort_ragged_by_base(torch.from_numpy(small), tbuild._symmetrize(sel), p)
        np.testing.assert_array_equal(got.numpy(), want)


def test_top_up_matches_reference_loop():
    rng = np.random.default_rng(24)
    nn, m_max = 200, 8
    pruned = np.full((nn, m_max), -1, dtype=np.int64)
    for u in range(nn):
        k = rng.integers(0, m_max + 1)
        pruned[u, :k] = rng.choice(nn, size=k, replace=False)
    cand = np.stack([rng.choice(nn, size=16, replace=False) for _ in range(nn)])
    want = pruned.copy()
    for u in range(nn):                                 # the reference's top-up loop
        row = want[u]
        nsel = int((row >= 0).sum())
        have = set(row[row >= 0].tolist()) | {u}
        for c in cand[u]:
            if nsel >= m_max:
                break
            if int(c) not in have:
                row[nsel] = c
                have.add(int(c))
                nsel += 1
    got = pruned.copy()
    tbuild._top_up(got, cand, chunk=33)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [1.0, 2.0])
def test_repair_connectivity_matches_reference(small, p):
    """Three islands, one with full rows, bridged to the entry's component."""
    nn, m = 300, 6
    rng = np.random.default_rng(25)
    mat = np.full((nn, m), -1, dtype=np.int32)
    for lo, hi, deg in ((0, 150, 6), (150, 260, 3), (260, 300, 6)):
        for u in range(lo, hi):
            nbrs = rng.choice(np.setdiff1d(np.arange(lo, hi), [u]), size=deg, replace=False)
            mat[u, :deg] = nbrs
    nodes = np.arange(nn, dtype=np.int32)
    want = rbuild._repair_connectivity(mat.copy(), nodes, small, p, 7)
    got = tbuild._repair_connectivity(mat.copy(), torch.from_numpy(small), p, 7)
    np.testing.assert_array_equal(got, want)
    labels, extra = tbuild._label_components(got, 7)
    assert extra == 0 and (labels == 0).all()


def test_graph_from_reference_carries_every_field(verify_corpus):
    data, _ = verify_corpus
    ref = rbuild.build_hnsw_bulk(data[:400], 2.0, m=8, seed=3)
    got = to_port(ref)
    assert got.n == ref.n and got.d == ref.d and got.metric_p == 2.0
    for a, b in zip(got.adjacency + got.level_nodes + got.local_index,
                    ref.adjacency + ref.level_nodes + ref.local_index):
        np.testing.assert_array_equal(a.numpy(), b)
    arrays, r_arrays = GraphArrays.from_graph(got), RGraphArrays.from_graph(ref)
    np.testing.assert_array_equal(arrays.adj0.numpy(), np.asarray(r_arrays.adj0))
    assert int(arrays.entry) == int(r_arrays.entry)
    sizes = tuple(a.shape[0] + 3 for a in ref.adjacency[1:]) + (2, 2)
    padded = arrays.pad_to(ref.n + 9, len(sizes), sizes)
    r_padded = r_arrays.pad_to(ref.n + 9, len(sizes), sizes)
    np.testing.assert_array_equal(padded.adj0.numpy(), np.asarray(r_padded.adj0))
    for a, b in zip(padded.upper_adj + padded.upper_g2l, r_padded.upper_adj + r_padded.upper_g2l):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    stacked = GraphArrays.stack([padded, padded])
    assert stacked.adj0.shape == (2, ref.n + 9, ref.m0) and stacked.n == ref.n + 9
