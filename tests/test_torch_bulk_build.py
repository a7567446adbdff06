"""The port's sequential and shared-pass builders against `repro`.

The same numpy inputs and seeds go through both packages. The sequential
builder (`build_hnsw`) is the reference's NumPy loop, so its arrays must be
equal. The shared-pass builder (`build_bulk_pair`) runs its dense steps in
torch (here on the CPU) and its scoring through the kernels' plain versions;
it draws the reference's random numbers, so its pools and graphs are
expected to be equal too. Where torch sums in another order than XLA, a
near tie can flip one choice: the tests then hold >= 99% of each level's
entries equal and the recall of a search over the two graphs within 0.01
(the rule of tests/test_torch_build.py). Distances agree to rtol 1e-5,
atol 1e-6.
"""

import inspect
import pickle
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build as rbuild
from repro.core import bulk_build as rbulk
from repro.core.hnsw import GraphArrays as RGraphArrays
from repro.core.hnsw import exact_topk as r_exact_topk
from repro.core.hnsw import knn_search as r_knn_search
from repro.core.uhnsw import UHNSW as RUHNSW
from repro.core.uhnsw import UHNSWParams as RParams
from repro.core.uhnsw import recall as r_recall
from repro_torch.core import build as tbuild
from repro_torch.core import bulk_build as tbulk
from repro_torch.core.hnsw import GraphArrays, knn_search
from repro_torch.core.uhnsw import UHNSW, UHNSWParams, recall
from repro_torch.kernels import lp_distance
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

VERIFY_DS = Path(__file__).resolve().parents[1] / "results/bench_cache/verify_ds_d96_n1500_q16.pkl"
RTOL, ATOL = 1e-5, 1e-6
K = 10


@pytest.fixture(scope="module")
def verify_corpus():
    """ROADMAP's verify corpus: d = 96, n = 1500, 16 queries."""
    with open(VERIFY_DS, "rb") as f:
        data, queries = pickle.load(f)
    return np.ascontiguousarray(data, np.float32), np.ascontiguousarray(queries, np.float32)


def _assert_graphs_match(got, want, data, queries):
    """Level by level: >= 99% of the entries equal; where a near tie flipped
    one, a search over each graph has the same recall within 0.01."""
    assert (got.entry_point, got.max_level, got.m, got.m0, got.metric_p) == \
        (want.entry_point, want.max_level, want.m, want.m0, want.metric_p)
    np.testing.assert_array_equal(got.levels.numpy(), want.levels)
    np.testing.assert_array_equal(got.data.numpy(), want.data)
    assert got.index_size_bytes() == want.index_size_bytes()
    exact = True
    for level in range(want.max_level + 1):
        a, b = got.adjacency_host(level), want.adjacency_host(level)
        assert a.shape == b.shape
        same = float(np.mean(a == b))
        assert same >= 0.99, (level, same)
        exact &= same == 1.0
    ra = RGraphArrays.from_graph(want)
    ta = GraphArrays.from_graph(got)
    assert len(ta.upper_g2l) == len(ra.upper_g2l) and int(ta.entry) == int(ra.entry)
    for x, y in zip(ta.upper_g2l, ra.upper_g2l):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    if not exact:
        p = want.metric_p
        truth = np.asarray(r_exact_topk(jnp.asarray(data), jnp.asarray(queries), p, K)[0])
        r_ids = r_knn_search(ra, jnp.asarray(data), jnp.asarray(queries), ef=64, t=K)[0]
        t_ids = knn_search(ta, got.data, torch.from_numpy(queries), ef=64, t=K)[0]
        assert abs(r_recall(np.asarray(r_ids), truth) - r_recall(t_ids.numpy(), truth)) <= 0.01


# ---------------------------------------------------------------------------
# the sequential builder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p,m,efc", [(1.0, 8, 24), (2.0, 6, 16), (0.5, 6, 12)])
def test_build_hnsw_matches_reference(p, m, efc):
    rng = np.random.default_rng(31)
    data = (rng.standard_normal((260, 24)) * np.exp(rng.standard_normal(24))).astype(np.float32)
    want = rbuild.build_hnsw(data, p, m=m, ef_construction=efc, seed=4)
    got = tbuild.build_hnsw(data, p, m=m, ef_construction=efc, seed=4, device="cpu")
    assert (got.entry_point, got.max_level, got.m, got.m0, got.ef_construction) == \
        (want.entry_point, want.max_level, want.m, want.m0, want.ef_construction)
    for a, b in zip(got.adjacency + got.level_nodes + got.local_index,
                    want.adjacency + want.level_nodes + want.local_index):
        assert a.device.type == "cpu" and a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(got.levels.numpy(), want.levels)
    np.testing.assert_array_equal(got.data.numpy(), want.data)
    assert got.index_size_bytes() == want.index_size_bytes()


def test_uhnsw_build_takes_the_reference_arguments():
    """Same positional order and default method as the reference; device is
    keyword-only and last. A positional call builds the same graphs."""
    want = list(inspect.signature(RUHNSW.build).parameters.values())
    got = list(inspect.signature(UHNSW.build).parameters.values())
    assert [(a.name, a.default) for a in got[:-1]] == [(a.name, a.default) for a in want]
    assert got[-1].name == "device" and got[-1].kind is inspect.Parameter.KEYWORD_ONLY
    assert UHNSW.build.__defaults__ == RUHNSW.build.__defaults__
    rng = np.random.default_rng(32)
    data = rng.standard_normal((150, 16)).astype(np.float32)
    r_idx = RUHNSW.build(data, 6, 20, 3)
    t_idx = UHNSW.build(data, 6, 20, 3, device="cpu")
    for got_g, want_g in ((t_idx.g1, r_idx.g1), (t_idx.g2, r_idx.g2)):
        assert got_g.ef_construction == want_g.ef_construction == 20
        for a, b in zip(got_g.adjacency, want_g.adjacency):
            np.testing.assert_array_equal(a.numpy(), b)
    with pytest.raises(ValueError, match="unknown build method"):
        UHNSW.build(data, method="nope", device="cpu")


# ---------------------------------------------------------------------------
# dense primitives, on inputs with ties
# ---------------------------------------------------------------------------


def test_merge_topk_matches_reference():
    rng = np.random.default_rng(33)
    b, k = 40, 12
    pool_ids = rng.integers(-1, 30, size=(b, k)).astype(np.int32)
    pool_d = rng.integers(0, 6, size=(b, k)).astype(np.float32)   # many ties
    cand_ids = rng.integers(-1, 30, size=(b, 25)).astype(np.int32)
    cand_d = rng.integers(0, 6, size=(b, 25)).astype(np.float32)
    want = rbulk._merge_topk(*(jnp.asarray(a) for a in (pool_ids, pool_d, cand_ids, cand_d)), k)
    got = tbulk._merge_topk(*(torch.from_numpy(a) for a in (pool_ids, pool_d, cand_ids,
                                                            cand_d)), k)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("k", [7, 40])
def test_dedup_and_reverse_edges_match_reference(k):
    rng = np.random.default_rng(34)
    ids = rng.integers(-1, 12, size=(30, 20)).astype(np.int32)
    np.testing.assert_array_equal(tbulk._dedup_keep_first(torch.from_numpy(ids), k).numpy(),
                                  np.asarray(rbulk._dedup_keep_first(jnp.asarray(ids), k)))
    sel = rng.integers(-1, 30, size=(30, 6)).astype(np.int32)
    np.testing.assert_array_equal(tbulk._reverse_edges(torch.from_numpy(sel), 30, 4).numpy(),
                                  rbulk._reverse_edges(sel, 30, 4))


@pytest.mark.parametrize("backfill", [False, True])
def test_prune_chunk_matches_reference(backfill):
    rng = np.random.default_rng(35)
    x = (rng.standard_normal((200, 16)) * np.exp(rng.standard_normal(16))).astype(np.float32)
    cand = rbuild._chunked_l2_topk(x, np.arange(200, dtype=np.int32), 20).astype(np.int32)
    for u, keep in enumerate(rng.integers(0, 21, size=200)):   # ragged, -1 padded
        cand[u, keep:] = -1
    rows = np.arange(200, dtype=np.int32)
    want = rbulk._prune_chunk(jnp.asarray(x), jnp.asarray(rows), jnp.asarray(cand), 8, 1.2,
                              backfill)
    got = tbulk._prune_chunk(torch.from_numpy(x), torch.from_numpy(rows).long(),
                             torch.from_numpy(cand), 8, 1.2, backfill)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# pools and graphs, on the exact-seed and the NN-Descent paths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,threshold", [(600, tbulk.EXACT_SEED_THRESHOLD), (700, 256)])
def test_nn_descent_pools_match_reference(verify_corpus, n, threshold):
    data = verify_corpus[0][:n]
    want = rbulk.nn_descent_pools(data, (1.0, 2.0), k=32, seed=5,
                                  exact_seed_threshold=threshold)
    got = tbulk.nn_descent_pools(data, (1.0, 2.0), k=32, seed=5, exact_seed_threshold=threshold,
                                 device="cpu")
    for p in (1.0, 2.0):
        ids, d = got[p][0].numpy(), got[p][1].numpy()
        same = float(np.mean(ids == want[p][0]))
        assert same >= 0.99, (p, same)
        np.testing.assert_allclose(d, want[p][1], rtol=RTOL, atol=ATOL)


def _per_metric_scoring(x, node_rows, ids, ps):
    """The shared pass as it was before the multi-p kernel: one
    `_score_ids` call (the single-p gather) per metric, stacked."""
    return torch.stack([tbulk._score_ids(x, node_rows, ids, p) for p in ps])


@pytest.mark.parametrize("metric_ps", [(1.0, 2.0), (1.5,)])
def test_nn_descent_fused_scoring_equals_per_metric_path(verify_corpus, monkeypatch, metric_ps):
    """The NN-Descent path with the fused scoring (one multi-p gather per
    round, both metrics) gives pools and trajectory bitwise equal to the
    per-metric scoring; the seed and every round take one multi-p call."""
    data = verify_corpus[0][:700]
    calls = []
    fused = lp_distance.gather_lp_multi

    def spy(q, ids, x, ps):
        calls.append(tuple(ps))
        return fused(q, ids, x, ps)

    monkeypatch.setattr(lp_distance, "gather_lp_multi", spy)
    got, got_traj = tbulk.nn_descent_pools(data, metric_ps, k=32, seed=5, rounds=3,
                                           exact_seed_threshold=256, trajectory=True,
                                           device="cpu")
    assert calls == [metric_ps] * 4
    monkeypatch.setattr(tbulk, "_score_ids_multi", _per_metric_scoring)
    want, want_traj = tbulk.nn_descent_pools(data, metric_ps, k=32, seed=5, rounds=3,
                                             exact_seed_threshold=256, trajectory=True,
                                             device="cpu")
    for p in metric_ps:
        np.testing.assert_array_equal(got[p][0].numpy(), want[p][0].numpy())
        np.testing.assert_array_equal(got[p][1].numpy(), want[p][1].numpy())
        for a, b in zip(got_traj, want_traj):
            np.testing.assert_array_equal(a[p].numpy(), b[p].numpy())


def test_score_ids_multi_takes_metrics_two_at_a_time(verify_corpus):
    """Three metrics go through two multi-p calls; each plane has the
    single-metric scoring's bits, padding (-1) included."""
    x = torch.from_numpy(verify_corpus[0][:200])
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(-1, 200, size=(50, 40)))
    rows = torch.arange(50)
    ps = (1.0, 2.0, 0.5)
    got = tbulk._score_ids_multi(x, rows, ids, ps)
    np.testing.assert_array_equal(got.numpy(), _per_metric_scoring(x, rows, ids, ps).numpy())
    assert bool(got[:, ids < 0].isinf().all())


@pytest.fixture(scope="module")
def pairs(verify_corpus):
    """(reference, port) pairs: the verify corpus on the exact-seed path
    (m = 16), and 800 rows of it with the NN-Descent path forced (m = 8)."""
    data, _ = verify_corpus
    out = {}
    for name, n, m, threshold in (("exact", 1500, 16, tbulk.EXACT_SEED_THRESHOLD),
                                  ("nn_descent", 800, 8, 256)):
        x = data[:n]
        out[name] = (rbulk.build_bulk_pair(x, m=m, seed=0, exact_seed_threshold=threshold),
                     tbulk.build_bulk_pair(x, m=m, seed=0, exact_seed_threshold=threshold,
                                           device="cpu"))
    return out


@pytest.mark.parametrize("path", ["exact", "nn_descent"])
def test_build_bulk_pair_matches_reference(verify_corpus, pairs, path):
    data, queries = verify_corpus
    want, got = pairs[path]
    n = got[0].n
    for g, r in zip(got, want):
        _assert_graphs_match(g, r, data[:n], queries)
        assert GraphArrays.from_graph(g) is g.graph_arrays()    # passed through as it is
        assert g.data.device.type == "cpu" and g.arrays.adj0.device.type == "cpu"


@pytest.mark.parametrize("path", ["exact", "nn_descent"])
def test_bulk_pair_search_recall_matches_reference(verify_corpus, pairs, path):
    """U-HNSW over each package's own bulk graphs: recall within 0.01."""
    data, queries = verify_corpus
    want, got = pairs[path]
    n = got[0].n
    ref = RUHNSW(*want, RParams(t=60))
    port = UHNSW(*got, UHNSWParams(t=60))
    for p in (0.5, 2.0):
        truth = r_exact_topk(jnp.asarray(data[:n]), jnp.asarray(queries), p, K)[0]
        r_ids = ref.search(jnp.asarray(queries), p, K)[0]
        t_ids = port.search(queries, p, K)[0]
        assert recall(t_ids, truth) == pytest.approx(r_recall(np.asarray(r_ids), truth), abs=0.01)


def test_build_bulk_single_metric_matches_reference(verify_corpus):
    data = verify_corpus[0][:300]
    want = rbulk.build_bulk(data, metric_p=1.5, m=8, seed=2)
    got = tbulk.build_bulk(data, metric_p=1.5, m=8, seed=2, device="cpu")
    _assert_graphs_match(got, want, data, verify_corpus[1])


def test_uhnsw_build_bulk_method(verify_corpus):
    """UHNSW.build(method="bulk") wraps build_bulk_pair's graphs."""
    data = verify_corpus[0][:400]
    idx = UHNSW.build(data, m=8, seed=1, method="bulk", device="cpu")
    g1, g2 = tbulk.build_bulk_pair(data, m=8, seed=1, device="cpu")
    np.testing.assert_array_equal(idx.arrays1.adj0.numpy(), g1.arrays.adj0.numpy())
    np.testing.assert_array_equal(idx.arrays2.adj0.numpy(), g2.arrays.adj0.numpy())
    assert idx.X.device.type == "cpu" and idx.index_size_bytes() == \
        g1.index_size_bytes() + g2.index_size_bytes()
