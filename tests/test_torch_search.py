"""The port's candidate search, verification and U-HNSW query against `repro`.

The graphs come from repro's bulk builder on ROADMAP's verify corpus
(d = 96, n = 1500) and are carried across with
`repro_torch.convert.graph_from_reference`, so query parity does not depend
on build parity. JAX runs its default CPU dispatch (the jnp references);
the port runs its kernels' plain versions on these CPU tensors.

Tolerances: n_b, hops, n_p, iterations and n_dim_frac are equal, and so are
ids, except that two candidates whose reference distances agree within the
float tolerance may come in either order (the two frameworks sum in
different orders, which can flip such a near-tie). Float32 distances agree
to rtol 1e-5, atol 1e-6, for the same reason.
"""

import pickle
from dataclasses import replace
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.build import build_hnsw_bulk
from repro.core.hnsw import GraphArrays as RGraphArrays
from repro.core.hnsw import exact_topk as r_exact_topk
from repro.core.hnsw import knn_search as r_knn_search
from repro.core.uhnsw import UHNSW as RUHNSW
from repro.core.uhnsw import UHNSWParams as RParams
from repro.core.uhnsw import modeled_query_cost as r_cost
from repro.core.uhnsw import recall as r_recall
from repro.core.uhnsw import verify_candidates as r_verify
from repro_torch.convert import graph_from_reference
from repro_torch.core.hnsw import GraphArrays, exact_topk, knn_search
from repro_torch.core.uhnsw import UHNSW, UHNSWParams, modeled_query_cost, recall, \
    verify_candidates
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

VERIFY_DS = Path(__file__).resolve().parents[1] / "results/bench_cache/verify_ds_d96_n1500_q16.pkl"
RTOL, ATOL = 1e-5, 1e-6
K = 10
T = 100          # a smaller t than the default 300 keeps the CPU run short
MIXED = np.array([0.5, 0.8, 1.0, 1.25, 1.5, 2.0, 0.6, 1.7] * 2, np.float32)


@pytest.fixture(scope="module")
def corpus():
    with open(VERIFY_DS, "rb") as f:
        data, queries = pickle.load(f)
    data = np.ascontiguousarray(data, np.float32)
    queries = np.ascontiguousarray(queries, np.float32)
    g1 = build_hnsw_bulk(data, 1.0, m=16, seed=0)
    g2 = build_hnsw_bulk(data, 2.0, m=16, seed=1)
    return data, queries, g1, g2


def to_port(g):
    return graph_from_reference(g.adjacency, g.level_nodes, g.local_index, g.entry_point,
                                g.max_level, g.levels, g.data, g.metric_p, g.m, g.m0,
                                device="cpu")


def assert_ids_match(got_ids, want_ids, want_d, err=""):
    """ids equal, up to the order of near-tied neighbours (see module doc);
    slots with an inf reference distance must be inf-distance slots."""
    got_ids = np.asarray(got_ids)
    want_ids, want_d = np.asarray(want_ids), np.asarray(want_d)
    assert got_ids.shape == want_ids.shape, err
    for row, (a, b, d) in enumerate(zip(got_ids, want_ids, want_d)):
        i = 0
        while i < len(b):
            if not np.isfinite(d[i]):
                break
            j = i + 1
            while j < len(b) and np.isfinite(d[j]) and abs(d[j] - d[i]) <= RTOL * abs(d[i]) + ATOL:
                j += 1
            assert set(a[i:j].tolist()) == set(b[i:j].tolist()), f"{err} row {row} slots {i}:{j}"
            i = j


def assert_close(got, want, err=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want), err_msg=err)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL, err_msg=err)


@pytest.mark.parametrize("thresh", [False, True])
@pytest.mark.parametrize("width", [1, 4])
@pytest.mark.parametrize("base", [1.0, 2.0])
def test_knn_search_matches_reference(corpus, base, width, thresh):
    data, queries, g1, g2 = corpus
    g = g1 if base == 1.0 else g2
    ra, ta = RGraphArrays.from_graph(g), GraphArrays.from_graph(to_port(g))
    th = None
    if thresh:
        # each query's 20th-best base distance from a short search, moved off
        # the exact value so that no neighbour sits on the bound itself
        d20 = np.asarray(r_knn_search(ra, jnp.asarray(data), jnp.asarray(queries), ef=32,
                                      t=32)[1])[:, 20]
        th = (d20 * (1 + 3e-4)).astype(np.float32)
    want = r_knn_search(ra, jnp.asarray(data), jnp.asarray(queries), ef=2 * T, t=T,
                        expand_width=width, thresh=None if th is None else jnp.asarray(th))
    got = knn_search(ta, torch.from_numpy(data), torch.from_numpy(queries), ef=2 * T, t=T,
                     expand_width=width, thresh=None if th is None else torch.from_numpy(th))
    w_ids, w_d, w_nb, w_hops = (np.asarray(a) for a in want)
    g_ids, g_d, g_nb, g_hops = got
    np.testing.assert_array_equal(g_nb.numpy(), w_nb)
    np.testing.assert_array_equal(g_hops.numpy(), w_hops)
    assert_close(g_d, w_d)
    assert_ids_match(g_ids, w_ids, w_d)
    assert g_ids.dtype == torch.int32 and g_ids.shape == (len(queries), T)
    if thresh:
        assert bool(np.isinf(w_d).any())           # the cut did cut


@pytest.mark.parametrize("p", [0.5, 1.25, 2.0])
def test_exact_topk_matches_reference(corpus, p):
    data, queries, _, _ = corpus
    w_ids, w_d = (np.asarray(a) for a in r_exact_topk(jnp.asarray(data), jnp.asarray(queries),
                                                      p, K, chunk=512))
    g_ids, g_d = exact_topk(torch.from_numpy(data), torch.from_numpy(queries), p, K, chunk=512)
    assert_ids_match(g_ids, w_ids, w_d)
    tol = RTOL if p != 2.0 else 1e-4     # p = 2 uses the product identity (cancellation)
    np.testing.assert_allclose(g_d.numpy(), w_d, rtol=tol)
    assert recall(g_ids, w_ids) == r_recall(w_ids, w_ids) == 1.0
    tiny = exact_topk(torch.from_numpy(data[:4]), torch.from_numpy(queries[:2]), p, 6)[0]
    assert (tiny[:, 4:] == -1).all()


@pytest.mark.parametrize("abandon", [True, False])
@pytest.mark.parametrize("p", [0.5, 0.8, 1.5, "rows"])
def test_verify_candidates_matches_reference(corpus, p, abandon):
    """Verification on the reference's own candidates."""
    data, queries, g1, _ = corpus
    ra = RGraphArrays.from_graph(g1)
    ids, base_d, _, _ = r_knn_search(ra, jnp.asarray(data), jnp.asarray(queries), ef=2 * T, t=T)
    pv = MIXED if p == "rows" else p
    want = r_verify(jnp.asarray(queries), ids, jnp.asarray(data),
                    jnp.asarray(pv) if p == "rows" else p, K, 5, 0.92,
                    cand_base=base_d, base_p=1.0, abandon=abandon)
    got = verify_candidates(torch.from_numpy(queries), torch.from_numpy(np.array(ids)),
                            torch.from_numpy(data), torch.from_numpy(pv) if p == "rows" else p,
                            K, 5, 0.92, cand_base=torch.from_numpy(np.array(base_d)),
                            base_p=1.0, abandon=abandon)
    w_ids, w_d, w_np, w_it, w_frac, w_f32, w_band = (np.asarray(a) for a in want)
    g_ids, g_d, g_np, g_it, g_frac, g_f32, g_band = got
    assert_ids_match(g_ids, w_ids, w_d)
    assert_close(g_d, w_d)
    np.testing.assert_array_equal(g_np.numpy(), w_np)
    assert g_it == int(w_it)
    np.testing.assert_array_equal(g_frac.numpy(), w_frac)
    np.testing.assert_array_equal(g_f32.numpy(), w_f32)
    np.testing.assert_array_equal(g_band.numpy(), w_band)


@pytest.fixture(scope="module")
def indexes(corpus):
    data, queries, g1, g2 = corpus
    return (RUHNSW(g1, g2, RParams(t=T)),
            UHNSW(to_port(g1), to_port(g2), UHNSWParams(t=T)))


def _compare_search(ref, port, queries, p):
    pj = jnp.asarray(p) if isinstance(p, np.ndarray) else p
    w_ids, w_d, w_st = ref.search(jnp.asarray(queries), pj, K)
    g_ids, g_d, g_st = port.search(queries, p, K)
    assert_ids_match(g_ids, w_ids, w_d, f"p={p}")
    assert_close(g_d, w_d, f"p={p}")
    for name in ("n_b", "n_p", "hops"):
        np.testing.assert_array_equal(getattr(g_st, name).numpy(),
                                      np.asarray(getattr(w_st, name)), err_msg=name)
    np.testing.assert_array_equal(np.asarray(g_st.n_dim_frac, np.float32),
                                  np.asarray(w_st.n_dim_frac, np.float32))
    assert g_st.iterations == int(w_st.iterations)
    np.testing.assert_array_equal(np.asarray(g_st.base_p), np.asarray(w_st.base_p))
    return g_ids, g_d, g_st, w_ids, w_st


@pytest.mark.parametrize("abandon", [True, False])
@pytest.mark.parametrize("p", [0.5, 0.8, 1.0, 1.25, 1.5, 2.0])
def test_uhnsw_search_matches_reference(corpus, indexes, p, abandon):
    _, queries, _, _ = corpus
    ref, port = indexes
    ref.params = replace(ref.params, abandon=abandon)
    port.params = replace(port.params, abandon=abandon)
    g_ids, _, g_st, w_ids, w_st = _compare_search(ref, port, queries, p)
    truth = r_exact_topk(jnp.asarray(corpus[0]), jnp.asarray(queries), p, K)[0]
    assert recall(g_ids, truth) == pytest.approx(r_recall(w_ids, truth), abs=0.01)
    got_cost, want_cost = modeled_query_cost(g_st, p, 96), r_cost(w_st, p, 96)
    assert got_cost.keys() == want_cost.keys()
    for key, value in want_cost.items():
        assert got_cost[key] == pytest.approx(value, rel=1e-6), key


@pytest.mark.parametrize("abandon", [True, False])
def test_uhnsw_mixed_search_matches_reference_and_scalar_rows(corpus, indexes, abandon):
    _, queries, _, _ = corpus
    ref, port = indexes
    ref.params = replace(ref.params, abandon=abandon)
    port.params = replace(port.params, abandon=abandon)
    ids, d, st, _, _ = _compare_search(ref, port, queries, MIXED)
    # each row equals the port's scalar call at its p, bit for bit
    for p in np.unique(MIXED):
        rows = np.flatnonzero(MIXED == p)
        s_ids, s_d, s_st = port.search(queries, float(p), K)
        np.testing.assert_array_equal(ids[rows].numpy(), s_ids[rows].numpy())
        np.testing.assert_array_equal(d[rows].numpy(), s_d[rows].numpy())
        np.testing.assert_array_equal(st.n_p[rows].numpy(), s_st.n_p[rows].numpy())


def test_staged_search_equals_search_and_unported_options_raise(corpus, indexes):
    _, queries, _, _ = corpus
    _, port = indexes
    port.params = UHNSWParams(t=T)
    cands = port.search_stage_candidates(queries, 1.0)
    staged = port.search_stage_finish(queries, cands, 0.8, K)
    fused = port.search(queries, 0.8, K)
    np.testing.assert_array_equal(staged[0].numpy(), fused[0].numpy())
    np.testing.assert_array_equal(staged[1].numpy(), fused[1].numpy())
    assert port.dim == 96 and port.X.device.type == "cpu"
    # the options that raised before they were ported now give the default ids
    for field in ("compressed_band", "energy_perm"):
        port.params = replace(UHNSWParams(t=T), **{field: True})
        np.testing.assert_array_equal(port.search(queries, 0.8, K)[0].numpy(),
                                      fused[0].numpy())
    port.params = UHNSWParams(t=T)
    with pytest.raises(ValueError, match="unknown build method"):
        UHNSW.build(corpus[0], method="sequential", device="cpu")


def test_uhnsw_build_on_cpu_searches(corpus):
    """The port's own build + search end to end (small m for speed)."""
    data, queries, _, _ = corpus
    idx = UHNSW.build(data[:600], m=8, seed=0, params=UHNSWParams(t=50), method="bulk_host",
                      device="cpu")
    assert idx.g1.metric_p == 1.0 and idx.g2.metric_p == 2.0 and idx.X.device.type == "cpu"
    ids, d, st = idx.search(queries, 0.8, K)
    truth = exact_topk(idx.X, torch.from_numpy(queries), 0.8, K)[0]
    assert ids.shape == (len(queries), K) and bool(d.isfinite().all())
    assert recall(ids, truth) >= 0.8
    assert idx.index_size_bytes(1.0) < idx.index_size_bytes()
