"""The port's sharded index, delta tier and segment health against `repro`.

Both packages search the conftest's reference `segments4` (2000 SIFT-like
points, 4 segments, m = 12, t = 150), carried across with
`repro_torch.convert.graph_from_reference`, so search parity does not
depend on build parity. A segment built by compaction is built by each
package's own sequential builder, whose arrays are equal
(tests/test_torch_bulk_build.py). JAX runs its default CPU dispatch; the
port runs its kernels' plain versions on CPU tensors.

Tolerances, as in tests/test_torch_search.py: n_b, n_b probe / spill,
n_p, hops, iterations and the scanned-dims fraction are equal; ids are
equal except that two candidates whose reference distances agree within
rtol 1e-5, atol 1e-6 may come in either order (the frameworks sum in
different orders); float32 distances agree to rtol 1e-5, atol 1e-6. One
exception: at p = 2 both packages score the delta tier by the product
identity |q|^2 + |x|^2 - 2 q.x, whose cancellation near a distance of 0
rounds differently in each; there the rooted distances agree to an
absolute 0.05, the bound the reference's own tests give this self-distance.
"""

import copy
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.uhnsw import UHNSW as RUHNSW
from repro.core.uhnsw import CandidateSet as RCandidateSet
from repro.core.uhnsw import SearchStats as RSearchStats
from repro.core.uhnsw import UHNSWParams as RParams
from repro.index import SegmentedGraphs as RSegmentedGraphs
from repro.index import SegmentHealthTracker as RTracker
from repro.index import ShardedParams as RShardedParams
from repro.index import ShardedUHNSW as RShardedUHNSW
from repro.index.delta import DeltaBuffer as RDeltaBuffer
from repro.index.segment import partition_dataset as r_partition
from repro.index.segment import resolve_build_method as r_resolve
from repro.index.sharded import merge_phase_lists as r_merge_phase
from repro.index.sharded import merge_tagged_lists as r_merge_tagged
from repro.index.sharded import segmented_knn_search as r_segmented
from repro.retrieval.engine.faults import poison_segment
from repro_torch.convert import graph_from_reference
from repro_torch.core.hnsw import exact_topk
from repro_torch.core.uhnsw import UHNSW, CandidateSet, SearchStats, UHNSWParams, recall
from repro_torch.index import (
    HEALTHY,
    QUARANTINED,
    SegmentedGraphs,
    SegmentHealthTracker,
    ShardedParams,
    ShardedUHNSW,
)
from repro_torch.index.delta import DeltaBuffer
from repro_torch.index.segment import partition_dataset, resolve_build_method
from repro_torch.index.sharded import (
    merge_phase_lists,
    merge_tagged_lists,
    segmented_knn_search,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

RTOL, ATOL = 1e-5, 1e-6
K = 10
T = 150
P_GRID = [0.5, 1.0, 1.25, 2.0]
MIXED = np.array([0.5, 0.8, 1.0, 1.25, 1.5, 2.0, 0.6, 1.7] * 3, np.float32)
POLICIES = {"independent": {}, "two_phase": {"probe": 2}, "round_robin": {"probe": 2}}


def to_port(g):
    return graph_from_reference(g.adjacency, g.level_nodes, g.local_index, g.entry_point,
                                g.max_level, g.levels, g.data, g.metric_p, g.m, g.m0,
                                device="cpu")


@pytest.fixture(scope="module")
def port_graphs(segments4):
    return [to_port(g) for g in segments4.graphs1], [to_port(g) for g in segments4.graphs2]


@pytest.fixture
def make_pair(small_ds, segments4, port_graphs):
    """(reference, port) ShardedUHNSW over the same frozen segments, with
    fresh mutable state. deep=True copies the graph objects, so that a
    test may poison their rows."""
    def make(policy="independent", deep=False, abandon=True, delta_capacity=16, **sp):
        def graphs(gs):
            return [copy.copy(g) for g in gs] if deep else list(gs)

        ref = RShardedUHNSW(
            RSegmentedGraphs(graphs1=graphs(segments4.graphs1),
                             graphs2=graphs(segments4.graphs2),
                             global_ids=[i.copy() for i in segments4.global_ids]),
            small_ds.data, params=RParams(t=T, abandon=abandon),
            delta_capacity=delta_capacity,
            sharded_params=RShardedParams(policy=policy, **{**POLICIES[policy], **sp}))
        port = ShardedUHNSW(
            SegmentedGraphs(graphs1=graphs(port_graphs[0]), graphs2=graphs(port_graphs[1]),
                            global_ids=[i.copy() for i in segments4.global_ids]),
            small_ds.data, params=UHNSWParams(t=T, abandon=abandon),
            delta_capacity=delta_capacity,
            sharded_params=ShardedParams(policy=policy, **{**POLICIES[policy], **sp}))
        return ref, port

    return make


def assert_ids_match(got_ids, want_ids, want_d, err=""):
    """ids equal, up to the order of near-tied neighbours (module doc);
    slots with an inf reference distance must be inf-distance slots."""
    got_ids = np.asarray(got_ids)
    want_ids, want_d = np.asarray(want_ids), np.asarray(want_d)
    assert got_ids.shape == want_ids.shape, err
    for row, (a, b, d) in enumerate(zip(got_ids, want_ids, want_d)):
        i = 0
        while i < len(b) and np.isfinite(d[i]):
            j = i + 1
            while j < len(b) and np.isfinite(d[j]) and abs(d[j] - d[i]) <= RTOL * abs(d[i]) + ATOL:
                j += 1
            assert set(a[i:j].tolist()) == set(b[i:j].tolist()), f"{err} row {row} slots {i}:{j}"
            i = j


def assert_close(got, want, err="", atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want), err_msg=err)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=atol, err_msg=err)


def compare_search(ref, port, Q, p, k=K, atol=ATOL):
    """One search in each package: ids, dists and every counter agree."""
    pj = jnp.asarray(p) if isinstance(p, np.ndarray) else p
    w_ids, w_d, w_st = ref.search(jnp.asarray(Q), pj, k)
    g_ids, g_d, g_st = port.search(torch.from_numpy(np.asarray(Q)), p, k)
    err = f"p={p}"
    assert_ids_match(g_ids, w_ids, w_d, err)
    assert_close(g_d, w_d, err, atol)
    for name in ("n_b", "n_p", "hops", "n_b_probe", "n_b_spill"):
        np.testing.assert_array_equal(np.asarray(getattr(g_st, name)),
                                      np.asarray(getattr(w_st, name)), err_msg=f"{err} {name}")
    for name in ("n_p_probe", "n_p_spill", "n_dim_frac", "n_f32_rows_frac", "n_band_frac"):
        np.testing.assert_allclose(np.asarray(getattr(g_st, name), np.float64),
                                   np.asarray(getattr(w_st, name), np.float64), rtol=1e-6,
                                   err_msg=f"{err} {name}")
    np.testing.assert_array_equal(np.asarray(g_st.poisoned, bool), np.asarray(w_st.poisoned, bool))
    np.testing.assert_array_equal(np.asarray(g_st.base_p), np.asarray(w_st.base_p))
    assert g_st.iterations == int(w_st.iterations)
    assert g_st.coverage_frac == w_st.coverage_frac and g_st.degraded == w_st.degraded
    return g_ids, g_d, g_st


# ---------------------------------------------------------------------------
# interface parity
# ---------------------------------------------------------------------------

# SearchStats as the port had it before it took the reference's fields: a
# positional unpack or `_replace` written against the reference's tuple
# read other fields there (n_f32_rows_frac sat at position 6, not 10)
OLD_SEARCH_STATS = ("n_b", "n_p", "iterations", "base_p", "hops", "n_dim_frac",
                    "n_f32_rows_frac", "n_band_frac")
OLD_CANDIDATE_SET = ("ids", "base_dists", "n_b", "hops", "base_p")


def test_candidate_set_and_search_stats_fields_match_reference():
    assert CandidateSet._fields == RCandidateSet._fields
    assert SearchStats._fields == RSearchStats._fields
    assert CandidateSet._field_defaults == RCandidateSet._field_defaults
    assert SearchStats._field_defaults == RSearchStats._field_defaults
    # the layouts before the repair fail the same checks
    assert OLD_SEARCH_STATS != RSearchStats._fields[:len(OLD_SEARCH_STATS)]
    assert OLD_CANDIDATE_SET != RCandidateSet._fields
    # positional construction means the same fields in both packages
    vals = tuple(range(len(RSearchStats._fields)))
    assert SearchStats(*vals)._asdict() == RSearchStats(*vals)._asdict()
    st = SearchStats(n_b=1, n_p=2, iterations=0, base_p=1.0)
    assert st.phase_n_b() == (1, 0.0) and st.phase_n_p() == (2, 0.0)
    assert st._replace(n_b_probe=5).phase_n_b() == (5, 0.0)


def test_search_stage_candidates_takes_k(small_ds, port_graphs):
    for port_cls, ref_cls in ((UHNSW, RUHNSW), (ShardedUHNSW, RShardedUHNSW)):
        got = list(inspect.signature(port_cls.search_stage_candidates).parameters)
        want = list(inspect.signature(ref_cls.search_stage_candidates).parameters)
        assert got == want
    port = UHNSW(port_graphs[0][0], port_graphs[1][0], UHNSWParams(t=50))
    Q = small_ds.queries[:4]
    a = port.search_stage_candidates(Q, 1.0, k=K)
    b = port.search_stage_candidates(Q, 1.0)
    np.testing.assert_array_equal(a.ids.numpy(), b.ids.numpy())
    assert a.n_b_probe is None and a.coverage_frac == 1.0


# ---------------------------------------------------------------------------
# params, partition, merges, the segmented search primitive
# ---------------------------------------------------------------------------


def test_params_validation_and_thresh_rank_match_reference(make_pair):
    with pytest.raises(ValueError, match="unknown policy"):
        ShardedParams(policy="telepathic")
    with pytest.raises(ValueError, match="probe"):
        ShardedParams(policy="two_phase", probe=0)
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError, match="ef_shrink"):
            ShardedParams(policy="two_phase", ef_shrink=bad)
    with pytest.raises(ValueError, match="probe"):
        make_pair("two_phase", probe=5)
    make_pair("two_phase", probe=4)          # probe == S is legal
    with pytest.raises(ValueError, match="thresh_rank"):
        make_pair("two_phase", thresh_rank=T + 1)
    rng = np.random.default_rng(0)
    for _ in range(300):
        t, s, probe = (int(v) for v in rng.integers(1, (500, 12, 12)))
        k = None if rng.random() < 0.2 else int(rng.integers(1, 500))
        rank = None if rng.random() < 0.7 else int(rng.integers(-3, 600))
        got = ShardedParams(policy="two_phase", probe=probe, thresh_rank=rank)
        want = RShardedParams(policy="two_phase", probe=probe, thresh_rank=rank)
        assert got.resolve_thresh_rank(t, s, k) == want.resolve_thresh_rank(t, s, k)


def test_partition_and_build_method_match_reference():
    for n, s, seed in ((2000, 4, 0), (17, 3, 5), (9, 9, 1)):
        for a, b in zip(partition_dataset(n, s, seed), r_partition(n, s, seed)):
            np.testing.assert_array_equal(a, b)
    for n in (100, 511, 512, 4000):
        for bulk in (None, True, False):
            for method in (None, "bulk_host"):
                assert resolve_build_method(n, bulk, method) == r_resolve(n, bulk, method)
    with pytest.raises(ValueError, match="unknown build method"):
        resolve_build_method(10, method="magic")


@pytest.mark.parametrize("seed", range(3))
def test_merge_lists_match_reference(seed):
    """Stable merges: with many equal distances, ids and phase flags must
    come out in the reference's order."""
    rng = np.random.default_rng(100 + seed)
    b, w1, w2 = 4, int(rng.integers(1, 40)), int(rng.integers(1, 40))
    t = int(rng.integers(1, w1 + w2 + 1))
    d_a = np.sort(rng.integers(0, 6, (b, w1)), axis=1).astype(np.float32)
    d_b = np.sort(rng.integers(0, 6, (b, w2)), axis=1).astype(np.float32)
    g_a = rng.integers(0, 10_000, (b, w1)).astype(np.int32)
    g_b = rng.integers(0, 10_000, (b, w2)).astype(np.int32)
    want = r_merge_phase(*map(jnp.asarray, (g_a, d_a, g_b, d_b)), t)
    got = merge_phase_lists(*map(torch.from_numpy, (g_a, d_a, g_b, d_b)), t)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    want2 = r_merge_tagged(*want, jnp.asarray(g_b), jnp.asarray(d_b), t)
    got2 = merge_tagged_lists(*got, torch.from_numpy(g_b), torch.from_numpy(d_b), t)
    for x, y in zip(got2, want2):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("base_p,mode", [(1.0, "open"), (2.0, "thresh"), (1.0, "alive")])
def test_segmented_knn_search_matches_reference(make_pair, small_ds, base_p, mode):
    ref, port = make_pair()
    rs, ps = ref.segments, port.segments
    ra, pa = (rs.arrays1, ps.arrays1) if base_p == 1.0 else (rs.arrays2, ps.arrays2)
    Q = small_ds.queries[:12]
    kw_r, kw_p = {}, {}
    if mode == "thresh":
        d20 = np.asarray(r_segmented(ra, rs.X, rs.node_ids, jnp.asarray(Q), ef=40, t=40)[1])
        th = (d20[:, 20] * (1 + 3e-4)).astype(np.float32)
        kw_r, kw_p = {"thresh": jnp.asarray(th)}, {"thresh": torch.from_numpy(th)}
    elif mode == "alive":
        alive = np.array([True, False, True, True])
        kw_r, kw_p = {"alive": jnp.asarray(alive)}, {"alive": alive}
    want = r_segmented(ra, rs.X, rs.node_ids, jnp.asarray(Q), ef=2 * T, t=T, **kw_r)
    got = segmented_knn_search(pa, ps.X, ps.node_ids, torch.from_numpy(Q), ef=2 * T, t=T,
                               **kw_p)
    w_ids, w_d, w_nb, w_hops, w_pois = (np.asarray(a) for a in want)
    assert_ids_match(got[0], w_ids, w_d)
    assert_close(got[1], w_d)
    np.testing.assert_array_equal(got[2].numpy(), w_nb)
    np.testing.assert_array_equal(got[3].numpy(), w_hops)
    np.testing.assert_array_equal(got[4].numpy(), w_pois)
    assert got[0].dtype == torch.int32 and got[0].shape == (len(Q), T)


# ---------------------------------------------------------------------------
# search parity: every policy, scalar and mixed p
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", [0.5, 1.25, 2.0, "mixed"])
@pytest.mark.parametrize("policy", list(POLICIES))
def test_search_matches_reference(make_pair, small_ds, policy, p):
    ref, port = make_pair(policy)
    Q = small_ds.queries
    pv = MIXED if p == "mixed" else p
    ids, _, st = compare_search(ref, port, Q, pv)
    if policy != "independent":
        assert float(np.mean(st.n_b_spill.numpy())) > 0.0
    if p != "mixed":
        truth = exact_topk(torch.from_numpy(small_ds.data), torch.from_numpy(Q), p, K)[0]
        assert recall(ids, truth) >= 0.8


def test_staged_search_equals_search(make_pair, small_ds):
    _, port = make_pair("two_phase")
    Q = torch.from_numpy(small_ds.queries)
    cands = port.search_stage_candidates(Q, 1.0, k=K)
    staged = port.search_stage_finish(Q, cands, 0.8, K)
    fused = port.search(Q, 0.8, K)
    for a, b in zip(staged[:2], fused[:2]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    nb_pr, nb_sp = fused[2].phase_n_b()
    np.testing.assert_array_equal((nb_pr + nb_sp).numpy(), fused[2].n_b.numpy())


@pytest.mark.parametrize("p", [1.25, "mixed"])
@pytest.mark.parametrize("flag", ["compressed_band", "energy_perm"])
def test_band_and_energy_perm_match_reference(make_pair, small_ds, flag, p):
    """The sharded index's two-band (int8 screen, then an f32 rescore of the
    survivors) and energy-ordered verification against the reference's on
    the same segments, independent policy: ids up to near-tie swaps, n_p,
    n_f32_rows_frac and n_band_frac equal (compare_search); within the
    port, the default verification's ids."""
    ref, port = make_pair("independent")
    ref.params = RParams(t=T, **{flag: True})
    port.params = UHNSWParams(t=T, **{flag: True})
    pv = MIXED if p == "mixed" else p
    ids, _, st = compare_search(ref, port, small_ds.queries, pv)
    if flag == "compressed_band":
        assert float(st.n_band_frac.float().mean()) > 0.0
    _, plain = make_pair("independent")
    want = plain.search(torch.from_numpy(small_ds.queries),
                        torch.from_numpy(pv) if p == "mixed" else pv, K)[0]
    np.testing.assert_array_equal(ids.numpy(), want.numpy())


@pytest.mark.parametrize("p", [1.0, 2.0])
def test_conservative_rank_ids_equal_independent(make_pair, small_ds, p):
    """thresh_rank = t prunes nothing that could enter the merged top-t."""
    Q = small_ds.queries
    _, ind = make_pair("independent")
    _, safe = make_pair("two_phase", probe=1, thresh_rank=T)
    ids_r, d_r, st_r = ind.search(Q, p, K)
    ids_s, d_s, st_s = safe.search(Q, p, K)
    np.testing.assert_array_equal(ids_r.numpy(), ids_s.numpy())
    np.testing.assert_allclose(d_r.numpy(), d_s.numpy(), rtol=1e-6)
    assert float(st_s.n_b.float().mean()) < float(st_r.n_b.float().mean())


# ---------------------------------------------------------------------------
# delta tier: before and after compaction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy,abandon", [("independent", True), ("two_phase", False)])
def test_delta_and_compaction_match_reference(make_pair, small_ds, policy, abandon):
    ref, port = make_pair(policy, abandon=abandon)
    data = small_ds.data
    rng = np.random.default_rng(5)
    vecs = (data.mean(0) + 6.0 * rng.standard_normal((16, data.shape[1]))).astype(np.float32)
    gids = []
    for v in vecs[:5]:
        assert ref.add(v) == port.add(v)
        gids.append(len(data) + len(gids))
    assert len(port.delta) == len(ref.delta) == 5 and gids[0] == len(data)
    Q = np.concatenate([vecs[:5], small_ds.queries[:19]])

    def check_all():
        for p in (0.5, 2.0, MIXED):
            atol = 0.05 if np.isscalar(p) and p == 2.0 else ATOL
            ids, d, _ = compare_search(ref, port, Q, p, atol=atol)
            np.testing.assert_array_equal(ids[:5, 0].numpy(), gids)     # each its own NN
            assert float(d[:5, 0].abs().max()) == pytest.approx(0.0, abs=0.05)

    check_all()                              # in the delta tier
    for v in vecs[5:]:
        ref.add(v)
        port.add(v)                          # the 16th add compacts
    assert port.num_segments == ref.num_segments == 5 and len(port.delta) == 0
    assert port.n == ref.n == len(data) + 16 and port.X.shape[0] == port.n
    np.testing.assert_array_equal(port.get_vector(gids[2]), vecs[2])
    check_all()                              # in the compacted segment


def test_delta_buffer_search_matches_reference(small_ds):
    rng = np.random.default_rng(2)
    d = small_ds.data.shape[1]
    ref, port = RDeltaBuffer(d, 32), DeltaBuffer(d, 32)
    Q = small_ds.queries[:6]
    z_ids, z_d, z_nd = port.search(torch.from_numpy(Q), 0.8)
    assert z_ids.shape == z_d.shape == z_nd.shape == (6, 0)
    for i, v in enumerate(rng.standard_normal((20, d)).astype(np.float32) * 30):
        ref.add(v, 5000 + i)
        port.add(v, 5000 + i)
    for p in (0.8, MIXED[:6]):
        pj = jnp.asarray(p) if isinstance(p, np.ndarray) else p
        w = ref.search(jnp.asarray(Q), pj)
        g = port.search(torch.from_numpy(Q), p)
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w[0]))
        assert_close(g[1].numpy(), np.asarray(w[1]))
        np.testing.assert_array_equal(g[2].numpy(), np.asarray(w[2]))
        # with a bound at each row's 5th-best: survivors exact, nd equal
        th = np.sort(np.asarray(w[1]), 1)[:, 4].astype(np.float32)
        w = ref.search(jnp.asarray(Q), pj, thresh=jnp.asarray(th))
        g = port.search(torch.from_numpy(Q), p, thresh=torch.from_numpy(th))
        assert_close(g[1].numpy(), np.asarray(w[1]))
        np.testing.assert_array_equal(g[2].numpy(), np.asarray(w[2]))
        assert int(np.isfinite(g[1].numpy()).sum(1).min()) >= 5


# ---------------------------------------------------------------------------
# segment health: degraded search, coverage, poison, canaries
# ---------------------------------------------------------------------------


def _subset_clone(idx, alive):
    """A port index of only `alive`'s segments, in the same id space."""
    segs = idx.segments
    sub = ShardedUHNSW(
        SegmentedGraphs(graphs1=[segs.graphs1[i] for i in alive],
                        graphs2=[segs.graphs2[i] for i in alive],
                        global_ids=[segs.global_ids[i].copy() for i in alive]),
        idx.X, params=idx.params, sharded_params=idx.sharded_params)
    sub._next_id = idx._next_id
    for v, g in zip(idx.delta.vectors(), idx.delta.ids()):
        sub.delta.add(v, int(g))
    return sub


@pytest.mark.parametrize("policy", list(POLICIES))
def test_degraded_equals_subset_index_and_reference(make_pair, small_ds, policy):
    ref, port = make_pair(policy, delta_capacity=64)
    rng = np.random.default_rng(3)
    for v in (small_ds.data.mean(0) + 3.0 * rng.standard_normal((5, 128))).astype(np.float32):
        ref.add(v)
        port.add(v)
    ref.health.quarantine(1)
    port.health.quarantine(1)
    sub = _subset_clone(port, [0, 2, 3])
    Q = small_ds.queries
    for p in (*P_GRID, MIXED):
        ids_d, d_d, st_d = port.search(Q, p, K)
        ids_s, d_s, st_s = sub.search(Q, p, K)
        np.testing.assert_array_equal(ids_d.numpy(), ids_s.numpy())
        np.testing.assert_array_equal(d_d.numpy(), d_s.numpy())
        assert st_d.degraded and not st_s.degraded
    compare_search(ref, port, Q, MIXED)


def test_coverage_frac_is_exact(make_pair, small_ds):
    _, port = make_pair(delta_capacity=64)
    sizes = [g.n for g in port.segments.graphs1]
    rng = np.random.default_rng(5)
    for v in rng.standard_normal((5, 128)).astype(np.float32):
        port.add(v)
    port.health.quarantine(1)
    expect = (sum(sizes) - sizes[1] + 5) / (sum(sizes) + 5)
    assert port.coverage_frac() == pytest.approx(expect, abs=1e-12)
    _, _, st = port.search(small_ds.queries[:4], 1.3, k=5)
    assert st.coverage_frac == pytest.approx(expect, abs=1e-12) and st.degraded


def poison_port(idx, seg: int) -> set:
    """NaN-poison every copy of segment `seg`'s rows, as the reference's
    `poison_segment` does; returns its global ids."""
    gids = idx.segments.global_ids[seg]
    rows = torch.from_numpy(gids)
    idx.X = idx.X.clone()
    idx.X[rows] = torch.nan
    idx.segments.X[seg, :len(gids)] = torch.nan
    for graphs in (idx.segments.graphs1, idx.segments.graphs2):
        graphs[seg].data = torch.full_like(graphs[seg].data, torch.nan)
    return set(map(int, gids))


def test_poison_detected_at_every_p_and_never_returned(make_pair, small_ds):
    ref, port = make_pair(deep=True)
    gids = poison_port(port, 2)
    assert gids == set(map(int, poison_segment(ref, 2)))
    Q = small_ds.queries
    for p in P_GRID:
        ids, dists, st = port.search(Q, p, K)
        assert bool(st.poisoned.any()), f"p={p}: guard missed"
        got = {int(i) for i in ids.flatten() if i >= 0}
        assert not (got & gids), f"p={p}: poisoned ids leaked"
        assert bool(dists[ids >= 0].isfinite().all())
    compare_search(ref, port, Q, 1.25)


def test_canary_probe_localises_poison(make_pair, small_ds):
    _, port = make_pair(deep=True)
    poison_port(port, 2)
    assert port.canary_probe(3) is True
    assert port.canary_probe(2) is False
    Q = small_ds.data[:4]
    assert not bool(port.search_stage_candidates(Q, 2.0, k=5, alive=[0, 1]).poisoned.any())
    assert bool(port.search_stage_candidates(Q, 2.0, k=5, alive=[2, 3]).poisoned.any())


def test_health_tracker_and_compaction_resize(make_pair):
    events = [("record_failure", 0)] * 4 + [("record_failure", 1), ("record_success", 1),
                                            ("quarantine", 2), ("begin_recovery", 2),
                                            ("record_probe", 2, True), ("record_probe", 2, True),
                                            ("readmit", 2)]
    got, want = SegmentHealthTracker(3), RTracker(3)
    for name, *args in events:
        getattr(got, name)(*args)
        getattr(want, name)(*args)
        assert [got.state(i) for i in range(3)] == [want.state(i) for i in range(3)]
        assert got.alive() == want.alive() and got.generation == want.generation
    assert got.state(0) == QUARANTINED and got.state(2) == HEALTHY
    _, port = make_pair(delta_capacity=64)
    port.health.quarantine(3)
    for v in np.random.default_rng(2).standard_normal((4, 128)).astype(np.float32):
        port.add(v)
    port.compact()
    assert port.health.num_segments == port.num_segments == 5
    assert port.health.state(3) == QUARANTINED and port.health.state(4) == HEALTHY


# ---------------------------------------------------------------------------
# the port's own build
# ---------------------------------------------------------------------------


def test_build_on_cpu_searches_and_compacts(small_ds):
    data = small_ds.data[:1200]
    idx = ShardedUHNSW.build(data, num_segments=2, m=8, params=UHNSWParams(t=64), seed=1,
                             delta_capacity=8, method="bulk", device="cpu")
    assert idx.num_segments == 2 and idx.segments.X.device.type == "cpu"
    Q = torch.from_numpy(small_ds.queries)
    truth = exact_topk(torch.from_numpy(data), Q, 0.8, K)[0]
    ids, _, _ = idx.search(Q, 0.8, K)
    assert recall(ids, truth) >= 0.9
    rng = np.random.default_rng(9)
    gids = [idx.add(rng.standard_normal(128).astype(np.float32) * 3) for _ in range(10)]
    assert idx.num_segments == 3 and len(idx.delta) == 2 and idx.n == 1210
    for gid in gids[::3]:
        ids, _, _ = idx.search(idx.get_vector(gid)[None, :], 1.3, k=1)
        assert int(ids[0, 0]) == gid
