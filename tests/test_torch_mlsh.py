"""The port's MLSH baseline against `repro.core.mlsh`.

The projection vectors come from the same numpy generator, so they are
bit-equal; the projections are summed by torch rather than numpy, so a
projection could land an ulp from where numpy puts it. Tolerance: the
rounds and N_p are equal on every query but one at most per p (a
projection within an ulp of a window's edge can move one collision count),
and wherever N_p is equal the ids are equal and the rooted distances agree
within rtol 1e-5. The other tests mirror `tests/test_mlsh.py` on the port.
"""

import numpy as np
import pytest
import torch

from repro.core.metrics import numpy_lp
from repro.core.mlsh import MLSH as RMLSH
from repro_torch.core.mlsh import MLSH, sym_stable
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.fixture(scope="module")
def both(small_ds):
    return (MLSH(small_ds.data, m=24, seed=0, device="cpu"),
            RMLSH(small_ds.data, m=24, seed=0))


@pytest.fixture(scope="module")
def mlsh(both):
    return both[0]


def test_tables_match_reference(both):
    ours, ref = both
    for a, b in ((ours.idx1, ref.idx1), (ours.idx05, ref.idx05)):
        np.testing.assert_array_equal(a.a.numpy(), b.a)
        np.testing.assert_allclose(a.proj_sorted.numpy(), b.proj_sorted, rtol=1e-6,
                                   atol=1e-6 * np.abs(b.proj_sorted).max())
        assert a.w == pytest.approx(b.w, rel=1e-6)
        assert a.freq_threshold == b.freq_threshold
    assert ours.index_size_bytes() == ref.index_size_bytes()


@pytest.mark.parametrize("p", [0.5, 0.75, 1.0])
def test_search_matches_reference(both, small_ds, p):
    ours, ref = both
    Q = small_ds.queries
    ids, dists, stats = ours.search_batch_stats(Q, p, 20)
    same = 0
    for i, q in enumerate(Q):
        r_ids, r_d, r_st = ref.search(q, p, 20)
        assert stats[i].base_p == r_st.base_p
        if (stats[i].n_p, stats[i].rounds) != (r_st.n_p, r_st.rounds):
            continue
        same += 1
        np.testing.assert_array_equal(ids[i].numpy(), r_ids)
        np.testing.assert_allclose(dists[i].numpy(), r_d, rtol=1e-5)
    assert same >= len(Q) - 1, f"p={p}: N_p and rounds equal on {same} of {len(Q)}"
    one_ids, one_d, one_st = ours.search(Q[3], p, 20)
    assert torch.equal(one_ids, ids[3]) and one_st == stats[3]


def test_mlsh_recall_and_np(mlsh, small_ds):
    K = 20
    for p in (0.5, 0.75, 1.0):
        ids, dists, nps = mlsh.search_batch(small_ds.queries[:12], p, K)
        rec = 0.0
        for i, q in enumerate(small_ds.queries[:12]):
            d = numpy_lp(q[None], small_ds.data, p, root=False)[0]
            true = set(np.argsort(d, kind="stable")[:K].tolist())
            rec += len(true & set(ids[i].tolist())) / K
        rec /= 12
        assert rec > 0.85, f"p={p} recall {rec}"
        assert (nps <= small_ds.n).all()
        assert nps.mean() < small_ds.n


def test_mlsh_rejects_out_of_range_p(mlsh, small_ds):
    with pytest.raises(ValueError):
        mlsh.search(small_ds.queries[0], 1.5, 10)


def test_mlsh_index_selection(mlsh, small_ds):
    _, _, s_low = mlsh.search(small_ds.queries[0], 0.5, 5)
    _, _, s_high = mlsh.search(small_ds.queries[0], 0.9, 5)
    assert s_low.base_p == 0.5
    assert s_high.base_p == 1.0


def test_sym_stable_tails():
    """alpha=0.5 stable must be much heavier-tailed than Cauchy (alpha=1)."""
    rng = np.random.default_rng(0)
    s05 = np.abs(sym_stable(0.5, 20000, rng))
    s10 = np.abs(sym_stable(1.0, 20000, rng))
    assert np.quantile(s05, 0.99) > 10 * np.quantile(s10, 0.99)


def test_idealized_cost_monotone_in_np(mlsh):
    c1 = mlsh.idealized_query_cost(100, 0.7, 128)
    c2 = mlsh.idealized_query_cost(1000, 0.7, 128)
    assert c2 == pytest.approx(10 * c1)


def test_degenerate_fallback_verifies_everything(small_ds):
    """A window that never grows (max_rounds 1 at a tiny width) leaves
    fewer than k candidates: every point is verified, as in the reference."""
    ours = MLSH(small_ds.data[:300], m=8, seed=2, device="cpu")
    ref = RMLSH(small_ds.data[:300], m=8, seed=2)
    for idx in (ours.idx1, ours.idx05, ref.idx1, ref.idx05):
        idx.w = 1e-12
    ids, _, st = ours.search(small_ds.queries[0], 1.0, 5, max_rounds=1)
    r_ids, _, r_st = ref.search(small_ds.queries[0], 1.0, 5, max_rounds=1)
    assert st.n_p == r_st.n_p == 300
    np.testing.assert_array_equal(ids.numpy(), r_ids)
