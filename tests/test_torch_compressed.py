"""The port's compressed band, screen and band-aware verification against
`repro`.

The same numpy inputs go through both packages; JAX runs its default CPU
dispatch (the blocked jnp reference of the screen), and the port's screen
wrapper runs its plain version on CPU tensors. The band is built in NumPy by
both, so codes, scales, radii and permutation are equal. The screen's
`keep` and `nd`, and every integer counter of the verification, must be
equal; float32 sums agree to rtol 1e-5, atol 1e-6, since the frameworks sum
in different orders. Ids must equal the reference's up to the order of
near-tied neighbours, and, within the port, the band and energy-ordered
paths must return the default abandon path's ids.
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
from repro.core.hnsw import knn_search as r_knn_search
from repro.core.uhnsw import UHNSW as RUHNSW
from repro.core.uhnsw import UHNSWParams as RParams
from repro.core.uhnsw import verify_candidates as r_verify
from repro.index import compressed as rcomp
from repro.kernels import ops as rops
from repro.kernels.ref import gather_lp_screen_ref as r_screen_ref
from repro_torch.convert import graph_from_reference
from repro_torch.core.uhnsw import UHNSW, UHNSWParams, verify_candidates
from repro_torch.index import compressed as tcomp
from repro_torch.kernels import lp_distance
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import gather_lp_ref, gather_lp_screen_ref
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

VERIFY_DS = Path(__file__).resolve().parents[1] / "results/bench_cache/verify_ds_d96_n1500_q16.pkl"
RTOL, ATOL = 1e-5, 1e-6
K = 10
T = 100
MIXED = np.array([0.5, 0.8, 1.0, 1.25, 1.5, 2.0, 0.6, 1.7] * 2, np.float32)


def _corpus(n=300, d=48, seed=0, nq=6):
    """Heterogeneous per-coordinate energy, the regime the band targets."""
    rng = np.random.default_rng(seed)
    dim_scale = np.exp(rng.standard_normal(d) * 0.8).astype(np.float32)
    X = (rng.standard_normal((n, d)) * dim_scale).astype(np.float32)
    Q = (rng.standard_normal((nq, d)) * dim_scale).astype(np.float32)
    return X, Q


def _close(got, want, err=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want), err_msg=err)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL, err_msg=err)


def _p_pair(p, b, seed=1):
    """(port p, reference p) for a scalar or a per-row "rows" case."""
    if p != "rows":
        return p, p
    pv = np.random.default_rng(seed).choice(MIXED, size=b)
    return torch.from_numpy(pv), jnp.asarray(pv)


def test_build_band_matches_reference():
    X, Q = _corpus(seed=13)
    want = rcomp.build_band(X)
    got = tcomp.build_band(torch.from_numpy(X))
    for name in ("codes", "scale", "radius", "perm"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert got.codes.dtype == torch.int8 and got.codes.device.type == "cpu"
    assert (got.n, got.d) == (want.n, want.d)
    np.testing.assert_array_equal(tcomp.energy_order(X), rcomp.energy_order(X))
    perm = np.random.default_rng(2).permutation(X.shape[1]).astype(np.int32)
    np.testing.assert_array_equal(tcomp.build_band(X, perm, device="cpu").codes.numpy(),
                                  np.asarray(rcomp.build_band(X, perm).codes))


@pytest.mark.parametrize("p", [0.5, 0.8, 1.25, 1.5, 2.0, "rows"])
def test_compressed_lower_bound_matches_reference(p):
    X, Q = _corpus(seed=14)
    band = rcomp.build_band(X)
    perm = np.asarray(band.perm)
    tp, rp = _p_pair(p, Q.shape[0])
    want = rcomp.compressed_lower_bound(jnp.asarray(Q[:, perm]), band.codes[:40], band.scale,
                                        band.radius, rp)
    tband = tcomp.build_band(X, device="cpu")
    got = tcomp.compressed_lower_bound(torch.from_numpy(Q[:, perm]), tband.codes[:40],
                                       tband.scale, tband.radius, tp)
    _close(got, want)


def _screen_case(seed=15, b=8, c=24, n=300, d=64):
    X, Q = _corpus(n=n, d=d, seed=seed, nq=b)
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, n + 2, size=(b, c)).astype(np.int32)     # -1, n, n+1: padding
    return X, Q, ids, rng


@pytest.mark.parametrize("base_p", [1.0, 2.0])
@pytest.mark.parametrize("p", [0.5, 0.8, 1.25, 1.5, 2.0, "rows"])
def test_gather_lp_screen_ref_matches_reference(p, base_p):
    """keep and nd equal the reference's blocked screen, with thresholds
    near each row's survivors, a frozen row, an unbounded row and rows
    without base bounds."""
    X, Q, ids, rng = _screen_case()
    band = rcomp.build_band(X)
    tband = tcomp.build_band(X, device="cpu")
    Qp = Q[:, np.asarray(band.perm)]
    tp, rp = _p_pair(p, Q.shape[0], seed=3)
    full = np.asarray(rops.lp_gather_distance(jnp.asarray(Q), jnp.asarray(ids), jnp.asarray(X),
                                              rp))
    fin = np.where(np.isfinite(full), full, np.nan)
    thr = np.nanpercentile(fin, 30, axis=1).astype(np.float32)
    thr[0], thr[1] = np.inf, -np.inf
    base = np.asarray(rops.lp_gather_distance(jnp.asarray(Q), jnp.asarray(ids), jnp.asarray(X),
                                              base_p))
    sb = np.where(np.isfinite(base), base, 0.0).astype(np.float32)
    sb[2] = 0.0
    want = r_screen_ref(jnp.asarray(Qp), jnp.asarray(ids), band.codes, band.scale, band.radius,
                        jnp.asarray(thr), jnp.asarray(sb), rp, base_p, 16)
    got = gather_lp_screen_ref(torch.from_numpy(Qp), torch.from_numpy(ids), tband.codes,
                               tband.scale, tband.radius, torch.from_numpy(thr),
                               torch.from_numpy(sb), tp, base_p, 16)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[1][1].sum()) == 0 and not bool(got[0][1].any())   # frozen row
    # the dispatcher (block width picked as the reference picks it)
    keep, nd = tops.lp_gather_screen(torch.from_numpy(Qp), torch.from_numpy(ids), tband.codes,
                                     tband.scale, tband.radius, torch.from_numpy(thr),
                                     torch.from_numpy(sb), tp, base_p=base_p)
    r_keep, r_nd = rops.lp_gather_screen(jnp.asarray(Qp), jnp.asarray(ids), band.codes,
                                         band.scale, band.radius, jnp.asarray(thr),
                                         jnp.asarray(sb), rp, base_p=base_p)
    assert keep.dtype == torch.bool and nd.dtype == torch.int32
    np.testing.assert_array_equal(keep.numpy(), np.asarray(r_keep))
    np.testing.assert_array_equal(nd.numpy(), np.asarray(r_nd))


def test_screen_wrapper_runs_plain_version_on_cpu_without_counting():
    X, Q, ids, _ = _screen_case(seed=16)
    band = tcomp.build_band(X, device="cpu")
    Qp = torch.from_numpy(Q)[:, band.perm]
    thr = torch.full((Q.shape[0],), 50.0)
    sb = torch.zeros(ids.shape)
    lp_distance.reset_launch_counts()
    keep, nd = lp_distance.gather_lp_screen(Qp, torch.from_numpy(ids), band.codes, band.scale,
                                            band.radius, thr, sb, 0.8, 1.0, 32)
    want = gather_lp_screen_ref(Qp, torch.from_numpy(ids), band.codes, band.scale, band.radius,
                                thr, sb, 0.8, 1.0, 32)
    assert keep.dtype == torch.bool     # the kernel writes keep as one byte a slot
    np.testing.assert_array_equal(keep.numpy(), want[0].numpy())
    np.testing.assert_array_equal(nd.numpy(), want[1].numpy())
    assert lp_distance.launch_counts()["gather_lp_screen"] == 0


def _loop_inputs(seed=17, b=8, t=25, n=300, d=64):
    """What the two-band verification loop holds: wide (B, t) candidate ids
    (padding among them) and base sums, from which it hands the screen
    kappa-column slices; queries in band order; thresholds near each row's
    survivors, with a frozen (-inf) and an unbounded (+inf) row."""
    X, Q, ids, _ = _screen_case(seed=seed, b=b, c=t, n=n, d=d)
    band = tcomp.build_band(X, device="cpu")
    Qp = torch.from_numpy(Q)[:, band.perm].contiguous()
    ids = torch.from_numpy(ids)
    base = gather_lp_ref(torch.from_numpy(Q), ids, torch.from_numpy(X), 1.0)
    sb = torch.where(base.isfinite(), base, 0.0)
    full = gather_lp_ref(torch.from_numpy(Q), ids, torch.from_numpy(X), 0.8)
    thr = torch.nanquantile(torch.where(full.isfinite(), full, torch.nan), 0.3, dim=1)
    thr[1], thr[2] = -torch.inf, torch.inf
    return band, Qp, ids, sb, thr


@pytest.mark.parametrize("p", [0.8, 1.25, "rows"])
@pytest.mark.parametrize("start", [5, 10, 20])
def test_screen_dispatcher_takes_kappa_slices_and_int64_ids(p, start):
    """ops.lp_gather_screen on the loop's column slices (not contiguous),
    with int32 and int64 ids, returns a bool keep and an int32 nd equal to
    the plain version's on contiguous copies."""
    band, Qp, ids, sb, thr = _loop_inputs()
    tp = torch.from_numpy(np.resize(MIXED, Qp.shape[0])) if p == "rows" else p
    sl = slice(start, start + 5)
    batch, sbs = ids[:, sl], sb[:, sl]
    assert not batch.is_contiguous() and not sbs.is_contiguous()
    want = gather_lp_screen_ref(Qp, batch.contiguous(), band.codes, band.scale, band.radius,
                                thr, sbs.contiguous(), tp, 1.0, 16)
    for ids_in in (batch, batch.long()):
        keep, nd = tops.lp_gather_screen(Qp, ids_in, band.codes, band.scale, band.radius, thr,
                                         sbs, tp, base_p=1.0, block_d=16)
        assert keep.dtype == torch.bool and nd.dtype == torch.int32
        assert keep.shape == nd.shape == (Qp.shape[0], 5)
        np.testing.assert_array_equal(keep.numpy(), want[0].numpy())
        np.testing.assert_array_equal(nd.numpy(), want[1].numpy())


@pytest.mark.parametrize("base_p", [1.0, 2.0])
def test_screen_row_p_rows_equal_scalar_calls(base_p):
    """A (B,) p screens row i as the scalar call at p[i] does, and a (B,)
    p of one value as that scalar."""
    band, Qp, ids, sb, thr = _loop_inputs(seed=18)
    pv = torch.from_numpy(np.resize(MIXED, Qp.shape[0]))
    keep, nd = tops.lp_gather_screen(Qp, ids, band.codes, band.scale, band.radius, thr, sb, pv,
                                     base_p=base_p)
    for p in np.unique(pv.numpy()):
        rows = np.flatnonzero(pv.numpy() == p)
        k1, n1 = tops.lp_gather_screen(Qp, ids, band.codes, band.scale, band.radius, thr, sb,
                                       float(p), base_p=base_p)
        np.testing.assert_array_equal(keep[rows].numpy(), k1[rows].numpy())
        np.testing.assert_array_equal(nd[rows].numpy(), n1[rows].numpy())
        kc, nc = tops.lp_gather_screen(Qp, ids, band.codes, band.scale, band.radius, thr, sb,
                                       torch.full((Qp.shape[0],), float(p)), base_p=base_p)
        np.testing.assert_array_equal(kc.numpy(), k1.numpy())
        np.testing.assert_array_equal(nc.numpy(), n1.numpy())


@pytest.mark.parametrize("p", [0.5, 2.0, "rows"])
def test_screen_frozen_rows_and_padding_scan_nothing(p):
    """A frozen row keeps nothing and scans nothing; padding ids never
    survive and scan nothing; an unbounded row keeps every valid candidate
    after scanning all of it."""
    band, Qp, ids, sb, thr = _loop_inputs(seed=19)
    tp = torch.from_numpy(np.resize(MIXED, Qp.shape[0])) if p == "rows" else p
    keep, nd = tops.lp_gather_screen(Qp, ids, band.codes, band.scale, band.radius, thr, sb, tp,
                                     base_p=1.0, block_d=8)
    pad = (ids < 0) | (ids >= band.n)
    assert pad.any() and not keep[pad].any() and not nd[pad].any()
    assert not keep[1].any() and not nd[1].any()                   # frozen
    assert bool(keep[2][~pad[2]].all()) and bool((nd[2][~pad[2]] == band.d).all())  # +inf


def test_build_band_follows_the_device_rule():
    """A tensor's band stays on its device; a host array's goes to the card
    unless device="cpu" (or another device) is passed."""
    X, _ = _corpus(n=50, d=16, seed=20)
    assert tcomp.build_band(X, device="cpu").codes.device.type == "cpu"
    cpu = tcomp.build_band(torch.from_numpy(X))
    assert all(getattr(cpu, f).device.type == "cpu" for f in ("codes", "scale", "radius", "perm"))
    meta = tcomp.build_band(X, device="meta")
    assert all(getattr(meta, f).device.type == "meta" for f in ("codes", "scale", "radius", "perm"))
    if torch.cuda.is_available():
        assert tcomp.build_band(X).codes.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tcomp.build_band(X)


# ---------------------------------------------------------------------------
# verification and search on the verify corpus, on the reference's graphs
# ---------------------------------------------------------------------------


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


def _assert_ids_match(got_ids, want_ids, want_d, err=""):
    """ids equal up to the order of near-tied neighbours."""
    got_ids, want_ids, want_d = (np.asarray(a) for a in (got_ids, want_ids, want_d))
    assert got_ids.shape == want_ids.shape, err
    for row, (a, b, d) in enumerate(zip(got_ids, want_ids, want_d)):
        i = 0
        while i < len(b) and np.isfinite(d[i]):
            j = i + 1
            while j < len(b) and np.isfinite(d[j]) and abs(d[j] - d[i]) <= RTOL * abs(d[i]) + ATOL:
                j += 1
            assert set(a[i:j].tolist()) == set(b[i:j].tolist()), f"{err} row {row} slots {i}:{j}"
            i = j


@pytest.mark.parametrize("mode", ["band", "x_scan"])
@pytest.mark.parametrize("p", [0.5, 0.8, 1.5, "rows"])
def test_verify_candidates_band_and_scan_view_match_reference(corpus, p, mode):
    """On the reference's own candidates: ids, n_p, iterations, n_dim_frac
    and the two byte counters equal the reference's."""
    data, queries, g1, _ = corpus
    ids, base_d, _, _ = r_knn_search(RGraphArrays.from_graph(g1), jnp.asarray(data),
                                     jnp.asarray(queries), ef=2 * T, t=T)
    pv = MIXED if p == "rows" else p
    if mode == "band":
        r_extra = {"band": rcomp.build_band(data)}
        t_extra = {"band": tcomp.build_band(torch.from_numpy(data))}
    else:
        perm = rcomp.energy_order(data)
        r_extra = {"x_scan": jnp.asarray(data[:, perm]), "scan_perm": jnp.asarray(perm)}
        t_extra = {"x_scan": torch.from_numpy(np.ascontiguousarray(data[:, perm])),
                   "scan_perm": torch.from_numpy(perm.astype(np.int64))}
    want = r_verify(jnp.asarray(queries), ids, jnp.asarray(data),
                    jnp.asarray(pv) if p == "rows" else p, K, 5, 0.92, cand_base=base_d,
                    base_p=1.0, **r_extra)
    got = verify_candidates(torch.from_numpy(queries), torch.from_numpy(np.array(ids)),
                            torch.from_numpy(data), torch.from_numpy(pv) if p == "rows" else p,
                            K, 5, 0.92, cand_base=torch.from_numpy(np.array(base_d)),
                            base_p=1.0, **t_extra)
    assert len(got) == len(want) == 7
    w_ids, w_d, w_np, w_it, w_frac, w_f32, w_band = (np.asarray(a) for a in want)
    _assert_ids_match(got[0], w_ids, w_d)
    _close(got[1], w_d)
    np.testing.assert_array_equal(got[2].numpy(), w_np)
    assert got[3] == int(w_it)
    for g, w in zip(got[4:], (w_frac, w_f32, w_band)):
        np.testing.assert_array_equal(g.numpy(), w)
    if mode == "band":
        assert float(got[5].mean()) < 1.0 and float(got[6].mean()) > 0.0


@pytest.fixture(scope="module")
def indexes(corpus):
    _, _, g1, g2 = corpus
    return (RUHNSW(g1, g2, RParams(t=T)), UHNSW(to_port(g1), to_port(g2), UHNSWParams(t=T)))


@pytest.mark.parametrize("p", [0.5, 1.25, "mixed"])
def test_band_and_energy_perm_search_ids_equal_default(corpus, indexes, p):
    """compressed_band=True and energy_perm=True give the default abandon
    path's ids; the band path's counters equal the reference's search with
    the same flag (the energy-ordered view's are held against the
    reference in the verify_candidates test above)."""
    _, queries, _, _ = corpus
    ref, port = indexes
    queries = queries[:8]
    pp = MIXED[:8] if p == "mixed" else p
    port.params = UHNSWParams(t=T)
    d_ids, d_d, d_st = port.search(queries, pp, K)
    for flag in ("compressed_band", "energy_perm"):
        port.params = replace(UHNSWParams(t=T), **{flag: True})
        ids, dists, st = port.search(queries, pp, K)
        np.testing.assert_array_equal(ids.numpy(), d_ids.numpy(), err_msg=flag)
        _close(dists, d_d, flag)
        np.testing.assert_array_equal(st.n_p.numpy(), d_st.n_p.numpy(), err_msg=flag)
    ref.params = RParams(t=T, compressed_band=True)
    w_ids, w_d, w_st = ref.search(jnp.asarray(queries), jnp.asarray(pp) if p == "mixed" else pp,
                                  K)
    port.params = UHNSWParams(t=T, compressed_band=True)
    ids, _, st = port.search(queries, pp, K)
    _assert_ids_match(ids, w_ids, w_d)
    for name in ("n_b", "n_p", "hops", "n_dim_frac", "n_f32_rows_frac", "n_band_frac"):
        np.testing.assert_array_equal(np.asarray(getattr(st, name), np.float32),
                                      np.asarray(getattr(w_st, name), np.float32), err_msg=name)
    assert float(st.n_band_frac.mean()) > 0.0
    assert port.compressed_band() is port.compressed_band()          # built once
    port.params = UHNSWParams(t=T)
