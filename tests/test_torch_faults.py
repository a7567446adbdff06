"""Fault-injected serving, poisoned segments and their recovery in the port
(repro_torch.retrieval.engine) against `repro`'s.

The injector is host logic: one seed must give the reference's fault
schedule. Under it, the port's engine must recover exactly as the
reference's does (the same faults, retries, bisections and failures on
one request stream), and every response must equal the fault-free run's
bit for bit. A NaN-poisoned segment (engine.faults.poison_segment) is
caught by the query-time guard, bisected to, quarantined, restored from
the durable snapshot and re-admitted by the canary probes, and no
poisoned id is ever returned; the caller's corpus array is never written.
The port runs on CPU tensors (its kernels' plain versions); the
monolithic cases search the reference's bulk graphs carried across.
"""

import copy
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.retrieval.engine as r_engine
from repro.core.uhnsw import UHNSW as RUHNSW
from repro.core.uhnsw import UHNSWParams as RParams
from repro.retrieval.service import QueryRequest as RQueryRequest
from repro.retrieval.service import UniversalVectorService as RService
from repro_torch.convert import graph_from_reference
from repro_torch.core.uhnsw import UHNSW, UHNSWParams
from repro_torch.index import HEALTHY, QUARANTINED, SegmentedGraphs, ShardedUHNSW
from repro_torch.index.persist import DurableIndex, restore_segment
from repro_torch.retrieval.engine import (
    DRAINING,
    ENGINE_FAILED,
    EngineClosed,
    EnginePolicy,
    FaultInjector,
    ManualClock,
    ServingEngine,
    segment_site,
)
from repro_torch.retrieval.engine.faults import poison_segment
from repro_torch.retrieval.service import QueryRequest, UniversalVectorService
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

SEEDS = [0, 1, 2]
P_MIX = [0.5, 0.8, 1.0, 1.25, 2.0]
N, D, T = 400, 16, 60


def to_port(g):
    return graph_from_reference(g.adjacency, g.level_nodes, g.local_index, g.entry_point,
                                g.max_level, g.levels, g.data, g.metric_p, g.m, g.m0,
                                device="cpu")


@pytest.fixture(scope="module")
def port_graphs(graphs_bulk):
    return tuple(to_port(g) for g in graphs_bulk)


def _requests(small_ds, n, seed=0, p=None, cls=QueryRequest):
    rng = np.random.default_rng(seed)
    return [cls(vector=small_ds.queries[int(rng.integers(len(small_ds.queries)))],
                p=float(p if p is not None else P_MIX[int(rng.integers(len(P_MIX)))]),
                k=10, request_id=i) for i in range(n)]


@pytest.fixture()
def svc_factory(port_graphs):
    def make(**kw):
        kw.setdefault("max_batch", 32)
        kw.setdefault("min_bucket", 8)
        return UniversalVectorService(index=UHNSW(*port_graphs, UHNSWParams(t=80)), **kw)
    return make


def _assert_fault_accounting(svc, injector, out, failures, all_ids):
    assert set(out).isdisjoint(failures)
    assert set(out) | set(failures) == all_ids
    st = svc.stats
    assert st["faults"] == st["retries"] + st["quarantine_splits"] + st["failed"]
    assert st["faults"] == injector.injected
    assert st["failed"] == len(failures)


# ---------------------------------------------------------------------------
# the injector: the reference's schedule for a seed
# ---------------------------------------------------------------------------


def _schedule(inj, calls):
    out = []
    for site in calls:
        try:
            inj.check(site)
            out.append(None)
        except Exception as e:
            out.append((type(e).__name__, str(e), getattr(e, "segment", None)))
    return out


CALLS = ["search", "verify", "collect", "segment:0", "segment:3", "search", "segment:1"] * 12
INJECTOR_CASES = {
    "classic": dict(rate=0.3, seed=7),
    "timeouts": dict(rate=0.1, timeout_rate=0.2, seed=3),
    "search_only": dict(rate=0.5, seed=11, sites=("search",)),
    "segment_wildcard": dict(rate=0.4, seed=5, sites=("segment", "verify")),
    "one_segment": dict(rate=1.0, seed=0, sites=(segment_site(3),)),
}


@pytest.mark.parametrize("case", sorted(INJECTOR_CASES))
def test_injector_schedule_matches_reference(case):
    kw = INJECTOR_CASES[case]
    mine, theirs = FaultInjector(**kw), r_engine.FaultInjector(**kw)
    first = _schedule(mine, CALLS)
    assert first == _schedule(theirs, CALLS)
    assert (mine.injected, mine.injected_by_site) == (theirs.injected, theirs.injected_by_site)
    mine.reset()
    assert mine.injected == 0 and mine.injected_by_site == {}
    assert _schedule(mine, CALLS) == first


# ---------------------------------------------------------------------------
# faulted serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_faulted_serving_matches_clean_and_reference(svc_factory, small_ds, graphs_bulk, seed):
    """rate 0.25 transient faults: everything served, responses equal to
    the fault-free run bit for bit, and the recovery's counters those of
    the reference's engine on the same stream and seed."""
    reqs = _requests(small_ds, 40, seed=seed)
    clean = svc_factory().serve(reqs)
    assert len(clean) == 40
    inj = FaultInjector(rate=0.25, seed=seed)
    svc = svc_factory(fault_injector=inj)
    out = svc.serve(reqs)
    failures = svc.engine.take_failures()
    _assert_fault_accounting(svc, inj, out, failures, {r.request_id for r in reqs})
    assert svc.stats["faults"] > 0
    for rid in out:
        np.testing.assert_array_equal(out[rid][0], clean[rid][0])
        np.testing.assert_array_equal(out[rid][1], clean[rid][1])
    rinj = r_engine.FaultInjector(rate=0.25, seed=seed)
    rsvc = RService(index=RUHNSW(*graphs_bulk, RParams(t=80)), max_batch=32, min_bucket=8,
                    fault_injector=rinj)
    rout = rsvc.serve(_requests(small_ds, 40, seed=seed, cls=RQueryRequest))
    assert set(rout) == set(out) and rinj.injected == inj.injected
    assert set(rsvc.engine.take_failures()) == set(failures)
    for key in ("faults", "retries", "quarantine_splits", "failed", "batches", "queries"):
        assert svc.stats[key] == rsvc.stats[key], key


def test_timeout_faults_recovered_like_any_exception(svc_factory, small_ds):
    reqs = _requests(small_ds, 24, seed=0)
    clean = svc_factory().serve(reqs)
    inj = FaultInjector(rate=0.1, timeout_rate=0.15, seed=0)
    svc = svc_factory(fault_injector=inj)
    out = svc.serve(reqs)
    failures = svc.engine.take_failures()
    _assert_fault_accounting(svc, inj, out, failures, {r.request_id for r in reqs})
    for rid in out:
        np.testing.assert_array_equal(out[rid][0], clean[rid][0])
        np.testing.assert_array_equal(out[rid][1], clean[rid][1])


def test_poison_request_quarantined_by_bisection(svc_factory, small_ds, monkeypatch):
    """A request that kills its device call every time is isolated by
    bisection and FAILED; its wave-mates are served as without it."""
    d = small_ds.queries.shape[1]
    reqs = _requests(small_ds, 16, seed=1, p=0.8)
    poison_id = 5
    reqs[poison_id] = QueryRequest(vector=np.full(d, 123.456, np.float32), p=0.8, k=10,
                                   request_id=poison_id)
    healthy = [r for r in reqs if r.request_id != poison_id]
    clean = svc_factory().serve(healthy)
    svc = svc_factory()
    real = svc.index.search_stage_candidates

    def guarded(q, base, **kw):
        rows = q.cpu().numpy() if torch.is_tensor(q) else np.asarray(q)
        if np.any(np.all(np.abs(rows - 123.456) < 1e-3, axis=1)):
            raise RuntimeError("poison request aborted the device call")
        return real(q, base, **kw)

    monkeypatch.setattr(svc.index, "search_stage_candidates", guarded)
    out = svc.serve(reqs)
    failures = svc.engine.take_failures()
    assert set(failures) == {poison_id}
    assert "RuntimeError: poison request" in failures[poison_id]
    assert set(out) == {r.request_id for r in healthy}
    assert svc.stats["quarantine_splits"] >= 1 and svc.stats["failed"] == 1
    assert svc.stats["retries"] >= 1
    for rid in out:
        np.testing.assert_array_equal(out[rid][0], clean[rid][0])
        np.testing.assert_array_equal(out[rid][1], clean[rid][1])


def test_rate_one_fails_everything_bounded(svc_factory, small_ds):
    n = 8
    inj = FaultInjector(rate=1.0, seed=0)
    svc = svc_factory(fault_injector=inj)
    reqs = _requests(small_ds, n, seed=2, p=0.8)
    out = svc.serve(reqs)
    failures = svc.engine.take_failures()
    assert out == {} and set(failures) == {r.request_id for r in reqs}
    assert svc.stats["failed"] == n
    assert inj.injected <= (svc.engine.policy.max_retries + 1) * (2 * n - 1)
    assert all("injected transient fault" in err for err in failures.values())


def test_close_and_broken_recovery_reject_admissions(svc_factory, small_ds, monkeypatch):
    svc = svc_factory()
    reqs = _requests(small_ds, 8, seed=3)
    assert len(svc.serve(reqs)) == 8
    eng = svc.engine
    assert eng.close() == {} and eng.state == DRAINING
    for call in (lambda: eng.make_request(reqs[0]), lambda: eng.submit(reqs[0]),
                 lambda: eng.admit([])):
        with pytest.raises(EngineClosed, match="draining"):
            call()
    with pytest.raises(EngineClosed):
        svc.serve(reqs)
    svc = svc_factory(fault_injector=FaultInjector(rate=1.0, seed=0))
    eng = svc.engine

    def broken(wave, exc, work):
        raise RuntimeError("recovery machinery broke")

    monkeypatch.setattr(eng, "_recover", broken)
    with pytest.raises(RuntimeError, match="recovery machinery broke") as ei:
        svc.serve(_requests(small_ds, 4, seed=4))
    assert isinstance(ei.value.partial_results, dict)
    assert eng.state == ENGINE_FAILED
    with pytest.raises(EngineClosed, match="failed"):
        eng.submit(reqs[0])


def test_backoff_advances_injected_clock(svc_factory, small_ds, monkeypatch):
    clk = ManualClock()
    svc = svc_factory(clock=clk, retry_backoff_ms=5.0)
    real = svc.index.search_stage_candidates
    calls = {"n": 0}

    def flaky(q, base, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient")
        return real(q, base, **kw)

    monkeypatch.setattr(svc.index, "search_stage_candidates", flaky)
    reqs = _requests(small_ds, 4, seed=5, p=0.8)
    out = svc.serve(reqs)
    assert set(out) == {r.request_id for r in reqs}
    assert (svc.stats["faults"], svc.stats["retries"]) == (1, 1)
    assert clk() >= 0.005 - 1e-12
    summary = svc.latency_summary()["faults"]
    assert all(summary[k] == svc.stats[k] for k in ("faults", "retries", "failed"))


# ---------------------------------------------------------------------------
# poisoned segments: detection, quarantine, restore, re-admission
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    return rng.standard_normal((N, D)).astype(np.float32)


@pytest.fixture(scope="module")
def base_index(data):
    return ShardedUHNSW.build(data, num_segments=4, m=8, params=UHNSWParams(t=T), seed=0,
                              method="bulk", device="cpu")


def fresh_wrap(base_index, data, **kw):
    """A fresh wrapper over the module build's graphs (copied, so a poison
    rebinds only this wrapper's graph data)."""
    segs = base_index.segments
    clone = SegmentedGraphs(graphs1=[copy.copy(g) for g in segs.graphs1],
                            graphs2=[copy.copy(g) for g in segs.graphs2],
                            global_ids=[i.copy() for i in segs.global_ids])
    kw.setdefault("params", UHNSWParams(t=T))
    idx = ShardedUHNSW(clone, data, **kw)
    idx._build_method = base_index._build_method
    return idx


def make_requests(eng, data, n, start=0, p=1.3, k=5):
    return [eng.make_request(SimpleNamespace(vector=data[(start + i) % len(data)], p=p, k=k,
                                             request_id=start + i)) for i in range(n)]


def _durable_engine(base_index, data, td, **policy):
    dur = DurableIndex.create(fresh_wrap(base_index, data), td, sync=False)
    policy = {"min_bucket": 4, "max_batch": 16, "max_wait_ms": 0.0, **policy}
    return dur, ServingEngine(dur, EnginePolicy(**policy), clock=ManualClock())


def test_poison_quarantine_restore_readmit(base_index, data):
    """poison_segment -> the guard trips -> bisection quarantines the
    segment (at most (max_retries + 1) * 3 probes) -> no poisoned id is
    served -> the maintenance slot restores it from the snapshot -> the
    canary probes re-admit it -> results equal the clean ones. The
    caller's corpus array is never written."""
    corpus = data.copy()
    with tempfile.TemporaryDirectory() as td:
        dur, eng = _durable_engine(base_index, corpus, td)
        clean = eng.serve(make_requests(eng, corpus, 8, start=100))
        gids = set(map(int, poison_segment(dur, 2)))
        np.testing.assert_array_equal(corpus, data)
        probes = []
        orig = dur.index.search_stage_candidates

        def counting(Q, base_p, k=None, alive=None):
            if alive is not None:
                probes.append(sorted(alive))
            return orig(Q, base_p, k=k, alive=alive)

        dur.index.search_stage_candidates = counting
        out = eng.serve(make_requests(eng, corpus, 8, start=100))
        del dur.index.search_stage_candidates
        assert len(out) == 8 and not eng.failures
        assert dur.health.state(2) == QUARANTINED and dur.health.alive() == [0, 1, 3]
        got = {int(i) for ids, _ in out.values() for i in np.asarray(ids)}
        assert not (got & gids), "poisoned ids leaked through the engine"
        assert len(probes) <= (eng.policy.max_retries + 1) * 3
        assert eng.stats["seg_quarantined"] == 1 and eng.stats["poison_detected"] > 0
        eng.pump()                                  # the maintenance slot
        assert dur.health.state(2) == HEALTHY and eng.stats["seg_recovered"] == 1
        assert dur.coverage_frac() == 1.0
        after = eng.serve(make_requests(eng, corpus, 8, start=100))
        for rid in clean:
            np.testing.assert_array_equal(after[rid][0], clean[rid][0])
            np.testing.assert_array_equal(after[rid][1], clean[rid][1])
        np.testing.assert_array_equal(corpus, data)
        dur.close()


def test_segment_rows_copied_once(base_index, data):
    """The first poison copies `X` away from the caller's corpus (a CPU
    index built over a numpy array shares its memory); a restore and a
    second poison write that copy in place, and the corpus is never
    written."""
    corpus = data.copy()
    with tempfile.TemporaryDirectory() as td:
        dur = DurableIndex.create(fresh_wrap(base_index, corpus), td, sync=False)
        assert np.shares_memory(dur.X.numpy(), corpus)
        poison_segment(dur, 1)
        own = dur.X
        assert not np.shares_memory(own.numpy(), corpus)
        assert restore_segment(dur, 1, td)
        poison_segment(dur, 2)
        assert dur.X is own
        assert restore_segment(dur, 2, td)
        assert dur.X is own
        np.testing.assert_array_equal(own.numpy(), data)
        np.testing.assert_array_equal(corpus, data)
        dur.close()


def test_min_coverage_retries_after_recovery(base_index, data):
    with tempfile.TemporaryDirectory() as td:
        dur, eng = _durable_engine(base_index, data, td, min_coverage=0.9, max_retries=3)
        eng.serve(make_requests(eng, data, 4))
        poison_segment(dur, 3)
        out = eng.serve(make_requests(eng, data, 8, start=100))
        assert len(out) == 8 and not eng.failures
        assert eng.stats["seg_recovered"] >= 1 and dur.health.state(3) == HEALTHY
        assert eng.stats["min_coverage_failed"] == 0
        dur.close()


def test_min_coverage_fails_requests_without_durable_home(base_index, data):
    idx = fresh_wrap(base_index, data)
    for seg in (1, 2, 3):
        idx.health.quarantine(seg)
    eng = ServingEngine(idx, EnginePolicy(min_bucket=4, max_batch=16, max_wait_ms=0.0,
                                          min_coverage=0.9), clock=ManualClock())
    assert eng.serve(make_requests(eng, data, 4)) == {}
    fails = eng.take_failures()
    assert len(fails) == 4 and all("coverage" in e and "0.9" in e for e in fails.values())
    assert eng.stats["min_coverage_failed"] == 4 == eng.stats["failed"]


def test_segment_fault_sites_drive_ewma_quarantine(base_index, data):
    idx = fresh_wrap(base_index, data)
    inj = FaultInjector(rate=1.0, seed=0, sites=(segment_site(1),))
    eng = ServingEngine(idx, EnginePolicy(min_bucket=4, max_batch=16, max_wait_ms=0.0,
                                          max_retries=6), clock=ManualClock(),
                        fault_injector=inj)
    out = eng.serve(make_requests(eng, data, 4))
    assert idx.health.state(1) == QUARANTINED
    assert len(out) == 4 and not eng.failures
    assert inj.injected_by_site == {segment_site(1): 4}
    assert eng.stats["seg_quarantined"] == 1


def test_degraded_results_equal_the_alive_subset(base_index, data):
    """With a segment quarantined, the engine serves the ids an index of
    the alive segments alone returns, and never the quarantined rows."""
    idx = fresh_wrap(base_index, data)
    idx.health.quarantine(1)
    eng = ServingEngine(idx, EnginePolicy(min_bucket=4, max_batch=16, max_wait_ms=0.0),
                        clock=ManualClock())
    reqs = make_requests(eng, data, 8, start=50)
    out = eng.serve(reqs)
    dead = set(map(int, idx.segments.global_ids[1]))
    q = torch.from_numpy(np.stack([r.vector for r in reqs]))
    cands = idx.search_stage_candidates(q, 1.0, k=5, alive=[0, 2, 3])
    ids, _, st = idx.search_stage_finish(q, cands, np.full(8, 1.3, np.float32), 5)
    assert st.coverage_frac == pytest.approx(idx.coverage_frac([0, 2, 3]))
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(out[r.request_id][0], ids[i].numpy())
        assert not (set(map(int, out[r.request_id][0])) & dead)


# ---------------------------------------------------------------------------
# NaN base sums: the plain versions kill the candidate at entry, as the
# reference's do (the kernels are held to the plain versions on the card)
# ---------------------------------------------------------------------------


def _nan_inputs(seed=0, b=4, c=6, n=20, d=32):
    """A corpus with one NaN row (id 3), candidate lists naming it and
    padding, base sums from the rows (NaN for row 3) with two more NaN
    sums planted on clean rows, and thresholds that keep most rows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[3] = np.nan
    q = rng.standard_normal((b, d)).astype(np.float32)
    ids = rng.integers(0, n, size=(b, c)).astype(np.int32)
    ids[:, 0] = 3
    ids[1, 5] = -1
    ids[2, 4] = n
    return q, ids, x


@pytest.mark.parametrize("base_p", [1.0, 2.0])
@pytest.mark.parametrize("p", [0.5, 1.25, "mixed"])
@pytest.mark.parametrize("kernel", ["abandon", "screen"])
def test_plain_versions_kill_nan_base_sums_like_reference(kernel, p, base_p):
    import jax.numpy as jnp

    from repro.index.compressed import build_band as r_build_band
    from repro.kernels import ref as rref
    from repro_torch.index.compressed import build_band
    from repro_torch.kernels import ref as pref

    q, ids, x = _nan_inputs()
    diff = np.abs(q[:, None, :] - x[np.clip(ids, 0, len(x) - 1)])
    sb = (diff if base_p == 1.0 else diff * diff).sum(-1).astype(np.float32)
    sb[0, 2] = sb[3, 1] = np.nan                 # NaN sums on clean rows
    assert np.isnan(sb[:, 0]).all()
    thresh = (np.nanmax(np.where(np.isfinite(sb), sb, np.nan), axis=1) * 4.0).astype(np.float32)
    pv = np.array([0.5, 0.8, 1.25, 2.0], np.float32) if p == "mixed" else p
    p_port = torch.from_numpy(pv) if p == "mixed" else pv
    p_ref = jnp.asarray(pv) if p == "mixed" else pv
    t = torch.from_numpy
    if kernel == "abandon":
        got_d, got_nd = pref.gather_lp_abandon_ref(t(q), t(ids), t(x), t(thresh), t(sb),
                                                   p_port, base_p, 8)
        want_d, want_nd = rref.gather_lp_abandon_ref(
            jnp.asarray(q), jnp.asarray(ids), jnp.asarray(x), jnp.asarray(thresh),
            jnp.asarray(sb), p_ref, base_p, 8)
        got_d, want_d = got_d.numpy(), np.asarray(want_d)
        nan_sb = np.isnan(sb)
        assert np.isinf(got_d[nan_sb]).all() and (got_d.shape == want_d.shape)
        np.testing.assert_array_equal(np.isinf(got_d), np.isinf(want_d))
        fin = np.isfinite(want_d)
        np.testing.assert_allclose(got_d[fin], want_d[fin], rtol=1e-5, atol=1e-6)
    else:
        clean = np.where(np.isnan(x), 0.0, x).astype(np.float32)
        band, rband = build_band(clean, device="cpu"), r_build_band(clean)
        perm = band.perm.numpy()
        np.testing.assert_array_equal(perm, np.asarray(rband.perm))
        got_keep, got_nd = pref.gather_lp_screen_ref(
            t(q[:, perm]), t(ids), band.codes, band.scale, band.radius, t(thresh), t(sb),
            p_port, base_p, 8)
        want_keep, want_nd = rref.gather_lp_screen_ref(
            jnp.asarray(q[:, perm]), jnp.asarray(ids), rband.codes, rband.scale,
            rband.radius, jnp.asarray(thresh), jnp.asarray(sb), p_ref, base_p, 8)
        np.testing.assert_array_equal(got_keep.numpy(), np.asarray(want_keep))
        assert not got_keep.numpy()[np.isnan(sb)].any()
    got_nd = got_nd.numpy()
    np.testing.assert_array_equal(got_nd, np.asarray(want_nd))
    assert (got_nd[np.isnan(sb)] == 0).all()     # killed at entry: nothing scanned
