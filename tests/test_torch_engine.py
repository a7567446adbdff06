"""The port's serving engine and service (repro_torch.retrieval) against
`repro`'s.

Scheduling is host logic, so the port's scheduler must make the
reference's decisions on the same inputs, and under a `ManualClock` the
port's engine must give the reference's engine's results, flush reasons
and stats counters on one request stream. Both search the reference's
bulk graphs (the conftest's `graphs_bulk`), carried across with
`repro_torch.convert.graph_from_reference`; ids are equal up to the order
of two neighbours whose distances tie within rtol 1e-5, atol 1e-6, and
distances agree to that tolerance (the frameworks sum in different
orders). Within the port, staged execution equals the fused search and
the engine equals `serve_grouped` and `serve_v1` bit for bit. The port
runs on CPU tensors (its kernels' plain versions).
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.retrieval.engine as r_engine
import repro_torch.retrieval.engine as p_engine
from repro.core.uhnsw import UHNSW as RUHNSW
from repro.core.uhnsw import UHNSWParams as RParams
from repro.retrieval.service import QueryRequest as RQueryRequest
from repro.retrieval.service import UniversalVectorService as RService
from repro_torch.convert import graph_from_reference
from repro_torch.core.uhnsw import UHNSW, UHNSWParams
from repro_torch.index import ShardedUHNSW
from repro_torch.launch.serve import main as serve_main
from repro_torch.retrieval.engine import (
    DEADLINE,
    DRAIN,
    FULL,
    ManualClock,
)
from repro_torch.retrieval.service import InsertRequest, QueryRequest, UniversalVectorService
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

P_ACCEPT = [0.5, 0.8, 1.25, 2.0]
RTOL, ATOL = 1e-5, 1e-6


def to_port(g):
    return graph_from_reference(g.adjacency, g.level_nodes, g.local_index, g.entry_point,
                                g.max_level, g.levels, g.data, g.metric_p, g.m, g.m0,
                                device="cpu")


@pytest.fixture(scope="module")
def port_graphs(graphs_bulk):
    return tuple(to_port(g) for g in graphs_bulk)


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _requests(small_ds, n, seed=0, k=10, cls=QueryRequest):
    rng = np.random.default_rng(seed)
    return [cls(vector=small_ds.queries[i % len(small_ds.queries)],
                p=float(rng.choice(P_ACCEPT)), k=k, request_id=i) for i in range(n)]


@pytest.fixture()
def svc(port_graphs):
    return UniversalVectorService(index=UHNSW(*port_graphs, UHNSWParams(t=80)), max_batch=32,
                                  min_bucket=8)


# ---------------------------------------------------------------------------
# the scheduler: the reference's decisions on the same inputs
# ---------------------------------------------------------------------------


def _ereq(m, rid, p=0.8, k=10, now=0.0, max_wait_s=0.005, d=4):
    base = 1.0 if p <= 1.4 else 2.0
    return m.EngineRequest(vector=np.zeros(d, np.float32), p=p, k=k, request_id=rid,
                           base=base, exact=p == base, arrival_t=now,
                           deadline_t=now + max_wait_s)


def _flush_view(flushes):
    return [(f.base, f.k, f.exact, f.reason, [r.request_id for r in f.requests],
             [r.flush_t for r in f.requests]) for f in flushes]


def _case_ladder(m):
    return [m.bucket_ladder(lo, hi) for lo, hi in ((8, 128), (8, 32), (8, 20), (4, 256), (1, 7))]


def _case_chunk_plan(m):
    out = []
    for lo, hi in ((8, 128), (4, 16)):
        lad = m.bucket_ladder(lo, hi)
        out.append([m.chunk_plan(n, lad) for n in range(1, hi + 1)])
    return out


def _case_deadline(m):
    clk = m.ManualClock()
    sched = m.BucketScheduler(m.EnginePolicy(max_batch=32, min_bucket=8), clk)
    trace = []
    for i in range(3):
        sched.admit(_ereq(m, i, now=clk(), max_wait_s=0.005))
        clk.advance(0.001)
    for dt in (0.0, 0.001, 0.002, 0.004):
        clk.advance(dt)
        trace.append((clk(), sched.depth, sched.next_deadline(), _flush_view(sched.poll())))
    return trace


def _case_full(m):
    sched = m.BucketScheduler(m.EnginePolicy(max_batch=4, min_bucket=2), m.ManualClock())
    for i in range(9):
        sched.admit(_ereq(m, i, max_wait_s=1.0))
    return _flush_view(sched.poll()), sched.depth, _flush_view(sched.flush_all())


def _case_requeue(m):
    sched = m.BucketScheduler(m.EnginePolicy(max_batch=32, min_bucket=8), m.ManualClock())
    for i in range(3):
        sched.admit(_ereq(m, i))
    flushed = sched.flush_all()[0].requests
    sched.admit(_ereq(m, 99))
    sched.requeue(flushed)
    return _flush_view(sched.flush_all())


def _case_keys(m):
    sched = m.BucketScheduler(m.EnginePolicy(max_batch=32, min_bucket=8), m.ManualClock())
    for i, (p, k) in enumerate([(0.5, 10), (0.8, 10), (1.25, 10), (1.0, 10), (2.0, 10),
                                (0.5, 5), (1.7, 10), (2.0, 5)]):
        sched.admit(_ereq(m, i, p=p, k=k))
    return _flush_view(sched.flush_all())


def _case_watermark(m):
    pol = m.EnginePolicy(max_batch=16, min_bucket=4, watermark=3, overload=m.DEGRADE)
    sched = m.BucketScheduler(pol, m.ManualClock())
    out = []
    for i in range(5):
        out.append(sched.over_watermark())
        sched.admit(_ereq(m, i))
    return out, pol.ladder


SCHEDULER_CASES = {"ladder": _case_ladder, "chunk_plan": _case_chunk_plan,
                   "deadline": _case_deadline, "full": _case_full, "requeue": _case_requeue,
                   "keys": _case_keys, "watermark": _case_watermark}


@pytest.mark.parametrize("case", sorted(SCHEDULER_CASES))
def test_scheduler_matches_reference(case):
    fn = SCHEDULER_CASES[case]
    assert fn(p_engine) == fn(r_engine)


# ---------------------------------------------------------------------------
# staged index API: composition identity
# ---------------------------------------------------------------------------


def test_stage_composition_matches_fused_search(small_ds, port_graphs):
    idx = UHNSW(*port_graphs, UHNSWParams(t=80))
    Q = torch.from_numpy(small_ds.queries[:8])
    for p, base in ((0.8, 1.0), (2.0, 2.0), (1.25, 1.0)):
        fused_ids, fused_d, fused_st = idx.search(Q, p, 10)
        cands = idx.search_stage_candidates(Q, base)
        sids, sd, sst = idx.search_stage_finish(Q, cands, p, 10)
        assert torch.equal(fused_ids, sids) and torch.equal(fused_d, sd), p
        assert torch.equal(fused_st.n_b, sst.n_b)
    ps = np.array([0.5, 0.8, 1.0, 1.25] * 2, np.float32)
    fused_ids, fused_d, _ = idx.search(Q, ps, 10)
    cands = idx.search_stage_candidates(Q, 1.0)
    sids, sd, _ = idx.search_stage_finish(Q, cands, ps, 10)
    assert torch.equal(fused_ids, sids) and torch.equal(fused_d, sd)


@pytest.fixture(scope="module")
def sharded(small_ds):
    sh = ShardedUHNSW.build(small_ds.data, num_segments=3, m=12, params=UHNSWParams(t=60),
                            seed=0, delta_capacity=64, device="cpu")
    for i in range(6):   # delta-resident rows merge inside stage B
        sh.add(small_ds.data[i] + 0.01)
    return sh


def test_sharded_stage_composition_with_delta(small_ds, sharded):
    Q = torch.from_numpy(small_ds.queries[:6])
    for p, base in ((0.8, 1.0), (2.0, 2.0)):
        fused_ids, fused_d, _ = sharded.search(Q, p, 10)
        cands = sharded.search_stage_candidates(Q, base)
        sids, sd, _ = sharded.search_stage_finish(Q, cands, p, 10)
        assert torch.equal(fused_ids, sids) and torch.equal(fused_d, sd), p
    ps = np.array([1.5, 2.0, 1.75, 2.0, 1.5, 1.9], np.float32)
    fused_ids, fused_d, _ = sharded.search(Q, ps, 10)
    cands = sharded.search_stage_candidates(Q, 2.0)
    sids, sd, _ = sharded.search_stage_finish(Q, cands, ps, 10)
    assert torch.equal(fused_ids, sids) and torch.equal(fused_d, sd)


# ---------------------------------------------------------------------------
# the port's engine against the reference's
# ---------------------------------------------------------------------------

STAT_KEYS = ("queries", "batches", "padded_rows", "queue_peak", "flushes", "shed", "degraded",
             "faults", "retries", "quarantine_splits", "failed", "n_b", "n_p", "n_b_probe",
             "n_b_spill", "n_p_probe", "n_p_spill")


def _drive(service_cls, request_cls, index, small_ds):
    """One request stream, driven incrementally under a ManualClock:
    arrivals 1 ms apart with a 5 ms deadline, k 10 and 5, a burst of 24
    one-bucket requests (a full flush; past the watermark the overflow is
    degraded onto the exact lane), then a drain."""
    clk = (r_engine if service_cls is RService else p_engine).ManualClock()
    svc = service_cls(index=index, max_batch=16, min_bucket=4, max_wait_ms=5.0, clock=clk,
                      watermark=20, overload="degrade")
    eng = svc.engine
    rng = np.random.default_rng(3)
    out = {}

    def arrive(rid, p, k):
        r = request_cls(vector=small_ds.queries[rid % len(small_ds.queries)], p=p, k=k,
                        request_id=rid)
        eng.admit([eng.make_request(r)])

    for i in range(60):
        arrive(i, float(rng.choice([0.5, 0.8, 1.0, 1.25, 1.7, 2.0])), 10 if i % 3 else 5)
        clk.advance(0.001)
        if i == 30:
            for j in range(24):
                arrive(100 + j, 0.8, 10)
        if i % 7 == 6:
            eng.pump()
            out.update(eng.take_results())
    out.update(eng.drain())
    return out, svc


def test_engine_matches_reference_under_manual_clock(small_ds, graphs_bulk, port_graphs):
    want, rsvc = _drive(RService, RQueryRequest, RUHNSW(*graphs_bulk, RParams(t=80)), small_ds)
    got, psvc = _drive(UniversalVectorService, QueryRequest,
                       UHNSW(*port_graphs, UHNSWParams(t=80)), small_ds)
    assert set(got) == set(want) and len(got) == 84
    for rid in want:
        gi, gd = _np(got[rid][0]), _np(got[rid][1])
        wi, wd = np.asarray(want[rid][0]), np.asarray(want[rid][1])
        np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=ATOL, err_msg=str(rid))
        i = 0
        while i < len(wi):
            j = i + 1
            while j < len(wi) and np.isclose(wd[j], wd[i], rtol=RTOL, atol=ATOL):
                j += 1
            assert set(gi[i:j]) == set(wi[i:j]), (rid, i)
            i = j
    ps, rs = psvc.stats, rsvc.stats
    assert ps["flushes"][DEADLINE] > 0 and ps["flushes"][FULL] > 0 and ps["degraded"] > 0
    for key in STAT_KEYS:
        assert ps[key] == rs[key], key
    assert ps["dim_frac_w"] == pytest.approx(rs["dim_frac_w"], rel=1e-6)
    assert ps["per_p"] == rs["per_p"]
    for name in ("G1", "G2"):
        for key in ("queries", "batches", "n_b", "n_p"):
            assert ps["per_base"][name][key] == rs["per_base"][name][key], (name, key)
    assert list(ps["latency_records"]) == list(rs["latency_records"])
    assert psvc.latency_summary()["cold_count"] == rsvc.latency_summary()["cold_count"]


def test_engine_bitwise_vs_grouped_and_v1_sharded_delta(small_ds, sharded):
    svc = UniversalVectorService(index=sharded, max_batch=16, min_bucket=8)
    reqs = _requests(small_ds, 20, seed=4)
    engine_out = svc.serve(reqs)
    grouped = svc.serve_grouped(reqs)
    v1 = svc.serve_v1(reqs)
    for r in reqs:
        for other in (grouped, v1):
            np.testing.assert_array_equal(engine_out[r.request_id][0], other[r.request_id][0],
                                          err_msg=f"ids p={r.p}")
            np.testing.assert_array_equal(engine_out[r.request_id][1], other[r.request_id][1])


def test_engine_bitwise_vs_grouped_monolithic(svc, small_ds):
    reqs = _requests(small_ds, 24, seed=5)
    engine_out = svc.serve(reqs)
    grouped = svc.serve_grouped(reqs)
    for r in reqs:
        np.testing.assert_array_equal(engine_out[r.request_id][0], grouped[r.request_id][0])
        np.testing.assert_array_equal(engine_out[r.request_id][1], grouped[r.request_id][1])


# ---------------------------------------------------------------------------
# the port's engine end to end (tests/test_engine.py's cases)
# ---------------------------------------------------------------------------


def test_engine_deadline_flush_end_to_end(small_ds, port_graphs):
    clk = ManualClock()
    svc = UniversalVectorService(index=UHNSW(*port_graphs, UHNSWParams(t=80)), max_batch=32,
                                 min_bucket=8, max_wait_ms=5.0, clock=clk)
    eng = svc.engine
    eng.admit([eng.make_request(QueryRequest(vector=small_ds.queries[i], p=0.8, k=10,
                                             request_id=i)) for i in range(3)])
    eng.pump()
    assert svc.stats["flushes"][DEADLINE] == 0
    clk.advance(0.006)
    eng.pump()
    assert svc.stats["flushes"][DEADLINE] == 1
    out = eng.drain()
    assert len(out) == 3 and svc.stats["flushes"][DRAIN] == 0
    for _, queue, _, _ in list(svc.stats["latency_records"])[-3:]:
        assert queue == pytest.approx(6.0)


def test_engine_partial_and_full_flush(svc, small_ds):
    out = svc.serve(_requests(small_ds, 5, seed=2))
    assert len(out) == 5 and svc.stats["flushes"][DRAIN] >= 1 and svc.stats["queries"] == 5
    before = svc.stats["batches"]
    svc.serve([QueryRequest(vector=small_ds.queries[i % 8], p=0.8, k=10, request_id=100 + i)
               for i in range(32)])
    assert svc.stats["flushes"][FULL] == 1 and svc.stats["batches"] == before + 1


def test_engine_admission_shed_and_degrade(small_ds, port_graphs):
    idx = UHNSW(*port_graphs, UHNSWParams(t=80))
    shed = UniversalVectorService(index=idx, max_batch=32, watermark=4, overload="shed")
    reqs = _requests(small_ds, 10, seed=3)
    out = shed.serve(reqs)
    assert shed.stats["shed"] == 6 and set(out) == {r.request_id for r in reqs[:4]}
    deg = UniversalVectorService(index=idx, max_batch=32, watermark=2, overload="degrade")
    reqs = [QueryRequest(vector=small_ds.queries[i], p=0.8, k=10, request_id=i)
            for i in range(6)]
    out = deg.serve(reqs)
    assert len(out) == 6 and deg.stats["degraded"] == 4
    q = np.stack([r.vector for r in reqs[2:]]).astype(np.float32)
    bids, _, _ = idx.search(q, 1.0, 10)
    for i, r in enumerate(reqs[2:]):
        np.testing.assert_array_equal(out[r.request_id][0], _np(bids)[i])


def test_engine_transient_failure_retried_transparently(svc, small_ds, monkeypatch):
    reqs = [QueryRequest(vector=small_ds.queries[i % 8], p=0.8, k=10, request_id=i)
            for i in range(40)]
    clean = svc.serve(reqs)
    real = svc.index.search_stage_candidates
    calls = {"n": 0}

    def flaky(Q, base_p, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("boom")
        return real(Q, base_p, **kw)

    monkeypatch.setattr(svc.index, "search_stage_candidates", flaky)
    svc2 = UniversalVectorService(index=svc.index, max_batch=32, min_bucket=8)
    out = svc2.serve(reqs)
    assert set(out) == set(range(40)) and svc2.engine.take_failures() == {}
    assert (svc2.stats["faults"], svc2.stats["retries"], svc2.stats["failed"]) == (1, 1, 0)
    for rid, (ids, dists) in out.items():
        np.testing.assert_array_equal(ids, clean[rid][0])
        np.testing.assert_array_equal(dists, clean[rid][1])


def test_submit_validation_hardening(svc, small_ds):
    good = small_ds.queries[0]
    with pytest.raises(ValueError, match="k must be >= 1"):
        svc.submit([QueryRequest(vector=good, p=0.8, k=0, request_id=1)])
    bad = good.copy()
    bad[0] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        svc.submit([QueryRequest(vector=bad, p=0.8, k=5, request_id=2)])
    with pytest.raises(ValueError, match=r"expected d=\d+, got d=3"):
        svc.submit([QueryRequest(vector=np.zeros(3, np.float32), p=0.8, k=5, request_id=3)])
    with pytest.raises(ValueError, match="outside the supported universal range"):
        svc.submit([QueryRequest(vector=good, p=2.5, k=5, request_id=4)])
    assert svc.queue_depth == 0
    with pytest.raises(ValueError, match="k must be >= 1"):
        svc.serve([QueryRequest(vector=good, p=0.8, k=0, request_id=5)])


def test_engine_warmup_and_latency_attribution(svc, small_ds):
    eng = svc.engine
    assert eng.warmup(k=10, ps=(0.8, 1.8, 2.0)) == 3 * len(eng.policy.ladder)
    assert svc.stats["queries"] == 0 and len(svc.stats["latency_ms"]) == 0
    assert eng.take_results() == {}
    svc.serve(_requests(small_ds, 13, seed=9))
    lat = svc.latency_summary()
    assert lat["count"] == 13 and lat["cold_count"] == 0
    for total, queue, compute, _ in svc.stats["latency_records"]:
        assert total == pytest.approx(queue + compute, rel=1e-6, abs=1e-6)
    assert lat["p95"] >= lat["p50"] > 0 and lat["compute_ms"]["p50"] > 0


def test_insert_through_service_compacts(small_ds, sharded):
    """Streaming inserts ride the service into the delta tier; a new row is
    its own top-1 at every p."""
    svc = UniversalVectorService(index=sharded, max_batch=16, min_bucket=8)
    n0, segs0 = sharded.n, sharded.num_segments
    v = small_ds.queries[0] + 50.0
    out = svc.insert([InsertRequest(vector=v, request_id=7)])
    assert out == {7: n0} and svc.stats["inserts"] == 1
    assert svc.stats["compactions"] == sharded.num_segments - segs0
    for p in P_ACCEPT:
        got = svc.serve([QueryRequest(vector=v, p=p, k=1, request_id=0)])
        assert int(got[0][0][0]) == n0, p


# ---------------------------------------------------------------------------
# the command line: create, then recover
# ---------------------------------------------------------------------------


def test_serve_cli_creates_then_recovers(tmp_path, capsys):
    """`--retrieval --state-dir D` twice at n = 2,000 on the CPU (two
    segments, so the shared-pass builder runs): the first run snapshots a
    fresh build, the second recovers it; both serve and report the same n.
    Without --retrieval the command line serves the LM, and refuses a mesh
    of more ranks than it was started with (ROADMAP item 11(c), the mesh:
    torch.distributed.run starts them)."""
    args = ["--retrieval", "--n", "2000", "--segments", "2", "--requests", "48",
            "--state-dir", str(tmp_path / "state"), "--device", "cpu"]
    assert serve_main(args) == 0
    first = capsys.readouterr().out
    assert serve_main(args) == 0
    second = capsys.readouterr().out
    assert "created durable index" in first and "n=2000" in first
    assert "recovered durable index" in second and "n=2000, 2 segments" in second
    for out in (first, second):
        assert "served 48 mixed-p requests" in out and "flushes:" in out
    assert serve_main(["--arch", "tinyllama_1_1b", "--smoke", "--steps", "4",
                       "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("generated (4, 4) tokens")
    with pytest.raises(SystemExit):
        serve_main(["--n", "2000", "--model", "2"])
    assert "start them with python -m torch.distributed.run" in capsys.readouterr().err


_FIGURES = re.compile(r"served (\d+) mixed-p requests .* avg N_b=(\d+) \(probe=(\d+) "
                      r"spill=(\d+)\) N_p=(\d+) dim-scan=([\d.]+) f32-rows=([\d.]+)")


def test_serve_cli_retrieval_on_two_ranks(tmp_path):
    """`--retrieval --data 2` on 2 ranks under torch.distributed.run: each
    rank builds the same index and places its 2 segments over the mesh,
    rank 0 runs the engine and alone prints, and the served count and the
    per-request work (N_b, its split, N_p, dim-scan, f32-rows) equal the
    one-rank run's."""
    root = Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith(("RANK", "WORLD_SIZE"))}
    env.update(PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    args = ["-m", "repro_torch.launch.serve", "--retrieval", "--n", "2000", "--segments", "2",
            "--requests", "48", "--device", "cpu"]
    figures = []
    for ranks in (1, 2):
        head = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
                 f"--nproc-per-node={ranks}"] if ranks > 1 else [sys.executable])
        proc = subprocess.run([*head, *args, "--data", str(ranks)], cwd=root, env=env,
                              capture_output=True, text=True, timeout=240)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert proc.stdout.count("served 48 mixed-p requests") == 1, proc.stdout
        figures.append(_FIGURES.search(proc.stdout).groups())
    assert figures[0] == figures[1]
