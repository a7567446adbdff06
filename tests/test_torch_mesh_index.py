"""The sharded index placed over a mesh (`ShardedUHNSW.shard_over`) on 2
and 4 gloo ranks, against the unplaced port and the reference.

The conftest's `segments4` graphs (2,000 SIFT-like points, 4 segments,
m = 12) are written to an npz once and carried across by every rank with
`repro_torch.convert.graph_from_reference`, as tests/test_torch_sharded.py
does: no rank builds them. One `torch.multiprocessing` spawn per rank
count (tests/mesh_workers.py `work_index`) places the segment axis over
the mesh's 'data' axis (2 or 4 ranks divide 4 segments: each rank holds
4 / D segments of the stacks) and searches.

Ids, distances and the counters (n_b, its probe / spill split, n_p, hops)
are equal, bit for bit, to the unplaced port's at p 0.5, 1.25, 2.0 and a
mixed batch under the independent, two_phase and round_robin policies; so
are they after a compaction (5 segments: the placement falls back to
replicated) and after a poisoned segment's `restore_segment`; and
`UniversalVectorService.build(rt=...)` serves `serve_grouped` as the
unplaced service does. The placed searches also agree with the
reference's (tests/test_torch_sharded.py's rule: ids up to the order of
neighbours whose distances agree within rtol 1e-5, atol 1e-6; distances
within the same) at every p under the independent policy and on the
mixed batch under the other two; tests/test_torch_sharded.py holds the
unplaced port to the reference at every case.

The clock-driven engine (`UniversalVectorService.serve`) over 2 and 4
ranks, rank 0 deciding and the others following its index calls
(`retrieval.engine.orders`), under a ManualClock: every rank returns the
same results, bit for bit those of the one-rank port's `serve` and of
`serve_grouped` on the same index, for mixed-p requests; under injected
transient faults with the one-rank run's retry stats; and around a
poisoned segment, which is quarantined, restored from the snapshot and
re-admitted as on one rank. The reference's `serve` on 8 forced host
devices (tests/mesh_reference.py `serve`, its index placed on (4, 2))
returns the same ids up to near ties.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.uhnsw import UHNSWParams as RParams
from repro.index import SegmentedGraphs as RSegmentedGraphs
from repro.index import ShardedParams as RShardedParams
from repro.index import ShardedUHNSW as RShardedUHNSW

sys.path.insert(0, str(Path(__file__).resolve().parent))
import mesh_workers as mw  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6
RANKS = [2, 4]
SEARCH_CASES = [(policy, p) for policy in mw.INDEX_POLICIES for p in mw.INDEX_P]
# against the reference: every p under independent, the mixed batch under
# the other two (tests/test_torch_sharded.py holds the unplaced port to the
# reference at every case, and the placed search equals the unplaced one
# bit for bit above)
REF_CASES = [("independent", p) for p in mw.INDEX_P] + [
    (policy, "mixed") for policy in ("two_phase", "round_robin")]


@pytest.fixture(scope="module")
def graphs(segments4, small_ds, tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_index") / "graphs.npz"
    mw.write_graphs(str(path), segments4, small_ds.data, small_ds.queries)
    return path


@pytest.fixture(scope="module")
def results(graphs, segments4, small_ds, tmp_path_factory):
    """(placed: rank count -> rank 0's results of every check, unplaced:
    the unplaced port's, reference: the reference's searches). The ranks
    run while this process computes the other two."""
    from repro_torch.retrieval.service import UniversalVectorService

    ref_out = tmp_path_factory.mktemp("serve_reference") / "serve.npz"
    env = {k: v for k, v in os.environ.items() if not k.startswith(("RANK", "WORLD_SIZE"))}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref_serve = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "mesh_reference.py"), "serve", str(graphs),
         str(ref_out)], cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    runs = {}
    for n in RANKS:
        out = tmp_path_factory.mktemp(f"ranks{n}")
        runs[n] = (out, mw.Ranks(mw.work_index, n, str(graphs), str(out), str(out / "snap"),
                                 timeout=170))
    try:
        npz = np.load(graphs)
        unplaced: dict = {}
        mw.index_paths(lambda policy: mw.make_index(npz, policy), npz, unplaced,
                       str(tmp_path_factory.mktemp("snap_unplaced")))
        svc = UniversalVectorService.build(np.array(npz["data"])[:mw.SERVICE_N],
                                           num_segments=4, m=12, method="bulk", device="cpu")
        mw.service_results(svc, np.array(npz["queries"]), unplaced, "service")
        mw.serve_paths(lambda: mw.make_index(npz, "two_phase"), npz, unplaced,
                       str(tmp_path_factory.mktemp("snap_serve")))
        grouped = UniversalVectorService(index=mw.make_index(npz, "two_phase"))
        mw._served(grouped.serve_grouped(mw._requests(np.array(npz["queries"]))), unplaced,
                   "grouped")
        reference = _reference_searches(segments4, small_ds)
    finally:
        try:
            _, err = ref_serve.communicate(timeout=170)
        finally:
            if ref_serve.poll() is None:
                ref_serve.kill()
            for _, ranks in runs.values():
                ranks.wait()
    assert ref_serve.returncode == 0, err[-3000:]
    reference["serve"] = np.load(ref_out)
    placed = {n: np.load(out / "rank0.npz") for n, (out, _) in runs.items()}
    for n, (out, _) in runs.items():
        placed[n] = dict(placed[n])
        placed[n]["every_rank"] = [np.load(out / f"serve_rank{r}.npz") for r in range(n)]
    return placed, unplaced, reference


def _reference_searches(segments4, small_ds) -> dict:
    out = {}
    for policy in dict.fromkeys(policy for policy, _ in REF_CASES):
        ref = RShardedUHNSW(
            RSegmentedGraphs(graphs1=list(segments4.graphs1), graphs2=list(segments4.graphs2),
                             global_ids=[i.copy() for i in segments4.global_ids]),
            small_ds.data, params=RParams(t=mw.INDEX_T), delta_capacity=16,
            sharded_params=RShardedParams(policy=policy, **mw.INDEX_POLICIES[policy]))
        for p in (p for pol, p in REF_CASES if pol == policy):
            pv = jnp.asarray(mw.INDEX_MIXED) if p == "mixed" else p
            ids, d, st = ref.search(jnp.asarray(small_ds.queries), pv, mw.INDEX_K)
            out[(policy, p)] = (np.asarray(ids), np.asarray(d),
                                {name: np.asarray(getattr(st, name)) for name in mw.STATS})
    return out


@pytest.fixture(scope="module")
def placed(results):
    return results[0]


@pytest.fixture(scope="module")
def unplaced(results):
    return results[1]


def _equal(got, want: dict, prefix: str) -> None:
    keys = sorted(k for k in want if k.startswith(prefix + "/"))
    assert keys, prefix
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("policy,p", SEARCH_CASES)
@pytest.mark.parametrize("ranks", RANKS)
def test_search_equals_unplaced(ranks, policy, p, placed, unplaced):
    assert bool(placed[ranks]["placed/axis"])       # D divides 4 segments
    _equal(placed[ranks], unplaced, f"{policy}/{p}")


@pytest.mark.parametrize("ranks", RANKS)
def test_each_rank_holds_its_segments(ranks, placed, graphs):
    """Rank 0 of D holds segments [0, 4 / D) of arrays1, arrays2,
    segments.X and node_ids; the frozen rows X stay whole."""
    got = placed[ranks]
    n = 4 // ranks
    assert tuple(got["placed/held"]) == (0, n)
    assert got["placed/stack_rows"].tolist() == [n, n, n, n, len(np.load(graphs)["data"])]


@pytest.mark.parametrize("ranks", RANKS)
def test_compaction_replaces(ranks, placed, unplaced):
    """5 segments after the compaction: no dp size divides them, so the
    placement falls back to replicated, and the search is unchanged."""
    got = placed[ranks]
    assert int(got["compacted/n_seg"]) == 5 and not bool(got["compacted/placed"])
    _equal(got, unplaced, "compacted/0.5")
    _equal(got, unplaced, "compacted/mixed")


@pytest.mark.parametrize("ranks", RANKS)
def test_restored_segment_searches_as_unplaced(ranks, placed, unplaced):
    got = placed[ranks]
    assert bool(got["restored/ok"]) and bool(unplaced["restored/ok"])
    _equal(got, unplaced, "restored/1.25")
    _equal(got, unplaced, "restored/mixed")


@pytest.mark.parametrize("ranks", RANKS)
def test_service_build_rt_serves_grouped_as_unplaced(ranks, placed, unplaced):
    got = placed[ranks]
    assert bool(got["service/placed"])
    _equal(got, unplaced, "service")


def _serve_equal(got: dict, want: dict, prefix: str, want_prefix: str | None = None) -> None:
    """Every request of want's `want_prefix` in got's `prefix`, bit for bit."""
    want_prefix = want_prefix or prefix
    keys = sorted(k for k in want if k.startswith(want_prefix + "/")
                  and k.endswith(("/ids", "/dists")))
    assert keys, want_prefix
    for k in keys:
        np.testing.assert_array_equal(got[prefix + k[len(want_prefix):]], want[k], err_msg=k)


@pytest.mark.parametrize("ranks", RANKS)
def test_engine_serve_refuses_more_than_one_rank(ranks, placed, unplaced):
    """(The name is the one this check had when serve refused a mesh.)
    serve over `ranks` gloo ranks: every rank returns the same results,
    bit for bit the one-rank port's serve and serve_grouped on the same
    index, and rank 0's stats are the one-rank run's."""
    got = placed[ranks]
    for r, mine in enumerate(got["every_rank"]):
        assert sorted(mine.files) == sorted(k for k in got if k.startswith("serve/")
                                            and k.endswith(("/ids", "/dists"))), r
        _serve_equal(mine, got, "serve", "serve")
    _serve_equal(got, unplaced, "serve/clean")
    _serve_equal(got, unplaced, "serve/clean", "grouped")
    for name in mw.SERVE_STATS:
        assert int(got[f"serve/clean/stats/{name}"]) == int(
            unplaced[f"serve/clean/stats/{name}"]), name


@pytest.mark.parametrize("ranks", RANKS)
def test_engine_serve_over_ranks_under_faults(ranks, placed, unplaced):
    """Injected transient faults (rank 0's injector): the same requests
    served or failed as on one rank, with the same retry stats, and every
    served result equal to the clean one."""
    got = placed[ranks]
    np.testing.assert_array_equal(got["serve/faults/failed_ids"],
                                  unplaced["serve/faults/failed_ids"])
    _serve_equal(got, unplaced, "serve/faults")
    assert int(got["serve/faults/stats/faults"]) > 0
    for name in mw.SERVE_STATS:
        assert int(got[f"serve/faults/stats/{name}"]) == int(
            unplaced[f"serve/faults/stats/{name}"]), name
    served = [k for k in got if k.startswith("serve/faults/") and k.endswith(("/ids", "/dists"))]
    for k in served:
        np.testing.assert_array_equal(got[k], got["serve/clean/" + k[len("serve/faults/"):]])


@pytest.mark.parametrize("ranks", RANKS)
def test_engine_serve_over_ranks_restores_poisoned_segment(ranks, placed, unplaced):
    """A poisoned segment is quarantined (served at reduced coverage, as on
    one rank), then restored from the snapshot on every rank and
    re-admitted: the next serve equals the clean one."""
    got = placed[ranks]
    assert got["serve/poisoned/alive"].tolist() == [0, 2, 3]
    assert got["serve/restored/alive"].tolist() == [0, 1, 2, 3]
    _serve_equal(got, unplaced, "serve/poisoned")
    _serve_equal(got, unplaced, "serve/restored")
    _serve_equal(got, got, "serve/restored", "serve/clean")
    for name in mw.SERVE_STATS:
        assert int(got[f"serve/restored/stats/{name}"]) == int(
            unplaced[f"serve/restored/stats/{name}"]), name
    assert int(got["serve/restored/stats/seg_quarantined"]) == 1
    assert int(got["serve/restored/stats/seg_recovered"]) == 1


def test_engine_serve_matches_reference(results):
    """The port's serve over 4 ranks against the reference's serve on 8
    forced host devices: ids equal up to near ties, distances within
    tolerance."""
    placed, _, reference = results
    got, want = placed[4], reference["serve"]
    keys = sorted(k[len("serve/"):-len("/ids")] for k in want.files if k.endswith("/ids"))
    assert keys
    for i in keys:
        d = want[f"serve/{i}/dists"]
        _assert_ids_match([got[f"serve/clean/{i}/ids"]], [want[f"serve/{i}/ids"]], [d], i)
        fin = np.isfinite(d)
        np.testing.assert_allclose(got[f"serve/clean/{i}/dists"][fin], d[fin], rtol=RTOL,
                                   atol=ATOL)


def _assert_ids_match(got_ids, want_ids, want_d, err=""):
    """ids equal, up to the order of near-tied neighbours."""
    for row, (a, b, d) in enumerate(zip(got_ids, np.asarray(want_ids), np.asarray(want_d))):
        i = 0
        while i < len(b) and np.isfinite(d[i]):
            j = i + 1
            while j < len(b) and np.isfinite(d[j]) and abs(d[j] - d[i]) <= RTOL * abs(d[i]) + ATOL:
                j += 1
            assert set(a[i:j].tolist()) == set(b[i:j].tolist()), f"{err} row {row} slots {i}:{j}"
            i = j


@pytest.mark.parametrize("policy,p", REF_CASES)
def test_placed_search_matches_reference(policy, p, results):
    placed, _, reference = results
    got = placed[4]
    ids, d, stats = reference[(policy, p)]
    tag = f"{policy}/{p}"
    _assert_ids_match(got[f"{tag}/ids"], ids, d, tag)
    fin = np.isfinite(d)
    np.testing.assert_allclose(got[f"{tag}/dists"][fin], d[fin], rtol=RTOL, atol=ATOL)
    for name in mw.STATS:
        np.testing.assert_array_equal(got[f"{tag}/{name}"], stats[name], err_msg=f"{tag} {name}")
