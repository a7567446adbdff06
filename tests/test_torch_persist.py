"""The port's durability layer (repro_torch.index.wal / persist) against
`repro`'s.

The port's own contract mirrors tests/test_persist.py: recover(dir), the
newest durable snapshot plus the WAL's durable prefix, lands bitwise on
the state of a never-crashed index (ids and distances at every p, across
compactions, with delta rows pending), and a torn file is detected and
stepped past, never loaded. Across the packages the on-disk format is one:
WAL records are byte-equal, and each package recovers the other's
snapshot + WAL and returns the ids the writer's live index returns, up to
the order of two neighbours whose distances tie within rtol 1e-5, atol
1e-6 (the frameworks sum in different orders; ROADMAP "What parity means
here"). The port runs on CPU tensors (its kernels' plain versions).
"""

import shutil
import warnings

import numpy as np
import pytest
import torch

from repro.index.persist import DurableIndex as RDurableIndex
from repro.index.persist import recover as r_recover
from repro.index.sharded import ShardedUHNSW as RShardedUHNSW
from repro.index.wal import WriteAheadLog as RWriteAheadLog
from repro.index.wal import replay as r_replay
from repro_torch.index import ShardedUHNSW
from repro_torch.index.persist import (
    DurableIndex,
    RecoveryError,
    SnapshotError,
    latest_durable_snapshot,
    list_snapshots,
    load_snapshot,
    read_manifest,
    recover,
    restore_segment,
    save_snapshot,
)
from repro_torch.index.wal import WalCorruption, WriteAheadLog, list_wals, replay, wal_path
from repro_torch.retrieval.engine.faults import poison_segment
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

P_SWEEP = [0.5, 1.0, 1.25, 2.0]
D = 16
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(11)
    return (rng.standard_normal((120, D)).astype(np.float32),   # frozen
            rng.standard_normal((30, D)).astype(np.float32),    # streamed
            rng.standard_normal((5, D)).astype(np.float32))     # queries


def _build(frozen, **kw):
    return ShardedUHNSW.build(frozen, num_segments=2, m=12, seed=3, delta_capacity=12,
                              device="cpu", **kw)


def _rbuild(frozen):
    return RShardedUHNSW.build(frozen, num_segments=2, m=12, seed=3, delta_capacity=12)


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _search_all_p(idx, Q, k=10):
    out = {}
    for p in P_SWEEP:
        ids, dists, _ = idx.search(Q, p, k)
        out[p] = (_np(ids), _np(dists))
    return out


def _assert_identical(a, b):
    for p in P_SWEEP:
        np.testing.assert_array_equal(a[p][0], b[p][0], err_msg=f"ids p={p}")
        np.testing.assert_array_equal(a[p][1], b[p][1], err_msg=f"dists p={p}")


def _assert_ids_near_ties(got, want):
    """ids equal up to the order of near-tied neighbours; distances close."""
    for p in P_SWEEP:
        (gi, gd), (wi, wd) = got[p], want[p]
        np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=ATOL, err_msg=f"dists p={p}")
        for row in range(len(wi)):
            i = 0
            while i < wi.shape[1]:
                j = i + 1
                while j < wi.shape[1] and np.isclose(wd[row, j], wd[row, i], rtol=RTOL,
                                                     atol=ATOL):
                    j += 1
                assert set(gi[row, i:j]) == set(wi[row, i:j]), (p, row, i)
                i = j


# ---------------------------------------------------------------------------
# WAL
# ---------------------------------------------------------------------------


def test_wal_roundtrip_and_boundaries(tmp_path):
    path = wal_path(tmp_path, 0)
    rng = np.random.default_rng(0)
    batches = [(np.arange(i * 3, i * 3 + 3), rng.standard_normal((3, D)).astype(np.float32))
               for i in range(4)]
    bounds = []
    with WriteAheadLog(path, sync=False) as wal:
        for ids, vecs in batches:
            bounds.append(wal.append(ids, vecs))
    got, clean = replay(path)
    assert clean and len(got) == 4
    for (ids, vecs), (gids, gvecs) in zip(batches, got):
        np.testing.assert_array_equal(gids, ids)
        np.testing.assert_array_equal(gvecs, vecs)
    assert bounds == sorted(set(bounds))
    raw = path.read_bytes()
    for n_rec, cut in enumerate(bounds):
        path.write_bytes(raw[:cut])
        got, clean = replay(path)
        assert clean and len(got) == n_rec + 1
        if cut + 7 <= len(raw):
            path.write_bytes(raw[:cut + 7])
            got, clean = replay(path)
            assert not clean and len(got) == n_rec + 1


def test_wal_detects_corruption_not_just_truncation(tmp_path):
    path = wal_path(tmp_path, 0)
    with WriteAheadLog(path, sync=False) as wal:
        wal.append([0], np.ones((1, D), np.float32))
        wal.append([1], np.ones((1, D), np.float32))
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    path.write_bytes(bytes(raw))
    got, clean = replay(path)
    assert not clean and len(got) < 2
    bogus = tmp_path / "wal_00000009.log"
    bogus.write_bytes(b"definitely not a WAL, long enough to have a header")
    with pytest.raises(WalCorruption):
        replay(bogus)


def test_wal_bytes_equal_across_packages(tmp_path):
    """One append stream gives the same file bytes in both packages, and
    each package's replay reads the other's file."""
    rng = np.random.default_rng(5)
    batches = [(np.arange(i, i + c), rng.standard_normal((c, D)).astype(np.float32))
               for i, c in ((0, 1), (1, 4), (5, 2))]
    mine, theirs = wal_path(tmp_path / "port", 0), wal_path(tmp_path / "ref", 0)
    for p in (mine.parent, theirs.parent):
        p.mkdir()
    with WriteAheadLog(mine, sync=False) as a, RWriteAheadLog(theirs, sync=False) as b:
        for ids, vecs in batches:
            assert a.append(ids, vecs) == b.append(ids, vecs)
    assert mine.read_bytes() == theirs.read_bytes()
    for reader, path in ((replay, theirs), (r_replay, mine)):
        got, clean = reader(path)
        assert clean and len(got) == len(batches)
        for (ids, vecs), (gids, gvecs) in zip(batches, got):
            np.testing.assert_array_equal(gids, ids)
            np.testing.assert_array_equal(gvecs, vecs)


# ---------------------------------------------------------------------------
# snapshots and recovery
# ---------------------------------------------------------------------------


def test_snapshot_roundtrip_bitwise(tmp_path, corpus):
    frozen, streamed, Q = corpus
    idx = _build(frozen)
    for v in streamed[:5]:
        idx.add(v)
    path = save_snapshot(idx, tmp_path)
    assert read_manifest(path)["seq"] == 0
    back = load_snapshot(path, device="cpu")
    assert back.n == idx.n and back._next_id == idx._next_id
    assert len(back.delta) == len(idx.delta) == 5
    assert back.X.device.type == "cpu"
    np.testing.assert_array_equal(_np(back.X), _np(idx.X))
    np.testing.assert_array_equal(back.delta.ids(), idx.delta.ids())
    _assert_identical(_search_all_p(back, Q), _search_all_p(idx, Q))


def test_recovery_identity_with_compactions_and_delta(tmp_path, corpus):
    frozen, streamed, Q = corpus
    idx = _build(frozen)
    dur = DurableIndex.create(idx, tmp_path)
    for v in streamed:                           # 30 adds, compacts at 12 and 24
        dur.add(v)
    assert idx.num_segments == 4 and len(idx.delta) == 6
    rec = recover(tmp_path, device="cpu")
    assert rec.n == idx.n and len(rec.delta) == 6
    assert rec._build_method == idx._build_method
    _assert_identical(_search_all_p(rec, Q), _search_all_p(idx, Q))
    dur.close()


def test_kill_in_the_middle_sweep(tmp_path, corpus):
    """Truncate the live WAL at every record boundary and mid-record:
    recovery lands on the matching prefix of adds (structure at every cut,
    bitwise searches at the interesting ones). Each cut re-materializes
    the state directory as it stood at that moment."""
    frozen, streamed, Q = corpus
    n0 = len(frozen)
    state = tmp_path / "state"
    dur = DurableIndex.create(_build(frozen), state)
    n_adds = 14
    for v in streamed[:n_adds]:
        dur.add(v)
    dur.close()
    pristine = tmp_path / "pristine"
    shutil.copytree(state, pristine)

    interesting = {0, 6, 12, n_adds}
    ref_results, ref_segs = {}, {}
    ref = _build(frozen)
    for count in range(n_adds + 1):
        if count:
            ref.add(streamed[count - 1])
        ref_segs[count] = ref.num_segments
        if count in interesting:
            ref_results[count] = _search_all_p(ref, Q)

    wals = {seq: p.read_bytes() for seq, p in list_wals(pristine)}
    assert len(wals) == 2
    rec_bytes = 12 + 8 + (8 + 4 * D)
    cuts = []
    base_count = 0
    for seq in sorted(wals):
        batches, clean = replay(wal_path(pristine, seq))
        assert clean
        off = 8
        cuts.append((seq, off, base_count))
        for ids, _ in batches:
            assert len(ids) == 1
            off += rec_bytes
            base_count += 1
            cuts.append((seq, off, base_count))
        assert off == len(wals[seq])
    assert base_count == n_adds

    for seq, cut, count in cuts:
        for extra in (0, 7):
            shutil.rmtree(state)
            shutil.copytree(pristine, state)
            for s_snap, p_snap in list_snapshots(state):
                if s_snap > seq:
                    shutil.rmtree(p_snap)
            for s_wal, p_wal in list_wals(state):
                if s_wal > seq:
                    p_wal.unlink()
                elif s_wal == seq:
                    p_wal.write_bytes(wals[seq][:cut + extra])
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                rec = recover(state, device="cpu")
            assert rec.n == n0 + count, (seq, cut, extra)
            assert rec.num_segments == ref_segs[count], (seq, cut, extra)
            if count in ref_results and extra == 0:
                _assert_identical(_search_all_p(rec, Q), ref_results[count])


def test_torn_newest_snapshot_falls_back(tmp_path, corpus):
    frozen, streamed, Q = corpus
    idx = _build(frozen)
    dur = DurableIndex.create(idx, tmp_path)
    for v in streamed[:14]:
        dur.add(v)
    dur.close()
    want = _search_all_p(idx, Q)
    snaps = list_snapshots(tmp_path)
    assert len(snaps) == 2
    newest = snaps[-1][1] / "arrays.npz"
    newest.write_bytes(newest.read_bytes()[:100])
    with pytest.raises(SnapshotError):
        read_manifest(snaps[-1][1])
    with pytest.warns(UserWarning, match="skipping non-durable snapshot"):
        assert latest_durable_snapshot(tmp_path) == snaps[0][1]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rec = recover(tmp_path, device="cpu")
    assert rec.n == idx.n
    _assert_identical(_search_all_p(rec, Q), want)


def test_wal_gap_refuses_silent_recovery(tmp_path, corpus):
    frozen, streamed, _ = corpus
    dur = DurableIndex.create(_build(frozen), tmp_path)
    for v in streamed[:14]:
        dur.add(v)
    dur.close()
    for _, p in list_snapshots(tmp_path)[1:]:
        (p / "arrays.npz").write_bytes(b"torn")
    w0 = wal_path(tmp_path, 0)
    w0.write_bytes(w0.read_bytes()[:8])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(RecoveryError, match="id gap"):
            recover(tmp_path, device="cpu")


def test_recovered_durable_index_keeps_accepting_writes(tmp_path, corpus):
    frozen, streamed, Q = corpus
    dur = DurableIndex.create(_build(frozen), tmp_path)
    for v in streamed[:5]:
        dur.add(v)
    dur.close()
    dur2 = DurableIndex.recover(tmp_path, device="cpu")
    for v in streamed[5:10]:
        dur2.add(v)
    dur2.add_batch(streamed[10:13])              # one record; crosses compaction at 12
    want = _search_all_p(dur2.index, Q)
    n_want = dur2.n
    dur2.close()
    rec = recover(tmp_path, device="cpu")
    assert rec.n == n_want == len(frozen) + 13
    _assert_identical(_search_all_p(rec, Q), want)


def test_prune_keeps_fallback_window(tmp_path, corpus):
    frozen, streamed, _ = corpus
    dur = DurableIndex.create(_build(frozen), tmp_path, keep_snapshots=2)
    for v in streamed:
        dur.add(v)
    dur.close()
    seqs = [s for s, _ in list_snapshots(tmp_path)]
    assert len(seqs) == 2
    assert all(s >= seqs[0] - 1 for s, _ in list_wals(tmp_path))
    shutil.rmtree(list_snapshots(tmp_path)[-1][1])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rec = recover(tmp_path, device="cpu")
    assert rec.n == len(frozen) + len(streamed)


def test_recover_raises_when_all_snapshots_torn(tmp_path, corpus):
    frozen, streamed, _ = corpus
    dur = DurableIndex.create(_build(frozen), tmp_path)
    for v in streamed[:14]:
        dur.add(v)
    dur.close()
    snaps = list_snapshots(tmp_path)
    assert len(snaps) >= 2
    for _, p in snaps:
        f = p / "arrays.npz"
        f.write_bytes(f.read_bytes()[:64])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert latest_durable_snapshot(tmp_path) is None
        with pytest.raises(FileNotFoundError):
            recover(tmp_path, device="cpu")
        with pytest.raises(FileNotFoundError):
            DurableIndex.recover(tmp_path, device="cpu")


def test_restore_segment_roundtrip_and_mismatch(tmp_path, corpus):
    """restore_segment writes one segment's rows back from the snapshot
    and drops every cache over the poisoned rows (the probe-phase stacks
    included); the caller's corpus array, which a CPU index's rows share
    memory with, stays clean through poison and restore."""
    frozen, _, Q = corpus
    data = frozen.copy()
    idx = _build(data, sharded_params=None)
    want = _search_all_p(idx, Q)
    DurableIndex.create(idx, tmp_path).close()
    before = _np(idx.X).copy()
    idx._phase_stacks(1.0, 1)                    # a cached probe-phase stack
    gids = poison_segment(idx, 1)
    assert not idx._phase_cache
    np.testing.assert_array_equal(data, frozen)  # the caller's array is untouched
    assert not np.isfinite(_np(idx.segments.X)[1, :len(gids)]).any()
    assert np.isnan(_np(idx.X)[gids]).all()
    assert restore_segment(idx, 1, tmp_path) is True
    np.testing.assert_array_equal(_np(idx.X), before)
    np.testing.assert_array_equal(data, frozen)
    _assert_identical(_search_all_p(idx, Q), want)
    idx.segments.global_ids[0] = idx.segments.global_ids[0] + 100_000
    assert restore_segment(idx, 0, tmp_path) is False
    empty = tmp_path / "nothing"
    empty.mkdir()
    assert restore_segment(idx, 1, empty) is False


def test_load_snapshot_rejects_garbage_dir(tmp_path):
    bad = tmp_path / "snapshot_00000000"
    bad.mkdir()
    (bad / "manifest.json").write_text("{not json")
    with pytest.raises(SnapshotError):
        load_snapshot(bad, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert latest_durable_snapshot(tmp_path) is None
        with pytest.raises(FileNotFoundError):
            recover(tmp_path, device="cpu")


# ---------------------------------------------------------------------------
# one on-disk format: each package recovers the other's state directory
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("band", [False, True])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_cross_package_recovery(tmp_path, corpus, writer, band):
    """The writer builds, snapshots, takes 14 durable adds (a compaction
    and a rotation at 12, two rows left in the delta tier); the other
    package recovers the directory and returns the writer's live ids. With
    band=True the snapshots carry the int8 band and its permutation."""
    from dataclasses import replace

    frozen, streamed, Q = corpus
    if writer == "reference":
        live = _rbuild(frozen)
        dur = RDurableIndex.create(live, tmp_path)
    else:
        live = _build(frozen)
        dur = DurableIndex.create(live, tmp_path)
    if band:
        live.params = replace(live.params, compressed_band=True)
    for v in streamed[:14]:
        dur.add(v)
    dur.close()
    want = _search_all_p(live, Q)
    if writer == "reference":
        rec = recover(tmp_path, device="cpu")
        assert (rec._band is not None) == band
    else:
        rec = r_recover(tmp_path)
        assert (rec._band is not None) == band
    assert rec.n == live.n and rec.num_segments == live.num_segments == 3
    assert len(rec.delta) == len(live.delta) == 2
    assert rec._build_method == live._build_method
    np.testing.assert_array_equal(_np(rec.X), _np(live.X))
    _assert_ids_near_ties(_search_all_p(rec, Q), want)
