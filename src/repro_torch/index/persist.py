"""Durable snapshots + crash recovery for ShardedUHNSW (DESIGN.md §9).

Counterpart of `repro.index.persist`, with the same on-disk format, so
each package loads the other's snapshots and replays the other's logs:

  * graph leaves (`adj0`, `up<l>`, `g2l<l>`) are written as int32, as the
    reference's `GraphArrays` leaves are, and widened to the port's int64
    on load; `levels` int32; segment ids and delta ids int64; the band's
    permutation int32;
  * the manifest's `params` is `asdict(UHNSWParams)`, whose field names
    both packages share, and `build_method` takes the same strings.

A snapshot is an atomic, manifest-based dump of the whole index state:
per-segment graph topology, the frozen rows, the global-id maps, query
params, the remembered build method, and the delta-buffer contents at
save time. It is written to a `.tmp` directory that is fsync'd and then
renamed into place (the rename is the commit point): a crash mid-write
leaves only a `.tmp` directory that loaders never look at, and every array
file carries a CRC32 recorded in the manifest, so a *torn* snapshot is
detected and skipped, never loaded.

Recovery composes the snapshot with the delta write-ahead log
(`repro_torch.index.wal`):

    recover(dir) = load newest durable snapshot
                 + replay the durable prefix of every WAL segment

Replay re-runs each logged insert through `ShardedUHNSW.add`, so a
compaction of the crashed process is re-derived (segment builds are
deterministic: same vectors, same seed, same remembered build method).
Records whose global id is already frozen in the snapshot are skipped; a
replay that would skip past an id (a lost WAL segment) raises
`RecoveryError`. The result equals, ids and distances, the index a
never-crashed process would hold, at every p.

The port keeps the frozen rows only on the device (`index.X`; the
reference also keeps a host mirror), so a save copies them to the host
once, and `restore_segment` writes the device tensors in place, after
copying `index.X`, which may share memory with the caller's corpus.
`ShardedUHNSW.shard_over` is not ported (ROADMAP item 11), so a restore
re-places nothing on a mesh.
"""

from __future__ import annotations

import json
import os
import shutil
import warnings
import zlib
from dataclasses import asdict, fields
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.bulk_build import DeviceGraph
from repro_torch.core.hnsw import GraphArrays
from repro_torch.core.uhnsw import UHNSWParams
from repro_torch.dist.sharding import process_index
from repro_torch.index.compressed import CompressedBand
from repro_torch.index.segment import SegmentedGraphs
from repro_torch.index.sharded import ShardedUHNSW
from repro_torch.index.wal import WriteAheadLog, list_wals, replay, wal_path

SNAPSHOT_PREFIX = "snapshot_"
SNAPSHOT_FORMAT = 1


class SnapshotError(RuntimeError):
    """A snapshot directory is structurally invalid or fails its CRC."""


class RecoveryError(RuntimeError):
    """Recovery cannot reach a consistent state (e.g. a WAL id gap)."""


def snapshot_path(directory, seq: int) -> Path:
    return Path(directory) / f"{SNAPSHOT_PREFIX}{seq:08d}"


def list_snapshots(directory) -> list[tuple[int, Path]]:
    """All committed snapshot dirs (tmp excluded), ascending by sequence."""
    directory = Path(directory)
    if not directory.exists():
        return []
    out = []
    for p in directory.iterdir():
        if p.is_dir() and p.name.startswith(SNAPSHOT_PREFIX) and not p.name.endswith(".tmp"):
            try:
                out.append((int(p.name[len(SNAPSHOT_PREFIX):]), p))
            except ValueError:
                continue
    return sorted(out)


def _fsync_write(path: Path, data: bytes):
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _host(t, dtype) -> np.ndarray:
    return np.asarray(t.cpu().numpy() if torch.is_tensor(t) else t, dtype=dtype)


def _graph_meta(g) -> dict:
    arrays = GraphArrays.from_graph(g)
    return {
        "metric_p": float(arrays.metric_p),
        "m": int(g.m),
        "m0": int(g.m0),
        "entry_point": int(arrays.entry),
        "n": int(arrays.n),
        "n_levels": len(arrays.upper_adj),
    }


def _graph_arrays_items(prefix: str, g):
    """The graph's leaves in the reference's widths (int32)."""
    arrays = GraphArrays.from_graph(g)
    yield f"{prefix}.adj0", _host(arrays.adj0, np.int32)
    for l, (adj, g2l) in enumerate(zip(arrays.upper_adj, arrays.upper_g2l)):
        yield f"{prefix}.up{l}", _host(adj, np.int32)
        yield f"{prefix}.g2l{l}", _host(g2l, np.int32)
    levels = getattr(g, "levels", None)
    if levels is not None:
        yield f"{prefix}.levels", _host(levels, np.int32)


def save_snapshot(index: ShardedUHNSW, directory, seq: int | None = None) -> Path:
    """Write one atomic snapshot of `index` as snapshot_<seq>.

    seq defaults to one past the newest committed snapshot. The manifest is
    written last (fsync'd), then the directory renames into place.

    On-disk layout: `<dir>/snapshot_<seq:08d>/{manifest.json, arrays.npz}`.
    The npz holds `X` ((n, d) f32 frozen rows, copied from the device),
    per-segment `s<i:04d>.{ids,g1.*,g2.*}` graph arrays (int32 leaves,
    int64 ids), `delta.{vecs,ids}` ((c, d) f32 / (c,) int64), and, when a
    compressed band exists or `params.compressed_band` is set,
    `band.{codes,scale,radius,perm}` ((n, d) int8, (d,) f32 / f32 / int32).
    The manifest repeats the band's permutation.
    """
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    if seq is None:
        snaps = list_snapshots(directory)
        seq = snaps[-1][0] + 1 if snaps else 0
    final = snapshot_path(directory, seq)
    tmp = directory / (final.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    seg = index.segments
    payload: dict[str, np.ndarray] = {"X": _host(index.X, np.float32)}
    seg_meta = []
    for i, (g1, g2, ids) in enumerate(zip(seg.graphs1, seg.graphs2, seg.global_ids)):
        pref = f"s{i:04d}"
        payload[f"{pref}.ids"] = np.asarray(ids, dtype=np.int64)
        for key, arr in _graph_arrays_items(f"{pref}.g1", g1):
            payload[key] = arr
        for key, arr in _graph_arrays_items(f"{pref}.g2", g2):
            payload[key] = arr
        seg_meta.append({"n": int(g1.n), "g1": _graph_meta(g1), "g2": _graph_meta(g2)})
    payload["delta.vecs"] = index.delta.vectors()
    payload["delta.ids"] = index.delta.ids().astype(np.int64)

    band = index._band
    if band is None and index.params.compressed_band:
        band = index.compressed_band()
    band_meta = None
    if band is not None:
        payload["band.codes"] = _host(band.codes, np.int8)
        payload["band.scale"] = _host(band.scale, np.float32)
        payload["band.radius"] = _host(band.radius, np.float32)
        payload["band.perm"] = _host(band.perm, np.int32)
        band_meta = {"n": band.n, "d": band.d, "perm": payload["band.perm"].tolist()}

    arrays_file = tmp / "arrays.npz"
    np.savez(arrays_file, **payload)
    with open(arrays_file, "rb") as f:
        os.fsync(f.fileno())
    raw = arrays_file.read_bytes()
    manifest = {
        "format": SNAPSHOT_FORMAT,
        "kind": "uhnsw-sharded",
        "seq": int(seq),
        "next_id": int(index._next_id),
        "delta_capacity": int(index.delta.capacity),
        "delta_count": int(len(index.delta)),
        "build_method": index._build_method,
        "params": asdict(index.params),
        "d": int(index.dim),
        "segments": seg_meta,
        "band": band_meta,
        "arrays": {"file": "arrays.npz", "crc32": zlib.crc32(raw), "size": len(raw)},
    }
    _fsync_write(tmp / "manifest.json", json.dumps(manifest).encode())
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic commit
    return final


def read_manifest(path: Path) -> dict:
    """Load + structurally validate one snapshot's manifest, CRC included.
    Raises SnapshotError on any torn or invalid state."""
    path = Path(path)
    mf = path / "manifest.json"
    try:
        manifest = json.loads(mf.read_text())
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
        raise SnapshotError(f"{path}: unreadable manifest ({e})") from e
    if not isinstance(manifest, dict) or manifest.get("format") != SNAPSHOT_FORMAT \
            or manifest.get("kind") != "uhnsw-sharded":
        raise SnapshotError(f"{path}: manifest is not a format-{SNAPSHOT_FORMAT} "
                            "uhnsw-sharded snapshot")
    info = manifest.get("arrays") or {}
    af = path / str(info.get("file", ""))
    try:
        raw = af.read_bytes()
    except OSError as e:
        raise SnapshotError(f"{path}: missing array file ({e})") from e
    if len(raw) != info.get("size") or zlib.crc32(raw) != info.get("crc32"):
        raise SnapshotError(f"{path}: array file failed its CRC/size check — torn snapshot")
    return manifest


def latest_durable_snapshot(directory) -> Path | None:
    """Newest snapshot that passes full validation; torn or invalid newer
    snapshots are skipped with a warning."""
    for _, path in reversed(list_snapshots(directory)):
        try:
            read_manifest(path)
            return path
        except SnapshotError as e:
            warnings.warn(f"skipping non-durable snapshot: {e}", stacklevel=2)
    return None


def _params_from(manifest: dict) -> UHNSWParams:
    known = {f.name for f in fields(UHNSWParams)}
    kw = {k: v for k, v in (manifest.get("params") or {}).items() if k in known}
    return UHNSWParams(**kw)


def _load_graph(npz, prefix: str, meta: dict, data: torch.Tensor) -> DeviceGraph:
    dev = data.device

    def leaf(key):
        return torch.from_numpy(np.asarray(npz[key], dtype=np.int64)).to(dev)

    arrays = GraphArrays(
        adj0=leaf(f"{prefix}.adj0"),
        upper_adj=[leaf(f"{prefix}.up{l}") for l in range(meta["n_levels"])],
        upper_g2l=[leaf(f"{prefix}.g2l{l}") for l in range(meta["n_levels"])],
        entry=torch.tensor(meta["entry_point"], dtype=torch.int64, device=dev),
        n=meta["n"],
        metric_p=float(meta["metric_p"]),
    )
    lv_key = f"{prefix}.levels"
    levels = leaf(lv_key) if lv_key in npz.files else None
    return DeviceGraph(metric_p=float(meta["metric_p"]), m=int(meta["m"]), m0=int(meta["m0"]),
                       entry_point=int(meta["entry_point"]), max_level=meta["n_levels"],
                       levels=levels, data=data, arrays=arrays)


def load_snapshot(path, params: UHNSWParams | None = None, *, device=None) -> ShardedUHNSW:
    """Reconstruct a ShardedUHNSW from one snapshot directory.

    The rebuilt index equals the saved one: the per-segment graph arrays
    round-trip exactly (the restack re-pads the same inputs to the same
    envelope), the rows are byte-preserved, the delta contents are
    restored verbatim, and a persisted band is reattached as it was.
    `params` overrides the saved UHNSWParams (the manifest copy is
    filtered against the dataclass's fields). device: where the index
    lives (None: "cuda"). Raises SnapshotError on a torn snapshot.
    """
    path = Path(path)
    dev = torch.device("cuda" if device is None else device)
    manifest = read_manifest(path)
    npz = np.load(path / manifest["arrays"]["file"])
    X = torch.from_numpy(np.ascontiguousarray(npz["X"], dtype=np.float32)).to(dev)
    graphs1, graphs2, global_ids = [], [], []
    for i, meta in enumerate(manifest["segments"]):
        pref = f"s{i:04d}"
        ids = np.asarray(npz[f"{pref}.ids"], dtype=np.int64)
        data = X[torch.from_numpy(ids).to(dev)]
        graphs1.append(_load_graph(npz, f"{pref}.g1", meta["g1"], data))
        graphs2.append(_load_graph(npz, f"{pref}.g2", meta["g2"], data))
        global_ids.append(ids)
    segments = SegmentedGraphs(graphs1=graphs1, graphs2=graphs2, global_ids=global_ids)
    idx = ShardedUHNSW(segments, X, params=params or _params_from(manifest),
                       delta_capacity=manifest["delta_capacity"])
    idx._build_method = manifest.get("build_method")
    idx._X_owned = idx.X      # read from the snapshot: no caller shares it
    idx.delta.restore(npz["delta.vecs"], npz["delta.ids"])
    idx._next_id = int(manifest["next_id"])
    if idx._next_id != X.shape[0] + len(idx.delta):
        raise SnapshotError(f"{path}: next_id {idx._next_id} is not {X.shape[0]} frozen "
                            f"+ {len(idx.delta)} delta rows")
    if "band.codes" in npz.files:
        perm = np.asarray(npz["band.perm"], dtype=np.int32)
        band_meta = manifest.get("band") or {}
        if "perm" in band_meta and not np.array_equal(
                np.asarray(band_meta["perm"], dtype=np.int32), perm):
            raise SnapshotError(f"{path}: the band's permutation differs from the manifest's")
        idx._band = CompressedBand(
            codes=torch.from_numpy(np.asarray(npz["band.codes"], dtype=np.int8)).to(dev),
            scale=torch.from_numpy(np.asarray(npz["band.scale"], dtype=np.float32)).to(dev),
            radius=torch.from_numpy(np.asarray(npz["band.radius"], dtype=np.float32)).to(dev),
            perm=torch.from_numpy(perm.astype(np.int64)).to(dev))
    return idx


def restore_segment(index, seg: int, directory) -> bool:
    """Restore one quarantined segment's rows from the newest durable
    snapshot (DESIGN.md §11), the data-plane half of segment recovery.

    Graph topology never goes bad in place; what poison or corruption hits
    is the row storage: the frozen rows `X`, the stacked per-segment
    `segments.X`, and the per-graph data a later restack reads. This
    rewrites all three from snapshot bytes that passed the manifest's CRC
    check, and drops the caches built over the poisoned rows (the band,
    the energy-ordered view and the probe-phase sub-stacks).

    The snapshot's segment is matched by global-id equality, not by
    position. Returns True when `seg` was restored; False when there is no
    durable snapshot or none of its segments matches. Accepts a
    DurableIndex or a bare ShardedUHNSW. Re-admission stays with the
    caller: a restored segment must still pass its canary probes.
    """
    index = getattr(index, "index", index)  # unwrap DurableIndex
    snap = latest_durable_snapshot(directory)
    if snap is None:
        return False
    manifest = read_manifest(snap)  # CRC re-verification
    npz = np.load(snap / manifest["arrays"]["file"])
    live_ids = np.asarray(index.segments.global_ids[seg], dtype=np.int64)
    for i in range(len(manifest["segments"])):
        ids = np.asarray(npz[f"s{i:04d}.ids"], dtype=np.int64)
        if not np.array_equal(ids, live_ids):
            continue
        dev = index.X.device
        rows = torch.from_numpy(np.ascontiguousarray(npz["X"][ids], dtype=np.float32)).to(dev)
        write_segment_rows(index, seg, live_ids, rows)
        return True
    return False


def write_segment_rows(index: ShardedUHNSW, seg: int, gids: np.ndarray,
                       rows: torch.Tensor) -> None:
    """Write `rows` as segment `seg`'s rows everywhere the query path reads
    them, and drop the caches built over the old rows. `index.X` is copied
    the first time: until then it may share memory with the caller's
    corpus (`index._X_owned` names the copy this module made)."""
    dev = index.X.device
    if getattr(index, "_X_owned", None) is not index.X:
        index.X = index._X_owned = index.X.clone()
    index.X[torch.from_numpy(gids).to(dev)] = rows
    segs = index.segments
    segs.write_rows(seg, rows)
    # the next compaction restacks from the per-graph data
    segs.graphs1[seg].data = rows
    segs.graphs2[seg].data = rows
    index._band = None
    index._scan_cache = None
    index._phase_cache.clear()


def recover(directory, params: UHNSWParams | None = None, *, device=None) -> ShardedUHNSW:
    """Newest durable snapshot + durable WAL prefix -> live index.

    Replays every WAL segment in sequence order through `index.add`, so
    mid-log compactions are re-derived. Records already frozen in the
    snapshot are skipped; an id gap raises RecoveryError. device: as in
    `load_snapshot`.
    """
    directory = Path(directory)
    snap = latest_durable_snapshot(directory)
    if snap is None:
        raise FileNotFoundError(f"no durable snapshot under {directory}")
    idx = load_snapshot(snap, params=params, device=device)
    for _, path in list_wals(directory):
        batches, clean = replay(path)
        if not clean:
            warnings.warn(f"{path}: torn/corrupt tail — replay stopped at the last durable "
                          "record", stacklevel=2)
        for ids, vecs in batches:
            for gid, vec in zip(ids, vecs):
                gid = int(gid)
                if gid < idx.n:
                    continue       # already durable in the snapshot
                if gid > idx.n:
                    raise RecoveryError(
                        f"WAL id gap: next insert id is {idx.n} but {path.name} logs id "
                        f"{gid} — a WAL segment is missing; refusing to recover silently")
                idx.add(vec)
    return idx


class DurableIndex:
    """Fault-tolerant lifecycle wrapper around a ShardedUHNSW.

    Every insert is WAL-appended (fsync'd) before it touches the index;
    compaction triggers snapshot rotation (new snapshot + fresh WAL
    segment) through the index's `on_compact` hook. Reads and the staged
    search API delegate to the wrapped index, so a DurableIndex drops into
    `UniversalVectorService(index=...)`.

    Args:
      index: the live ShardedUHNSW to wrap (its `on_compact` hook is
        claimed; `close()` releases it).
      directory: snapshot + WAL root; created on first save.
      sync: fsync every WAL append (True) or leave flushing to the OS.
      keep_snapshots: how many newest snapshots `prune()` retains (floored
        at 1); WALs are kept from one sequence before the oldest retained
        snapshot onward.

    Under a process group of more than one rank (an index placed by
    `shard_over`), only rank 0 appends to the WAL and writes snapshots;
    every rank applies the same inserts.
    """

    def __init__(self, index: ShardedUHNSW, directory, sync: bool = True,
                 keep_snapshots: int = 2):
        self.index = index
        self.directory = Path(directory)
        self.sync = sync
        self.keep_snapshots = max(1, int(keep_snapshots))
        snaps = list_snapshots(self.directory)
        self._seq = snaps[-1][0] if snaps else None
        self._wal: WriteAheadLog | None = None
        self._lead = process_index() == 0     # the rank that writes
        index.on_compact = self._on_compact

    @classmethod
    def create(cls, index: ShardedUHNSW, directory, sync: bool = True,
               keep_snapshots: int = 2) -> "DurableIndex":
        """Snapshot `index` now and open a WAL for subsequent inserts."""
        dur = cls(index, directory, sync=sync, keep_snapshots=keep_snapshots)
        dur.save()
        return dur

    @classmethod
    def recover(cls, directory, params: UHNSWParams | None = None, sync: bool = True,
                keep_snapshots: int = 2, *, device=None) -> "DurableIndex":
        """Recover from `directory` and re-arm durability: the recovered
        state is re-snapshotted at once (a WAL with a torn tail is never
        appended to) and a new WAL opened."""
        idx = recover(directory, params=params, device=device)
        return cls.create(idx, directory, sync=sync, keep_snapshots=keep_snapshots)

    def save(self) -> Path:
        """Rotate now: snapshot the current state, open a fresh WAL."""
        seq = 0 if self._seq is None else self._seq + 1
        self._seq = seq
        if not self._lead:
            return snapshot_path(self.directory, seq)
        path = save_snapshot(self.index, self.directory, seq=seq)
        if self._wal is not None:
            self._wal.close()
        self._wal = WriteAheadLog(wal_path(self.directory, seq), sync=self.sync)
        self.prune()
        return path

    def close(self):
        if self._wal is not None:
            self._wal.close()
            self._wal = None
        if self.index.on_compact == self._on_compact:
            self.index.on_compact = None

    def prune(self):
        """Drop snapshots and WALs no longer needed for fallback recovery:
        keep the newest `keep_snapshots` snapshots and every WAL from one
        sequence before the oldest kept snapshot onward."""
        snaps = list_snapshots(self.directory)
        if len(snaps) > self.keep_snapshots:
            for _, path in snaps[: -self.keep_snapshots]:
                shutil.rmtree(path, ignore_errors=True)
            snaps = snaps[-self.keep_snapshots:]
        if snaps:
            floor = snaps[0][0] - 1
            for seq, path in list_wals(self.directory):
                if seq < floor:
                    path.unlink(missing_ok=True)

    def _on_compact(self):
        self.save()

    def _wal_required(self) -> WriteAheadLog | None:
        if not self._lead:
            return None
        if self._wal is None:
            raise RuntimeError("DurableIndex has no open WAL — construct it with "
                               "DurableIndex.create/recover (or call save()) first")
        return self._wal

    def add(self, vec) -> int:
        """WAL-append, then insert. Durable before it is searchable."""
        wal = self._wal_required()
        gid = self.index.n
        v = vec.detach().cpu().numpy() if torch.is_tensor(vec) else vec
        if wal is not None:
            wal.append([gid], np.asarray(v, np.float32).reshape(1, -1))
        out = self.index.add(v)
        if out != gid:
            raise RuntimeError(f"insert took id {out}, the WAL logged {gid}")
        return out

    def add_batch(self, vecs) -> list[int]:
        """One fsync for the whole batch (the WAL's amortization unit)."""
        if torch.is_tensor(vecs):
            vecs = vecs.detach().cpu().numpy()
        vecs = np.ascontiguousarray(vecs, dtype=np.float32)
        wal = self._wal_required()
        gid0 = self.index.n
        if wal is not None:
            wal.append(np.arange(gid0, gid0 + len(vecs)), vecs)
        return [self.index.add(v) for v in vecs]

    def __getattr__(self, name):
        return getattr(self.index, name)
