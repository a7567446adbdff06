"""Write-ahead log for delta-tier inserts (DESIGN.md §9).

Counterpart of `repro.index.wal`, with the same file format byte for
byte, so each package replays the other's logs. It needs only numpy.

The mutable delta buffer is the only index state that changes between
compactions, so it is the only state that needs a log: every `add()` (or
batch of adds) is appended as one CRC-framed record *before* it is applied
to the in-memory index, and the file is fsync'd per append. Recovery
(`repro_torch.index.persist.recover`) replays the durable prefix of the
log on top of the last durable snapshot; because the records carry
explicit global ids and inserts are idempotent under the id guard, replay
lands bit-identically on the state of a never-crashed index.

File format (little-endian):

    header   : 8 bytes  b"UWAL0001"
    record   : 4 bytes  b"UREC"            record magic
               u32      payload length
               u32      crc32(payload)
               payload  u32 count, u32 d,
                        count  x i64 global ids,
                        count*d x f32 vector data

A torn tail (crash mid-append) fails the magic/length/CRC checks and
replay simply stops at the last intact record — torn data is *detected*,
never loaded. Corruption mid-file likewise stops replay; the recovery
layer then notices the global-id gap and refuses to proceed silently.
"""

from __future__ import annotations

import os
import struct
import zlib
from pathlib import Path

import numpy as np

WAL_HEADER = b"UWAL0001"
RECORD_MAGIC = b"UREC"
_REC_HDR = struct.Struct("<4sII")      # magic, payload_len, crc32
_PAYLOAD_HDR = struct.Struct("<II")    # count, d
# sanity bound on a single record: 1M vectors x 4k dims would be absurd
# for a delta batch; anything larger is treated as corruption.
MAX_PAYLOAD = 1 << 31


class WalCorruption(RuntimeError):
    """A WAL file failed a structural check (bad header)."""


def wal_path(directory, seq: int) -> Path:
    return Path(directory) / f"wal_{seq:08d}.log"


def list_wals(directory) -> list[tuple[int, Path]]:
    """All WAL segments under `directory`, ascending by sequence number."""
    directory = Path(directory)
    if not directory.exists():
        return []
    out = []
    for p in directory.iterdir():
        if p.is_file() and p.name.startswith("wal_") \
                and p.name.endswith(".log"):
            try:
                out.append((int(p.name[4:-4]), p))
            except ValueError:
                continue
    return sorted(out)


def _pack_record(ids: np.ndarray, vecs: np.ndarray) -> bytes:
    count, d = vecs.shape
    payload = (_PAYLOAD_HDR.pack(count, d)
               + np.ascontiguousarray(ids, dtype=np.int64).tobytes()
               + np.ascontiguousarray(vecs, dtype=np.float32).tobytes())
    return _REC_HDR.pack(RECORD_MAGIC, len(payload),
                         zlib.crc32(payload)) + payload


class WriteAheadLog:
    """Append-only CRC-framed insert log with fsync-per-batch durability.

    `path` is created (with the 8-byte header) on first open of an empty
    or missing file; an existing file is opened append-only, so re-opening
    a live segment never rewrites history. `sync=False` skips the fsync
    (still flushes to the OS) for tests and throwaway runs; production
    appends are durable before `append` returns, which is what makes the
    write-*ahead* ordering meaningful. Usable as a context manager
    (closes on exit); `append` after `close()` raises (file is closed).
    """

    def __init__(self, path, sync: bool = True):
        self.path = Path(path)
        self.sync = sync
        new = not self.path.exists() or self.path.stat().st_size == 0
        self._f = open(self.path, "ab")
        if new:
            self._f.write(WAL_HEADER)
            self._flush()

    def _flush(self):
        self._f.flush()
        if self.sync:
            os.fsync(self._f.fileno())

    def append(self, ids, vecs) -> int:
        """Durably log one insert batch. Returns the file size afterwards
        (the record boundary — crash-consistency tests truncate at these).

        ids: (c,) int-like global ids (stored i64). vecs: (c, d) f32 (a
        single (d,) vector is promoted to (1, d)). One CRC-framed record
        + one fsync per call — `DurableIndex.add_batch` rides this as its
        amortization unit. Raises AssertionError on a length mismatch
        between ids and vecs.
        """
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        vecs = np.ascontiguousarray(vecs, dtype=np.float32)
        if vecs.ndim == 1:
            vecs = vecs[None, :]
        assert len(ids) == len(vecs), (len(ids), len(vecs))
        self._f.write(_pack_record(ids, vecs))
        self._flush()
        return self._f.tell()

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def replay(path) -> tuple[list[tuple[np.ndarray, np.ndarray]], bool]:
    """Read the durable prefix of one WAL file.

    Returns (batches, clean): `batches` is a list of (ids (c,) i64,
    vecs (c, d) f32) in append order; `clean` is False when the file ends
    in a torn or corrupt record (replay stops at the last intact one —
    the crash-consistency contract) and True when every byte parsed.

    Raises WalCorruption only for a bad *file header* — that means the
    path is not a WAL at all, which is a caller bug, not a torn write.
    """
    path = Path(path)
    data = path.read_bytes()
    if len(data) < len(WAL_HEADER):
        return [], False
    if data[: len(WAL_HEADER)] != WAL_HEADER:
        raise WalCorruption(f"{path} does not start with a WAL header")
    batches: list[tuple[np.ndarray, np.ndarray]] = []
    off = len(WAL_HEADER)
    while off < len(data):
        if off + _REC_HDR.size > len(data):
            return batches, False          # torn record header
        magic, length, crc = _REC_HDR.unpack_from(data, off)
        if magic != RECORD_MAGIC or length > MAX_PAYLOAD \
                or length < _PAYLOAD_HDR.size:
            return batches, False          # corrupt framing
        start = off + _REC_HDR.size
        payload = data[start: start + length]
        if len(payload) < length or zlib.crc32(payload) != crc:
            return batches, False          # torn / corrupt payload
        count, d = _PAYLOAD_HDR.unpack_from(payload, 0)
        need = _PAYLOAD_HDR.size + count * 8 + count * d * 4
        if need != length:
            return batches, False          # inconsistent payload sizing
        ids = np.frombuffer(payload, dtype=np.int64, count=count,
                            offset=_PAYLOAD_HDR.size)
        vecs = np.frombuffer(
            payload, dtype=np.float32, count=count * d,
            offset=_PAYLOAD_HDR.size + count * 8,
        ).reshape(count, d)
        batches.append((ids.copy(), vecs.copy()))
        off = start + length
    return batches, True
