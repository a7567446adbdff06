"""Mutable delta tier for streaming inserts (DESIGN.md §3).

Counterpart of `repro.index.delta`. Frozen segments are cheap to query and
expensive to change, so new vectors land in a small buffer: `add()` is an
append, and queries scan the buffer under exact Lp through the kernels'
dispatch (`kernels.ops`). The distances are exact, so delta hits need no
verification and merge directly with the verified graph top-k, and a new
vector is findable at every p at once. At capacity the owner
(`ShardedUHNSW`) builds a frozen segment from the buffer and clears it.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.lp_ops import is_static_p, pow_from_abs
from repro_torch.core.metrics import as_p_vec
from repro_torch.kernels.ops import lp_gather_abandon, lp_gather_distance


class DeltaBuffer:
    """Append-only vector buffer with exact-Lp search.

    Global ids are assigned by the owner at add() time and stay stable
    across compaction: the compacted segment reuses them. The vectors are
    kept on the host; a device copy is made at the first search after an
    add.
    """

    def __init__(self, d: int, capacity: int = 1024):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.d = d
        self.capacity = capacity
        self._vecs: list[np.ndarray] = []
        self._ids: list[int] = []
        self._cache: torch.Tensor | None = None  # device copy, dropped on add

    def __len__(self) -> int:
        return len(self._vecs)

    @property
    def full(self) -> bool:
        return len(self._vecs) >= self.capacity

    def add(self, vec, global_id: int) -> int:
        v = np.asarray(vec, dtype=np.float32).reshape(-1)
        if v.shape != (self.d,):
            raise ValueError(f"vector has shape {v.shape}, the buffer holds ({self.d},)")
        self._vecs.append(v)
        self._ids.append(int(global_id))
        self._cache = None
        return global_id

    def vectors(self) -> np.ndarray:
        """(n_delta, d) snapshot (host)."""
        if not self._vecs:
            return np.zeros((0, self.d), dtype=np.float32)
        return np.stack(self._vecs)

    def ids(self) -> np.ndarray:
        return np.asarray(self._ids, dtype=np.int32)

    def restore(self, vecs: np.ndarray, ids: np.ndarray) -> None:
        """Bulk re-load buffered contents (snapshot recovery path): appends
        in order with the saved global ids, so a restored buffer is the one
        that reached this state through `add`."""
        vecs = np.asarray(vecs, dtype=np.float32)
        if len(vecs) != len(ids):
            raise ValueError(f"{len(vecs)} vectors but {len(ids)} ids")
        for v, gid in zip(vecs, ids):
            self.add(v, int(gid))

    def drain(self) -> tuple[np.ndarray, np.ndarray]:
        """Return (vectors, ids) and empty the buffer (compaction step)."""
        vecs, ids = self.vectors(), self.ids()
        self._vecs, self._ids, self._cache = [], [], None
        return vecs, ids

    def search(self, Q: torch.Tensor, p, interpret: bool | None = None,
               thresh: torch.Tensor | None = None, block_d: int | None = None):
        """Exact rooted Lp distances of every buffered vector to each query.

        Q (B, d) f32; p a float or (B,) array (row i under p[i]). Returns
        (ids (B, n_delta) int32 global, dists (B, n_delta) f32, nd (B,
        n_delta) int32 dimensions scanned); an empty buffer gives (B, 0).

        With `thresh` (B,), each row's rooted k-th best distance from the
        verified graph top-k, the scan goes through the early-abandoning
        kernel: a buffered vector whose partial power sum passes the bound
        scores +inf and skips its remaining dimension blocks. The bound is
        un-rooted with a 1e-4 inflation, so the root/power round trip can
        never abandon a true top-k entry. Without it every query scores the
        whole buffer through the 1-D shared-ids form of
        `lp_gather_distance` (the pairwise kernel over the buffer once).
        `interpret` is the reference's kernel override, taken at its place
        and ignored.
        """
        b = Q.shape[0]
        dev = Q.device
        n_delta = len(self._vecs)
        if not n_delta:
            z = torch.zeros((b, 0), dtype=torch.int32, device=dev)
            return z, torch.zeros((b, 0), device=dev), z
        if self._cache is None or self._cache.device != dev:
            self._cache = torch.from_numpy(self.vectors()).to(dev)
        if not is_static_p(p):
            p = torch.broadcast_to(as_p_vec(p, dev), (b,))
        ids = torch.from_numpy(self.ids()).to(dev)[None, :].expand(b, n_delta)
        if thresh is not None:
            rows = torch.arange(n_delta, dtype=torch.int32, device=dev).expand(b, n_delta)
            thr_pow = pow_from_abs(thresh.to(torch.float32), p) * (1 + 1e-4)
            dists, nd = lp_gather_abandon(Q, rows, self._cache, thr_pow,
                                          torch.zeros((b, n_delta), device=dev), p, root=True,
                                          block_d=block_d)
            return ids, dists, nd
        rows = torch.arange(n_delta, device=dev)
        dists = lp_gather_distance(Q, rows, self._cache, p, root=True)
        return ids, dists, torch.full((b, n_delta), self.d, dtype=torch.int32, device=dev)
