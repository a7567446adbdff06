"""Two-stage search/verify pipeline over the staged index API.

Counterpart of `repro.retrieval.engine.pipeline`. The index (UHNSW /
ShardedUHNSW) exposes the query path as two stages (DESIGN.md §6):

    search_stage_candidates(Q, base_p)      -> CandidateSet   (stage A)
    search_stage_finish(Q, cands, p, k)     -> ids/dists/stats (stage B)

The engine keeps the reference's dispatch order,

    A1, B1, A2, <collect B1>, B2, A3, <collect B2>, B3, ...

Under JAX both stages were asynchronous dispatches, so wave N+1's beam
search overlapped wave N's verification. Here both stages run in order on
the current CUDA stream, and the stages may block the host on their own
(the beam loop and verification read counts back to size their work), so
no two waves overlap yet; `collect` is still the only point where the
pipeline itself waits for a wave. `search` composes exactly these two
stage methods, so pipelined results are bitwise-identical to the fused
call, and per-row results do not depend on batch composition, so they
are bitwise-identical to `serve_grouped` however the scheduler chunked
the stream.

A `Wave` is one device-call unit: a ladder-sized, padded, homogeneous
(base, k, exact) slice of a scheduler flush. Its query tensor (copied to
the index's device once, at stage A) and candidate set stay on the device
between the stages.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.retrieval.engine.request import (
    DONE,
    SEARCHING,
    VERIFYING,
    EngineRequest,
)
from repro_torch.retrieval.engine.scheduler import Flush, chunk_plan


@dataclass
class Wave:
    """One ladder-sized device batch flowing through the two stages."""

    base: float
    k: int
    exact: bool
    reason: str                      # the flush reason that released it
    requests: list[EngineRequest]    # n_real entries
    size: int                        # padded device batch size (ladder)
    q: np.ndarray                    # (size, d) f32, rows >= n_real padded
    p_vec: np.ndarray | None         # (size,) f32 for the verify lane
    q_dev: torch.Tensor | None = None  # q on the index's device, from stage A on
    cands: object = None             # CandidateSet (device) after stage A
    result: tuple | None = None      # (ids, dists, stats) after stage B
    attempt: int = 0                 # failed executions so far (retry budget)
    health_gen: int | None = None    # health generation at stage-A dispatch

    @property
    def n_real(self) -> int:
        return len(self.requests)

    @property
    def padded_rows(self) -> int:
        return self.size - self.n_real


def make_waves(flush: Flush, ladder: list[int]) -> list[Wave]:
    """Cut one flush into exact-fit ladder waves (greedy largest-first).

    Padding rows replicate row 0 of their wave (same base graph, any p is
    valid there) and are sliced off before results or stats are read —
    identical to the v1 scheduler's padding contract.
    """
    reqs = flush.requests
    waves = []
    start = 0
    for size in chunk_plan(len(reqs), ladder):
        chunk = reqs[start:start + min(size, len(reqs) - start)]
        start += len(chunk)
        q = np.stack([np.asarray(r.vector, np.float32).reshape(-1)
                      for r in chunk])
        if size > len(chunk):
            q = np.concatenate(
                [q, np.repeat(q[:1], size - len(chunk), axis=0)])
        p_vec = None
        if not flush.exact:
            p_vec = np.array([float(r.p) for r in chunk], np.float32)
            if size > len(chunk):
                p_vec = np.concatenate(
                    [p_vec, np.repeat(p_vec[:1], size - len(chunk))])
        waves.append(Wave(base=flush.base, k=flush.k, exact=flush.exact,
                          reason=flush.reason, requests=chunk, size=size,
                          q=q, p_vec=p_vec))
    return waves


@dataclass
class TwoStagePipeline:
    """Dispatch/collect the two index stages for a stream of waves.

    The pipeline itself is stateless about ordering — the engine owns the
    one-wave lookahead (`ServingEngine._inflight`) and the failure
    recovery; this class just knows how to run one wave's stages and
    materialize its results.
    """

    index: object  # UHNSW | ShardedUHNSW (any object with the stage API)

    def dispatch_search(self, wave: Wave) -> None:
        """Stage A: base-graph candidate generation."""
        if wave.q_dev is None:
            wave.q_dev = torch.from_numpy(wave.q).to(self.index.X.device)
        wave.cands = self.index.search_stage_candidates(wave.q_dev, wave.base,
                                                        k=wave.k)
        for r in wave.requests:
            r.stage = SEARCHING

    def dispatch_finish(self, wave: Wave) -> None:
        """Stage B: verification (or the exact-base skip).

        The exact lane passes the scalar base metric (the skip path: no
        verification program at all); the verify lane passes the per-row
        p vector — the same traced-p program `serve_grouped` runs, which
        is what makes engine results bitwise-equal to the baselines.
        """
        p_arg = wave.base if wave.exact else wave.p_vec
        wave.result = self.index.search_stage_finish(
            wave.q_dev, wave.cands, p_arg, wave.k)
        wave.cands = None  # device buffers free as soon as B consumes them
        for r in wave.requests:
            r.stage = VERIFYING

    def collect(self, wave: Wave):
        """Materialize one wave on host (the pipeline's only blocking
        point). Returns (ids, dists, n_b, n_p, frac, f32, phases, cov,
        pois) sliced to real rows; `f32` is the per-row f32-rows-gathered
        fraction (DESIGN.md §10 — 1.0 off the compressed two-band path);
        phases is the per-phase (n_b_probe, n_b_spill, n_p_probe,
        n_p_spill) attribution from the sharded two-phase search (probe =
        everything, spill = 0 for monolithic indexes and the independent
        policy); `cov` is the exact alive-coverage fraction the wave was
        served at (1.0 for monolithic indexes) and `pois` the per-row
        NaN/inf poison flags from the sharded query-time guard
        (DESIGN.md §11 — all-False for monolithic indexes).
        """
        ids, dists, st = wave.result
        n = wave.n_real

        def rows(x):
            x = np.asarray(host(x), dtype=np.float64)
            return x[:n] if x.ndim else np.full(n, float(x))

        ids = host(ids)[:n]
        dists = host(dists)[:n]
        n_b = rows(st.n_b)
        n_p = rows(st.n_p)
        frac = rows(st.n_dim_frac)
        f32 = rows(st.n_f32_rows_frac)
        nb_pr, nb_sp = st.phase_n_b()
        np_pr, np_sp = st.phase_n_p()
        phases = (rows(nb_pr), rows(nb_sp), rows(np_pr), rows(np_sp))
        cov = float(getattr(st, "coverage_frac", 1.0))
        pois = rows(getattr(st, "poisoned", 0.0)).astype(bool)
        wave.result = None
        wave.q_dev = None
        for r in wave.requests:
            r.stage = DONE
        return ids, dists, n_b, n_p, frac, f32, phases, cov, pois


def host(x):
    """A tensor (on any device) as a numpy array; anything else as it is."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else x
