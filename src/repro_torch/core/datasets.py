"""Synthetic dataset generators shaped like the paper's six corpora (Table 1).

A copy of `repro.core.datasets` (pure NumPy), kept here so that the port
runs without the reference package: the same (name, n, seed) gives the
same arrays in both.

The real corpora (SIFT/GIST/Deep/GloVe/Sun/Trevi) are not shipped with the
repository, so these are synthetic stand-ins that preserve the
two properties U-HNSW's evaluation depends on:

  * clusteredness — graph indexes exploit local neighborhood structure;
  * heavy-tailed, per-dimension-heterogeneous coordinates — this is what makes
    Lp orderings *diverge* across p (if coordinates were i.i.d. Gaussian, all
    Lp metrics would rank neighbors nearly identically and the universal-p
    problem would be trivial).

Each generator is deterministic in (name, n, seed).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# (n_full, d, type) from paper Table 1
PAPER_DATASETS = {
    "sun": (78_306, 512, "image"),
    "trevi": (99_100, 4096, "image"),
    "gist": (1_000_000, 960, "image"),
    "deep": (1_000_000, 256, "image"),
    "glove": (1_191_714, 100, "text"),
    "sift": (2_000_000, 128, "image"),
}


@dataclass
class Dataset:
    name: str
    data: np.ndarray    # (n, d) float32
    queries: np.ndarray  # (nq, d) float32
    d: int
    n: int


def _clustered_heavy_tail(
    rng: np.random.Generator, n: int, d: int, n_clusters: int, df: float,
    nonneg: bool,
) -> np.ndarray:
    """Mixture of Student-t clusters with per-dimension scale heterogeneity."""
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32) * 4.0
    # heavy-tailed per-dim scales (image descriptors have very uneven energy)
    dim_scale = np.exp(rng.standard_normal(d).astype(np.float32) * 0.8)
    assign = rng.integers(0, n_clusters, size=n)
    noise = rng.standard_t(df, size=(n, d)).astype(np.float32)
    x = centers[assign] + noise * dim_scale[None, :]
    if nonneg:
        x = np.abs(x)  # SIFT-like descriptors are non-negative histograms
    return np.ascontiguousarray(x, dtype=np.float32)


def make_dataset(
    name: str,
    n: int | None = None,
    n_queries: int = 100,
    seed: int = 0,
    scale: float = 0.01,
) -> Dataset:
    """Generate a synthetic stand-in for one of the paper's datasets.

    n defaults to scale * the paper's full size (clamped to >= 2000); pass n
    explicitly for the full size (e.g. `PAPER_DATASETS["sun"][0]`).
    """
    if name not in PAPER_DATASETS:
        raise KeyError(f"unknown dataset {name!r}; options: {sorted(PAPER_DATASETS)}")
    n_full, d, kind = PAPER_DATASETS[name]
    if n is None:
        n = max(2000, int(n_full * scale))
    # zlib.crc32, not hash(): Python string hashing is salted per process,
    # which would make "deterministic" datasets differ between runs
    import zlib

    rng = np.random.default_rng(seed ^ (zlib.crc32(name.encode()) & 0xFFFF))
    n_clusters = max(8, int(np.sqrt(n) / 2))
    nonneg = name in ("sift", "sun")
    df = 3.0 if kind == "image" else 5.0
    pool = _clustered_heavy_tail(rng, n + n_queries, d, n_clusters, df, nonneg)
    # queries are drawn from the same distribution and jittered (paper samples
    # them from the held-out query sets of each corpus)
    data = pool[:n]
    queries = pool[n:] + 0.05 * rng.standard_normal((n_queries, d)).astype(np.float32)
    return Dataset(name=name, data=data, queries=queries.astype(np.float32), d=d, n=n)


def paper_p_values() -> list[float]:
    """The p grid used in the paper's §4.2 evaluation (uniform over this set)."""
    return [0.5, 0.6, 0.7, 0.8, 0.9]


def fig4_p_values() -> list[float]:
    """The p grid for the fixed-p HNSW comparison (§4.3: range [0.5, 1.9])."""
    return [0.5, 0.7, 0.9, 1.1, 1.3, 1.5, 1.7, 1.9]
