"""Index tiers around the U-HNSW graphs (counterpart of `repro.index`).

  segment    — random partition into S segments, per-segment G1/G2 builds,
               padded and stacked on a leading segment axis
  sharded    — ShardedUHNSW: the segments folded into one batched beam
               search, one stable-sort merge, one verification pass; the
               independent / two_phase / round_robin policies
  delta      — the mutable delta buffer behind add(): exact-Lp scans merged
               into the graph results; compaction into a new frozen segment
  health     — per-segment health state machine and the alive set behind
               degraded-coverage search
  compressed — the int8 band that the two-band verification screens against
  persist    — atomic CRC-checked snapshots + recovery (DESIGN.md §9):
               recover(dir) = last durable snapshot + WAL replay; the
               reference's format, so each package loads the other's;
               restore_segment re-materializes one quarantined segment
  wal        — fsync'd CRC-framed write-ahead log for delta-tier inserts
"""

from repro_torch.index.delta import DeltaBuffer  # noqa: F401
from repro_torch.index.health import (  # noqa: F401
    HEALTHY,
    QUARANTINED,
    RECOVERING,
    SUSPECT,
    HealthPolicy,
    SegmentHealthTracker,
)
from repro_torch.index.persist import (  # noqa: F401
    DurableIndex,
    RecoveryError,
    SnapshotError,
    latest_durable_snapshot,
    load_snapshot,
    recover,
    restore_segment,
    save_snapshot,
)
from repro_torch.index.segment import (  # noqa: F401
    SegmentedGraphs,
    build_segments,
    partition_dataset,
)
from repro_torch.index.sharded import ShardedParams, ShardedUHNSW  # noqa: F401
from repro_torch.index.wal import WalCorruption, WriteAheadLog, replay  # noqa: F401
