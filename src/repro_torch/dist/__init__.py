"""Runtime flags threaded through every model call (single card).

  sharding — Runtime (mesh + parallelism flags) and `constrain`, the
             identity on one card; the mesh itself waits for ROADMAP
             item 11(c); process_index / process_count from
             torch.distributed
"""

from repro_torch.dist.sharding import (  # noqa: F401
    Runtime,
    constrain,
    process_count,
    process_index,
)
