"""Mesh / sharding / collective helpers (counterpart of `repro.dist`).

  sharding — Runtime (mesh + parallelism flags), logical-axis -> partition
             spec mapping with divisibility fallbacks, DTensor placements,
             distribute_params, gather at use (full / local);
             process_index / process_count from torch.distributed
  comm     — explicit collectives over mesh axes and their autograd rules
  tp       — explicit tensor-parallel FFN products (the explicit_tp path)
"""

from repro_torch.dist.sharding import (  # noqa: F401
    AbstractMesh,
    Runtime,
    abstract_mesh,
    constrain,
    distribute_params,
    logical_to_spec,
    placements,
    process_count,
    process_index,
    spec_shardings,
)
