"""Runtime flags threaded through every model call (single card).

  sharding — Runtime (mesh + parallelism flags) and `constrain`, the
             identity on one card; the mesh itself waits for ROADMAP
             item 11(c)
"""

from repro_torch.dist.sharding import Runtime, constrain  # noqa: F401
