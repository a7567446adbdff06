"""Runtime: the parallelism flags every model call takes, on one card.

Counterpart of `repro.dist.sharding`'s single-device part. The reference
maps each logical axis of a parameter, activation or cache onto a JAX mesh;
the port runs on one card, where every such mapping is the identity. A
`Runtime` with `mesh=None` is that card. The mesh and its modes (a device
mesh, explicit tensor parallelism, a sequence-sharded activation, ZeRO-3
over all axes: `logical_to_spec`, `dist/tp.py`) wait for ROADMAP queue 1
item 11(c), and asking for one raises `NotImplementedError` naming it.
`process_index` / `process_count` (`jax.process_index` / `process_count`)
read `torch.distributed` where a process group is up.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

MESH_ITEM = "ROADMAP queue 1 item 11(c) (the mesh)"


@dataclass(frozen=True)
class Runtime:
    """Mesh + parallelism mode flags, threaded through every model call.

    The reference's fields and defaults. mesh=None is one card, the only
    layout ported. remat recomputes each layer's activations in the
    backward (`models.model._backbone`); rules and moe_decode_gather are
    taken and inert on one card: the weights-stationary MoE decode runs
    only with dp_size > 1 (`models.ffn.moe_forward`).
    """

    mesh: Any = None
    rules: dict = field(default_factory=dict)
    remat: bool = False
    explicit_tp: bool = False      # shard_map FFN matmuls instead of GSPMD
    seq_shard: bool = False        # shard activation seq dim over 'model'
    moe_decode_gather: bool = False  # weights-stationary decode MoE
    full_dp: bool = False          # ZeRO-3 over *all* mesh axes, no TP

    def __post_init__(self):
        asked = [name for name in ("explicit_tp", "seq_shard", "full_dp") if getattr(self, name)]
        if self.mesh is not None:
            asked.insert(0, "mesh")
        if asked:
            raise NotImplementedError(
                f"Runtime({', '.join(asked)}): only one card (mesh=None) is ported; "
                f"the mesh and its modes wait for {MESH_ITEM}")

    @property
    def dp_axes(self) -> tuple[str, ...]:
        return ()

    @property
    def tp_axis(self) -> str:
        return "model"

    @property
    def dp_size(self) -> int:
        return 1

    @property
    def tp_size(self) -> int:
        return 1


def constrain(x, rt: Runtime, logical: tuple[str | None, ...]):
    """The reference's activation pin; the identity on one card."""
    del rt, logical
    return x


def process_index() -> int:
    """This process's rank in the initialised `torch.distributed` group, else 0."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The initialised `torch.distributed` group's size, else 1."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
