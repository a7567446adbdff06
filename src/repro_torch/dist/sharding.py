"""Runtime: the parallelism flags every model call takes, on one card.

Counterpart of `repro.dist.sharding`'s single-device part. The reference
maps each logical axis of a parameter, activation or cache onto a JAX mesh;
the port runs on one card, where every such mapping is the identity. A
`Runtime` with `mesh=None` is that card. The mesh and its modes (a device
mesh, explicit tensor parallelism, a sequence-sharded activation, ZeRO-3
over all axes: `logical_to_spec`, `dist/tp.py`) wait for ROADMAP queue 1
item 11(c), and asking for one raises `NotImplementedError` naming it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

MESH_ITEM = "ROADMAP queue 1 item 11(c) (the mesh)"


@dataclass(frozen=True)
class Runtime:
    """Mesh + parallelism mode flags, threaded through every model call.

    The reference's fields and defaults. mesh=None is one card, the only
    layout ported; rules, remat and moe_decode_gather are taken and change
    nothing on it (remat matters only to a backward pass, and the MoE
    decode path is not ported yet).
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
