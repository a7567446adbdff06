"""Logical-axis sharding: Runtime + the logical -> mesh-axis mapping.

Counterpart of `repro.dist.sharding`. Every parameter / activation / cache
spec names its dims with *logical* axes (`repro_torch.models.params`); this
module owns the one mapping from those names to the axes of a mesh:

  tensor-parallel ('model') : vocab, heads, ff, experts, inner, cache_seq
  data-parallel / FSDP      : embed, batch  -> ('pod', 'data'), whichever of
                              the two the mesh has, in that order
  replicated                : everything else (kv, head, eff, state, layers,
                              lora, seq_act unless rt.seq_shard, ...)

with the reference's two fallbacks: a rule naming an axis the mesh lacks
replicates the dim, and so does a dim that its axes' size does not divide
(`fallbacks` collects those as (logical name, dim, axis size)).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the initialised
process group (`repro_torch.launch.mesh.make_local_mesh`), or an
`AbstractMesh`: axis names and sizes and no ranks, for the production
meshes' specs. `mesh=None` is one card with no process group.

Storage and compute: `distribute_params` places a tree of full tensors as
DTensors by `logical_to_spec` (`placements`). Compute never runs on DTensors
(the flash attention's chunk loops, the stable sorts and the MoE's
`index_add_` have no sharding rules): a model call takes each weight at
its use (`at_use`): gathered over the dp axes it is sharded on, and over
'model' either kept as this rank's shard (a body split over 'model':
heads, channels, f columns, vocabulary columns) or gathered whole (a
body every 'model' rank computes alike). Both are autograd ops whose
backward returns the gradient of this rank's shard (`comm.gather_at_use`),
so a gradient taken through them never exists whole. `full` is the
whole tensor, with no gradient; the collectives are explicit
(`repro_torch.dist.comm`).
"""

from __future__ import annotations

import math
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Any

# logical axes that shard over the tensor-parallel ('model') axis
_TP_AXES = frozenset({"vocab", "heads", "ff", "experts", "inner", "cache_seq"})
# logical axes that shard over the data-parallel / FSDP axes
_DP_AXES = frozenset({"embed", "batch"})


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, without ranks: the production meshes
    (`launch.mesh.make_production_mesh`, 256 or 512 ranks) exist only as
    this, for the sharding rules and the dry-run."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def abstract_mesh(axis_sizes: tuple[int, ...], axis_names: tuple[str, ...]) -> AbstractMesh:
    """The reference's `abstract_mesh(sizes, names)`."""
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"{axis_sizes} and {axis_names} differ in length")
    return AbstractMesh(tuple(axis_names), tuple(int(s) for s in axis_sizes))


def mesh_names(mesh) -> tuple[str, ...]:
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or an AbstractMesh."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclass(frozen=True)
class Runtime:
    """Mesh + parallelism mode flags, threaded through every model call.

    The reference's fields. mesh=None is one card and no process group.
    rules: per-logical-axis overrides (axis name, axis tuple, or None to
    replicate) consulted before the built-in mapping. remat recomputes each
    layer's activations in the backward (`models.model._backbone`).
    """

    mesh: Any = None
    rules: dict = field(default_factory=dict)
    remat: bool = False
    explicit_tp: bool = False      # tp.py's FFN products on local shards
    seq_shard: bool = False        # shard activation seq dim over 'model'
    moe_decode_gather: bool = False  # weights-stationary decode MoE
    full_dp: bool = False          # ZeRO-3 over *all* mesh axes, no TP

    @property
    def axis_names(self) -> tuple[str, ...]:
        return () if self.mesh is None else mesh_names(self.mesh)

    @property
    def dp_axes(self) -> tuple[str, ...]:
        if self.full_dp:
            return self.axis_names
        return tuple(a for a in ("pod", "data") if a in self.axis_names)

    @property
    def tp_axis(self) -> str:
        return "model"

    @property
    def dp_size(self) -> int:
        if self.mesh is None:
            return 1
        shape = mesh_shape(self.mesh)
        return int(math.prod(shape[a] for a in self.dp_axes))

    @property
    def tp_size(self) -> int:
        if self.full_dp or "model" not in self.axis_names:
            return 1
        return int(mesh_shape(self.mesh)["model"])

    @property
    def distributed(self) -> bool:
        """A mesh with ranks: the model's mesh paths and collectives run."""
        return self.mesh is not None and not isinstance(self.mesh, AbstractMesh)

    def coord(self, axis: str) -> int:
        """This rank's index along a mesh axis (0 off the mesh)."""
        if not self.distributed or axis not in self.axis_names:
            return 0
        return int(self.mesh.get_local_rank(axis))

    def linear_rank(self, axes: tuple[str, ...]) -> int:
        """This rank's index in the group over `axes`, the first axis major
        (the reference's linearized dp rank)."""
        shape = mesh_shape(self.mesh) if self.mesh is not None else {}
        r = 0
        for a in axes:
            r = r * shape[a] + self.coord(a)
        return r

    @property
    def dp_rank(self) -> int:
        return self.linear_rank(self.dp_axes)

    @property
    def tp_rank(self) -> int:
        return 0 if self.tp_size == 1 else self.coord("model")


def _resolve(name: str | None, rt: Runtime):
    """Logical axis name -> mesh axis name / axis tuple / None (replicate)."""
    if name is None:
        return None
    if name in rt.rules:
        return rt.rules[name]
    if name in _DP_AXES:
        dp = rt.dp_axes
        if not dp:
            return None
        return dp if len(dp) > 1 else dp[0]
    if name == "seq_act":
        return rt.tp_axis if rt.seq_shard and not rt.full_dp else None
    if name in _TP_AXES:
        return None if rt.full_dp else rt.tp_axis
    return None


class P(tuple):
    """A partition spec: one entry per dim, None (replicated), a mesh axis
    name, or a tuple of names (the dim split over all of them, the first
    major). The reference's `jax.sharding.PartitionSpec`."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def logical_to_spec(logical: tuple[str | None, ...], shape: tuple[int, ...], rt: Runtime,
                    fallbacks: list | None = None) -> P:
    """Map logical dim names to a partition spec, with the fallbacks.

    A dim replicates (None entry) when its rule names a mesh axis that does
    not exist, or when the dim size is not divisible by the axis size; the
    latter is recorded in `fallbacks` as (logical_name, dim, axis_size)."""
    if len(logical) != len(shape):
        raise ValueError(f"logical axes {logical} and shape {shape} differ in rank")
    if rt.mesh is None:
        return P(*([None] * len(shape)))
    names = set(rt.axis_names)
    sizes = mesh_shape(rt.mesh)
    entries = []
    for name, dim in zip(logical, shape):
        ax = _resolve(name, rt)
        if ax is None:
            entries.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        if any(a not in names for a in axes):
            entries.append(None)
            continue
        size = int(math.prod(sizes[a] for a in axes))
        if size > 1 and dim % size != 0:
            if fallbacks is not None:
                fallbacks.append((name, dim, size))
            entries.append(None)
            continue
        entries.append(ax)
    return P(*entries)


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes one spec entry names, in order."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec: P, mesh) -> tuple:
    """A spec -> DTensor placements, one per mesh dim: Shard(dim) where the
    spec puts a tensor dim on that mesh axis, else Replicate(). A dim over
    ('pod', 'data') shards on both: DTensor splits it over the mesh dims in
    their order, as the reference's spec does."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in mesh_names(mesh):
        dims = [d for d, e in enumerate(spec) if axis in spec_axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def set_mesh(mesh):
    """The reference's mesh context; the port's calls carry their mesh in
    the Runtime, so it does nothing."""
    del mesh
    return nullcontext()


def constrain(x, rt: Runtime, logical: tuple[str | None, ...]):
    """The reference's activation pin. Its one effect on values here is
    seq_shard's: at a block boundary each 'model' rank keeps its slice of
    the sequence and the next block all-gathers it at entry
    (`comm.seq_reshard`). Elsewhere (and off a mesh) the identity."""
    if not rt.distributed or "seq_act" not in logical:
        return x
    spec = logical_to_spec(logical, tuple(x.shape), rt)
    dim = logical.index("seq_act")
    axes = spec_axes(spec[dim])
    if not axes:
        return x
    from repro_torch.dist.comm import seq_reshard

    return seq_reshard(x, rt, axes, dim)


def spec_shardings(specs, rt: Runtime):
    """ParamSpec tree -> placements tree (same structure as the params)."""
    from repro_torch.models.params import _map_specs

    return _map_specs(lambda s: placements(logical_to_spec(s.logical, s.shape, rt), rt.mesh),
                      specs)


def window(shape: tuple[int, ...], spec: P, rt: Runtime, coords: dict | None = None):
    """The slice of a tensor of `shape` that the rank at `coords` ({axis:
    index}, this rank's by default) holds under `spec`."""
    sizes = mesh_shape(rt.mesh)
    out = []
    for dim, entry in zip(shape, spec):
        axes = spec_axes(entry)
        parts, idx = 1, 0
        for a in axes:
            c = rt.coord(a) if coords is None else coords[a]
            idx = idx * sizes[a] + c
            parts *= sizes[a]
        step = dim // parts
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def place(full_tensor, logical, rt: Runtime):
    """One full tensor -> a DTensor holding this rank's window under
    `logical_to_spec` (each rank slices its own: no collective)."""
    from torch.distributed.tensor import DTensor

    spec = logical_to_spec(logical, tuple(full_tensor.shape), rt)
    local = full_tensor[window(tuple(full_tensor.shape), spec, rt)].contiguous()
    return DTensor.from_local(local, rt.mesh, placements(spec, rt.mesh), run_check=False,
                              shape=full_tensor.shape, stride=full_tensor.stride())


def distribute_params(tree, specs, rt: Runtime):
    """A tree of full tensors (or of the reference's numpy arrays) -> the
    same tree of DTensors placed by `logical_to_spec` on rt.mesh. Every
    rank passes the same full values. Off a mesh the tensors come back as
    they are (numpy arrays as tensors)."""
    import torch

    from repro_torch.convert import _leaf_to_torch
    from repro_torch.models.params import _map_specs
    from repro_torch.tree import leaves, unflatten

    specs = _map_specs(lambda s: s, specs)     # drops the segments' kinds / repeats

    def one(x, s):
        if not isinstance(x, torch.Tensor):
            x = _leaf_to_torch(x, "cpu", None)
        return place(x.to(rt.mesh.device_type), s.logical, rt) if rt.distributed else x

    flat_s, flat_x = leaves(specs), leaves(tree)
    if len(flat_s) != len(flat_x):
        raise ValueError(f"{len(flat_x)} leaves against {len(flat_s)} specs")
    return unflatten(tree, [one(x, s) for x, s in zip(flat_x, flat_s)])


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def local(x):
    """This rank's shard of a DTensor; a plain tensor as it is."""
    return x.to_local() if is_dtensor(x) else x


def full(x):
    """The full tensor of a DTensor, gathered over every mesh dim it is
    sharded on; a plain tensor as it is. No gradient crosses it: a model's
    weights are taken by `at_use`."""
    if not is_dtensor(x):
        return x
    from repro_torch.dist.comm import gather_shards

    return gather_shards(x.to_local(), x.placements, x.device_mesh)


def tp_split(rt: Runtime | None, n: int) -> bool:
    """Whether a body of n heads (channels, columns) splits over 'model':
    a mesh with ranks, more than one 'model' rank, and n divisible by
    them (the reference's fallback replicates otherwise)."""
    return (rt is not None and rt.distributed and rt.tp_size > 1
            and n % rt.tp_size == 0)


def _model_axis(rt: Runtime | None) -> str | None:
    """The mesh axis of split bodies: 'model' when it has more than one
    rank (under full_dp it is a dp axis like the others)."""
    if rt is None or not rt.distributed or rt.tp_size == 1:
        return None
    return rt.tp_axis


def at_use(x, rt: Runtime | None, keep: int | None = None, split: bool = False):
    """Weight x at its use, with gradients that come back as this rank's
    shard.

    A DTensor is gathered over each dp mesh dim it is sharded on (the
    backward reduce-scatters: the dp ranks computed on different rows).
    Over 'model' (more than one rank): `keep` names the dim of which this
    rank uses its window (a DTensor sharded so gives its shard as it is;
    any other tensor is narrowed, after a gather over 'model' if it is
    sharded on another dim); `split` says that the body consuming x is
    split over 'model', so that each rank's cotangent is a partial sum:
    a gather over 'model' reduce-scatters it back, and a tensor held
    whole on every 'model' rank enters through `comm.copy_to` (summed in
    the backward). Without `split` the 'model' ranks computed alike, and
    the gather's backward keeps this rank's slice. Off a mesh, or with
    one 'model' rank, a plain tensor comes back as it is."""
    from repro_torch.dist import comm

    tp = _model_axis(rt)
    kept = False
    if is_dtensor(x):
        from torch.distributed.tensor import Shard

        mesh = x.device_mesh
        names = mesh.mesh_dim_names
        y = x.to_local()
        for i in reversed(range(len(names))):
            p = x.placements[i]
            if not isinstance(p, Shard):
                continue
            if names[i] == tp:
                if keep == p.dim:
                    kept = True
                    continue
                y = comm.gather_at_use(y, mesh.get_group(names[i]), p.dim, summed=split)
                continue
            y = comm.gather_at_use(y, mesh.get_group(names[i]), p.dim, summed=True)
        if kept or tp is None:
            return y
        if not split or any(isinstance(p, Shard) and n == tp
                            for n, p in zip(names, x.placements)):
            return y if keep is None else _narrow_model(y, rt, keep)
        x = y
    if tp is None:
        return x
    if split:
        x = comm.copy_to(x, rt, (tp,))
    return x if keep is None else _narrow_model(x, rt, keep)


def _narrow_model(x, rt: Runtime, dim: int):
    n = x.shape[dim] // rt.tp_size
    return x.narrow(dim, rt.tp_rank * n, n)


def process_index() -> int:
    """This process's rank in the initialised `torch.distributed` group, else 0."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The initialised `torch.distributed` group's size, else 1."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
