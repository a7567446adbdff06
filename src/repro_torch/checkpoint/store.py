"""Fault-tolerant checkpointing in the reference's on-disk format.

Counterpart of `repro.checkpoint.store`. Layout (one directory per step):
  <dir>/step_000123/
    manifest.json         — {"step", "format": 1, "arrays": {path: {shape,
                            dtype}}, "shards": {"path::i": {"index"}}}
    host_<p>_shards.npz   — this process's shards, keyed "path::i"

Paths are the tree's keys joined by "/" (a leading "/", dict keys sorted,
list items by position), bf16 leaves are stored as their uint16 bit
pattern with "bfloat16" in the manifest, and a step is committed by
writing step_XXXXXXXX.tmp, fsyncing its manifest and renaming it. So a
checkpoint written by either package restores in the other, bit for bit.

A tensor is one shard covering it whole. A DTensor (a leaf placed on a
mesh) is written as its distinct windows, each once, by the lowest rank
that holds it (no copy per replica): rank r writes host_<r>_shards.npz,
and rank 0, once every rank's file is down, writes the one manifest
listing every rank's keys "path::j" (j numbers the leaf's distinct
windows) with their index windows, then fsyncs and renames. Other leaves
(the step, numpy arrays) are rank 0's. `restore_checkpoint` reads
whatever windows exist and places each leaf by its target: a device, or a
Runtime's mesh (the elastic restore: onto any mesh, or none).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from repro_torch.dist.sharding import process_count, process_index

COMMIT_TIMEOUT = 600.0   # seconds rank 0 waits for the other ranks' shard files


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _unflatten_into(skeleton, values: dict):
    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}/{k}") for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, f"{prefix}/{i}") for i, v in enumerate(node)]
        if isinstance(node, tuple):
            return tuple(walk(v, f"{prefix}/{i}") for i, v in enumerate(node))
        return values[prefix]

    return walk(skeleton, "")


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(host array, logical dtype name) of a leaf: a tensor on any device,
    a numpy array or a Python scalar. bf16 comes back as its uint16 bits
    (npz would degrade numpy's bfloat16 to void)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), "bfloat16"
    return a, a.dtype.name


def _spec_of(placements, mesh, ndim: int) -> tuple:
    """DTensor placements -> a partition spec (the mesh axes on each dim)."""
    from torch.distributed.tensor import Shard

    spec: list = [()] * ndim
    for a, q in zip(mesh.mesh_dim_names, placements):
        if isinstance(q, Shard):
            spec[q.dim] = (*spec[q.dim], a)
    return tuple(None if not e else e[0] if len(e) == 1 else e for e in spec)


def _windows(leaf) -> list[tuple[int, list]]:
    """A DTensor's distinct windows [(lowest holding rank, [[lo, hi], ...])],
    in the order of that rank."""
    from repro_torch.dist.sharding import Runtime, window

    mesh = leaf.device_mesh
    rt = Runtime(mesh=mesh)
    spec = _spec_of(leaf.placements, mesh, leaf.dim())
    names = mesh.mesh_dim_names
    shape = tuple(leaf.shape)
    seen: dict = {}
    for coord in np.ndindex(*mesh.mesh.shape):
        rank = int(mesh.mesh[coord])
        win = window(shape, spec, rt, dict(zip(names, coord)))
        key = tuple((sl.start, sl.stop) for sl in win)
        if key not in seen or rank < seen[key]:
            seen[key] = rank
    return sorted(((r, [list(k) for k in key]) for key, r in seen.items()),
                  key=lambda x: (x[0], x[1]))


def _snapshot(tree) -> list[dict]:
    """Each leaf's manifest entry, keys and windows, and the windows this
    rank writes, copied to the host."""
    from repro_torch.dist.sharding import is_dtensor

    rank = process_index()
    out = []
    for path, leaf in _flatten(tree):
        local = leaf.to_local() if is_dtensor(leaf) else leaf
        data, dtype = _to_host(local)
        if not (isinstance(local, torch.Tensor) and local.device.type != "cpu"):
            data = data.copy()      # a host view of the caller's memory
        if is_dtensor(leaf):
            wins = _windows(leaf)
            shards = {f"{path}::{j}": {"index": w} for j, (_, w) in enumerate(wins)}
            mine = {f"{path}::{j}": data for j, (r, _) in enumerate(wins) if r == rank}
            shape = list(leaf.shape)
        else:
            shape = list(data.shape)
            shards = {f"{path}::0": {"index": [[0, d] for d in shape]}}
            mine = {f"{path}::0": data} if rank == 0 else {}
        out.append({"path": path, "shape": shape, "dtype": dtype, "shards": shards,
                    "mine": mine})
    return out


def _barrier() -> None:
    import torch.distributed as dist

    if process_count() > 1:
        dist.barrier()


def _prepare(directory, step: int) -> tuple[Path, Path]:
    """(tmp, final) of a step; rank 0 clears a stale tmp, then all meet."""
    directory = Path(directory)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if process_index() == 0:
        directory.mkdir(parents=True, exist_ok=True)
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
    _barrier()
    return tmp, final


def _write(tmp: Path, final: Path, step: int, snap: list[dict], rank: int, world: int) -> None:
    """This rank's shard file and its done marker; rank 0 then waits for
    every marker and commits the manifest (fsync, rename)."""
    np.savez(tmp / f"host_{rank}_shards.npz",
             **{k: v for leaf in snap for k, v in leaf["mine"].items()})
    (tmp / f"host_{rank}.done").touch()
    if rank:
        return
    deadline = time.monotonic() + COMMIT_TIMEOUT
    while not all((tmp / f"host_{r}.done").exists() for r in range(world)):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{tmp}: not every rank wrote its shards in {COMMIT_TIMEOUT} s")
        time.sleep(0.01)
    manifest = {"step": step, "format": 1,
                "arrays": {leaf["path"]: {"shape": leaf["shape"], "dtype": leaf["dtype"]}
                           for leaf in snap},
                "shards": {k: v for leaf in snap for k, v in leaf["shards"].items()}}
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    with open(tmp / "manifest.json", "rb") as f:
        os.fsync(f.fileno())
    for r in range(world):
        (tmp / f"host_{r}.done").unlink()
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic commit


def save_checkpoint(directory, step: int, tree) -> Path:
    """Write `tree` (tensors, DTensors, numpy arrays or scalars) as
    step_<step>; under a process group every rank calls it. Returns the
    step's path once it is committed."""
    snap = _snapshot(tree)
    tmp, final = _prepare(directory, step)
    _write(tmp, final, step, snap, process_index(), process_count())
    _barrier()
    return final


def _list_steps(directory) -> list[int]:
    directory = Path(directory)
    if not directory.exists():
        return []
    return sorted(
        int(p.name.split("_")[1])
        for p in directory.iterdir()
        if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(".tmp")
    )


def latest_step(directory) -> int | None:
    steps = _list_steps(directory)
    return steps[-1] if steps else None


def _read_manifest(src: Path) -> dict:
    """Load and structurally validate one step's manifest. Raises ValueError
    on anything a crash could have left behind (missing file, truncated
    JSON, wrong structure)."""
    try:
        manifest = json.loads((src / "manifest.json").read_text())
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
        raise ValueError(f"{src}: unreadable manifest ({e})") from e
    if not isinstance(manifest, dict) or "arrays" not in manifest or "shards" not in manifest:
        raise ValueError(f"{src}: manifest is not a checkpoint manifest")
    return manifest


def _from_host(full: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(full.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(full).to(device)


def _place(full: torch.Tensor, skel, rt):
    """A restored leaf onto rt's mesh: a ParamSpec skeleton leaf places it
    by its logical axes, a DTensor one as that leaf is placed, any other
    (and a 0-d leaf, the step) replicates it (a plain tensor on the mesh's
    device)."""
    from repro_torch.dist.sharding import is_dtensor, place, placements, window
    from repro_torch.models.params import ParamSpec

    full = full.to(rt.mesh.device_type)
    if isinstance(skel, ParamSpec) and skel.shape:
        return place(full, skel.logical, rt)
    if is_dtensor(skel):
        from torch.distributed.tensor import DTensor

        spec = _spec_of(skel.placements, skel.device_mesh, full.dim())
        loc = full[window(tuple(full.shape), spec, rt)].contiguous()
        return DTensor.from_local(loc, rt.mesh, placements(spec, rt.mesh), run_check=False,
                                  shape=full.shape, stride=full.stride())
    return full


def restore_checkpoint(directory, skeleton, target="cuda", step: int | None = None):
    """Restore a checkpoint into a tree of skeleton's structure of tensors,
    each in its manifest's dtype, on `target`: a device, or a Runtime whose
    mesh places each leaf (`_place`: skeleton leaves that are ParamSpecs or
    DTensors say how; `train.step.train_state_specs` is a training state's
    skeleton). Returns (tree, step).

    With step=None, the newest durable step wins: a directory whose
    manifest is missing or invalid (a crash landed between partial writes
    and the rename being observed, or corruption after it) is skipped with
    a warning and restore falls back to the previous step. An explicitly
    requested step is never second-guessed: corruption there raises."""
    directory = Path(directory)
    if step is None:
        candidates = _list_steps(directory)
        if not candidates:
            raise FileNotFoundError(f"no checkpoints under {directory}")
        manifest = None
        for cand in reversed(candidates):
            try:
                manifest = _read_manifest(directory / f"step_{cand:08d}")
                step = cand
                break
            except ValueError as e:
                warnings.warn(f"skipping non-durable checkpoint: {e}", stacklevel=2)
        if manifest is None:
            raise FileNotFoundError(
                f"no durable checkpoint under {directory}: every step_* "
                f"directory has a missing/invalid manifest")
        src = directory / f"step_{step:08d}"
    else:
        src = directory / f"step_{step:08d}"
        manifest = json.loads((src / "manifest.json").read_text())
    on_mesh = getattr(target, "distributed", False)
    payloads = [np.load(f) for f in src.glob("host_*_shards.npz")]
    by_path: dict[str, list[tuple[str, object]]] = {}
    for npz in payloads:
        for key in npz.files:
            p, _, _ = key.rpartition("::")
            by_path.setdefault(p, []).append((key, npz))
    values = {}
    for path, meta in manifest["arrays"].items():
        shape = tuple(meta["shape"])
        bits = np.uint16 if meta["dtype"] == "bfloat16" else np.dtype(meta["dtype"])
        shards = by_path.get(path, [])
        whole = [[0, d] for d in shape]
        if len(shards) == 1 and manifest["shards"][shards[0][0]]["index"] == whole:
            full = shards[0][1][shards[0][0]].view(bits)     # one shard, the whole array
        else:
            full = np.zeros(shape, dtype=bits)
            for key, npz in shards:
                window = manifest["shards"][key]["index"]
                full[tuple(slice(a, b) for a, b in window)] = npz[key].view(bits)
        values[path] = _from_host(full, meta["dtype"], "cpu" if on_mesh else target)
    for npz in payloads:
        npz.close()
    if on_mesh:
        skel = dict(_flatten(skeleton))
        values = {path: _place(v, skel[path], target) for path, v in values.items()}
    return _unflatten_into(skeleton, values), step


class AsyncCheckpointer:
    """Background-thread checkpoint writer with snapshot-to-host semantics:
    `save` copies this rank's shards to host memory (the only part that
    blocks) and writes them on a thread; `wait` joins it and raises what it
    raised. The writer makes no collective call: rank 0's commits once the
    other ranks' done markers are down."""

    def __init__(self, directory):
        self.directory = Path(directory)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, tree):
        self.wait()
        # a copy on the host of this rank's shards, that later steps cannot
        # change; every rank meets once the step's directory is ready
        snap = _snapshot(tree)
        tmp, final = _prepare(self.directory, step)
        rank, world = process_index(), process_count()

        def work():
            try:
                _write(tmp, final, step, snap, rank, world)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        # non-daemon: interpreter shutdown (including SystemExit from fault
        # injection) joins the writer, so an in-flight checkpoint commits
        # instead of being torn down mid-write and losing the step
        self._thread = threading.Thread(target=work, daemon=False)
        self._thread.start()

    def wait(self):
        """Joins the writer; under a process group every rank then meets, so
        the step is committed for all of them."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            _barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err
