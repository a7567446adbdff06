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

On one card each array is one shard covering it whole. Restoring onto
another mesh (the reference's elastic restore) waits for ROADMAP queue 1
item 11(c); `restore_checkpoint` takes a device instead of shardings.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import warnings
from pathlib import Path

import numpy as np
import torch

from repro_torch.dist.sharding import process_index


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


def save_checkpoint(directory, step: int, tree) -> Path:
    """Write `tree` (tensors, numpy arrays or scalars) as step_<step>.
    Returns the step's path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    manifest = {"step": step, "arrays": {}, "format": 1}
    payload: dict[str, np.ndarray] = {}
    shard_meta: dict[str, dict] = {}
    for path, leaf in _flatten(tree):
        data, dtype = _to_host(leaf)
        manifest["arrays"][path] = {"shape": list(data.shape), "dtype": dtype}
        key = f"{path}::0"
        payload[key] = data
        shard_meta[key] = {"index": [[0, d] for d in data.shape]}
    manifest["shards"] = shard_meta
    np.savez(tmp / f"host_{process_index()}_shards.npz", **payload)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    with open(tmp / "manifest.json", "rb") as f:
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic commit
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


def restore_checkpoint(directory, skeleton, device="cuda", step: int | None = None):
    """Restore a checkpoint into a tree of skeleton's structure (its leaves
    are ignored) of tensors on `device`, each in its manifest's dtype.
    Returns (tree, step).

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
        values[path] = _from_host(full, meta["dtype"], device)
    for npz in payloads:
        npz.close()
    return _unflatten_into(skeleton, values), step


class AsyncCheckpointer:
    """Background-thread checkpoint writer with snapshot-to-host semantics:
    `save` copies the tree to host memory (the only part that blocks) and
    writes it on a thread; `wait` joins it and raises what it raised."""

    def __init__(self, directory):
        self.directory = Path(directory)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, tree):
        self.wait()
        # a copy on the host that later steps cannot change
        host_tree = _unflatten_into(tree, {
            path: leaf.detach().to("cpu", copy=True) if isinstance(leaf, torch.Tensor)
            else np.array(leaf) for path, leaf in _flatten(tree)})

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        # non-daemon: interpreter shutdown (including SystemExit from fault
        # injection) joins the writer, so an in-flight checkpoint commits
        # instead of being torn down mid-write and losing the step
        self._thread = threading.Thread(target=work, daemon=False)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
