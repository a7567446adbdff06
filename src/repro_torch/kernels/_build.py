"""Builds the CUDA kernels with nvcc and loads them with ctypes.

Each source in `csrc/` becomes one shared library with a plain C interface
(`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`),
built at first use into `<repo>/build/repro_torch_kernels/` (listed in
.gitignore) and keyed on a hash of the sources and flags, so an unchanged
tree reuses the libraries and a changed one rebuilds. All sources compile
at once, one nvcc process each. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of each source's launcher: (argtypes, restype is int = cudaError_t)
LAUNCHERS = {
    # the arguments packed in one int64 array, and the scalar p
    "gather_lp": ("gather_lp_launch", [_P, _F]),
    # the arguments packed in one int64 array, and the two metrics' p
    "gather_lp_multi": ("gather_lp_multi_launch", [_P, _F, _F]),
    "gather_lp_abandon": ("gather_lp_abandon_launch", [_P, _F]),
    "pairwise_lp": ("pairwise_lp_launch", [_P, _P, _P, _F, _P, _I, _I, _I, _P]),
    "rowwise_lp": ("rowwise_lp_launch", [_P, _F]),
    "lp_topk": ("lp_topk_launch", [_P, _F]),
    "gather_lp_screen": ("gather_lp_screen_launch", [_P, _F]),
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")
    return nvcc


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


_BUILD_LOCK = threading.Lock()


def build_all() -> dict[str, tuple[ctypes.CDLL, str]]:
    """Builds (where needed) and loads every kernel library.

    Returns {name: (library, nvcc's ptxas report or "cached")}. Raises
    RuntimeError with nvcc's output if a build fails. Safe to call from
    several threads: one builds, the others wait for its libraries.
    """
    with _BUILD_LOCK:
        return _build_all()


@functools.lru_cache(maxsize=None)
def _build_all() -> dict[str, tuple[ctypes.CDLL, str]]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in LAUNCHERS:
        lib = BUILD_DIR / f"lib{name}_{_digest(name)}.so"
        if lib.exists():
            jobs[name] = (lib, None, None)
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (lib, tmp, proc)
    loaded = {}
    failed = []
    for name, (lib, tmp, proc) in jobs.items():
        report = "cached"
        if proc is not None:
            report = proc.communicate()[0]
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"{name}:\n{report}")
                continue
            os.replace(tmp, lib)
        loaded[name] = (lib, report)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    out = {}
    for name, (lib, report) in loaded.items():
        cdll = ctypes.CDLL(str(lib))
        symbol, argtypes = LAUNCHERS[name]
        fn = getattr(cdll, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        out[name] = (cdll, report)
    return out


_LAUNCHERS: dict = {}


def launcher(name: str):
    """The ctypes function that launches kernel `name` (built at first use)."""
    fn = _LAUNCHERS.get(name)
    if fn is None:
        cdll, _ = build_all()[name]
        fn = _LAUNCHERS[name] = getattr(cdll, LAUNCHERS[name][0])
    return fn
