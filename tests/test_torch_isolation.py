"""The port and its chip smoke import neither JAX nor the reference package.

A subprocess makes `jax`, `jaxlib` and `repro` unimportable, imports every
module of `repro_torch` and `chip_smoke.py`, and reports what it loaded.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, importlib.abc, importlib.util, json, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "repro")


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, Block())
import repro_torch

names = ["repro_torch"]
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print(json.dumps({"modules": names, "blocked_loaded": loaded}))
"""


def test_port_and_chip_smoke_import_neither_jax_nor_repro():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["blocked_loaded"] == []
    for name in ("repro_torch.core.bulk_build", "repro_torch.index.compressed",
                 "repro_torch.kernels.ops", "repro_torch.core.uhnsw",
                 "repro_torch.kernels.lp_topk", "repro_torch.index.sharded",
                 "repro_torch.index.segment", "repro_torch.index.delta",
                 "repro_torch.index.health", "repro_torch.index.wal",
                 "repro_torch.index.persist", "repro_torch.retrieval.service",
                 "repro_torch.retrieval.engine", "repro_torch.retrieval.engine.request",
                 "repro_torch.retrieval.engine.scheduler",
                 "repro_torch.retrieval.engine.pipeline",
                 "repro_torch.retrieval.engine.faults", "repro_torch.launch.serve",
                 "repro_torch.configs", "repro_torch.configs.base",
                 "repro_torch.configs.tinyllama_1_1b", "repro_torch.configs.deepseek_v3_671b",
                 "repro_torch.dist", "repro_torch.dist.sharding", "repro_torch.models",
                 "repro_torch.models.params", "repro_torch.models.attention",
                 "repro_torch.models.ffn", "repro_torch.models.model", "repro_torch.serve",
                 "repro_torch.serve.engine", "repro_torch.data", "repro_torch.data.pipeline",
                 "repro_torch.retrieval.knn_lm", "repro_torch.core.mlsh", "repro_torch.convert",
                 "repro_torch.tree", "repro_torch.optim", "repro_torch.optim.adamw",
                 "repro_torch.train", "repro_torch.train.step",
                 "repro_torch.train.compression", "repro_torch.train.monitor",
                 "repro_torch.checkpoint", "repro_torch.checkpoint.store",
                 "repro_torch.launch.train", "repro_torch.launch.supervisor"):
        assert name in report["modules"]
