"""The port's mesh on gloo ranks against `repro` on forced host devices.

One module-scoped subprocess runs the reference on 8 forced host devices
(`XLA_FLAGS=--xla_force_host_platform_device_count=8`) under meshes of
`AxisType.Auto` axes (tests/mesh_reference.py); beside it, one
`torch.multiprocessing` spawn per mesh shape runs the port's checks on
gloo ranks (tests/mesh_workers.py: 8 ranks for (4, 2), 4 for (2, 2) and
the other 4-rank meshes). Both read the same inputs, made from seeds
(`mesh_workers.write_inputs`), in f32 on the smoke configs.

Tolerances (each against the largest reference magnitude, f32 sums taken
in other orders): the explicit-TP FFN within 1e-6; the MoE and its decode
path within 1e-5; every gradient leaf within 1e-5 of its layer's largest
gradient magnitude; the dropped routes of each dp shard
equal; three train steps' losses and grad norms within 1e-4 relative of
the reference's (2, 2) run (tests/test_torch_train.py's rule), full_dp and
seq_shard within 1e-5 relative of the mesh-free port; the elastic restore's
next three losses within 1e-5 of continuing on (2, 2); checkpoints bit for
bit across packages; the command lines on 2 ranks against 1: the same
tokens served, losses within 2e-2 (bf16 parameters, the reference's
microbatch rule).

The reference's MoE gradient on (2, 2) equals its own on (1, 1) at a
drop-free capacity (`test_reference_moe_gradient_mesh_vs_one_device`): its
`psum` transposes as it should there, and the port's gradients are held to
the mesh-free port's.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as r_get_arch
from repro.models import attention as r_attn
from repro.models import ffn as r_ffn
from repro_torch.configs.base import get_arch
from repro_torch.dist.sharding import Runtime
from repro_torch.models import ffn
from repro_torch.models.attention import rmsnorm
from repro_torch.models.params import block_specs

sys.path.insert(0, str(Path(__file__).resolve().parent))
import mesh_workers as mw  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
REF_TIMEOUT = 170
TP_TOL, MOE_TOL, GRAD_TOL = 1e-6, 1e-5, 1e-5
STEP_RTOL, MODE_RTOL, ELASTIC_TOL, CLI_ATOL = 1e-4, 1e-5, 1e-5, 2e-2


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith(("RANK", "WORLD_SIZE"))}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    return env


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


class Reference:
    """The reference's run in its own process, started at once; `result()`
    waits for it."""

    def __init__(self, inputs: Path, out: Path, ckpt: Path):
        self.out, self.ckpt = out, ckpt
        self.proc = subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "mesh_reference.py"), "run", str(inputs),
             str(out), str(ckpt)], cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        self._npz = None

    def result(self):
        if self._npz is None:
            try:
                _, err = self.proc.communicate(timeout=REF_TIMEOUT)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.communicate()
                raise
            assert self.proc.returncode == 0, err[-3000:]
            self._npz = np.load(self.out)
        return self._npz


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh")


@pytest.fixture(scope="module")
def inputs(work):
    path = work / "inputs.npz"
    mw.write_inputs(str(path))
    return path


@pytest.fixture(scope="module", autouse=True)
def reference(work, inputs):
    """Started before the module's first test, so that the port-only tests
    (first in the file) run while it computes."""
    ref = Reference(inputs, work / "ref.npz", work / "ref_ckpt")
    yield ref
    if ref.proc.poll() is None:
        ref.proc.kill()
        ref.proc.communicate()


@pytest.fixture(scope="module")
def ranks42(work, inputs, reference):
    out = work / "out42"
    out.mkdir()
    mw.spawn(mw.work_4x2, 8, str(inputs), str(out))
    return np.load(out / "rank0.npz")


@pytest.fixture(scope="module")
def ranks22(work, inputs, reference):
    out = work / "out22"
    out.mkdir()
    mw.spawn(mw.work_2x2, 4, str(inputs), str(out), str(reference.ckpt))
    return out, np.load(out / "rank0.npz")


def _inp(inputs):
    return np.load(inputs)


def _channel(inputs, prefix: str, cfg, kind: str) -> dict:
    return mw._tree(_inp(inputs), prefix, block_specs(cfg, kind)["channel"])


def _shards(x: torch.Tensor, n: int) -> list:
    return list(torch.chunk(x, n, 0))


# ---------------------------------------------------------------------------
# the command lines on 2 ranks
# ---------------------------------------------------------------------------


def _launch(module: str, args: list, ranks: int) -> subprocess.CompletedProcess:
    head = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc-per-node={ranks}"] if ranks > 1 else [sys.executable]
    return subprocess.run([*head, "-m", module, *args], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=150)


@pytest.mark.parametrize("cli", ["train", "serve"])
def test_cli_on_two_ranks(cli, tmp_path):
    if cli == "train":
        args = ["--smoke", "--steps", "4", "--batch", "4", "--seq", "32", "--device", "cpu",
                "--microbatches", "2", "--grad-compression"]
        losses = []
        for data in (1, 2):
            out = tmp_path / f"d{data}.json"
            proc = _launch("repro_torch.launch.train",
                           [*args, "--data", str(data), "--metrics-out", str(out)], data)
            assert proc.returncode == 0, proc.stderr[-3000:]
            assert proc.stdout.count("done: final loss") == 1     # rank 0 alone prints
            losses.append(json.loads(out.read_text())["losses"])
        np.testing.assert_allclose(losses[1], losses[0], rtol=0, atol=CLI_ATOL)
    else:
        args = ["--smoke", "--batch", "4", "--prompt-len", "8", "--steps", "6", "--device",
                "cpu"]
        lines = []
        for data in (1, 2):
            proc = _launch("repro_torch.launch.serve", [*args, "--data", str(data)], data)
            assert proc.returncode == 0, proc.stderr[-3000:]
            sample = [ln for ln in proc.stdout.splitlines() if ln.startswith("sample:")]
            assert len(sample) == 1
            lines.append(sample[0])
        assert lines[0] == lines[1]


# ---------------------------------------------------------------------------
# port-only checks, run while the reference computes (ranks against the
# mesh-free port)
# ---------------------------------------------------------------------------


def _baseline_grads(fn, chan: dict, x: torch.Tensor, ct: torch.Tensor):
    gx, gp = mw._grads(fn, chan, x, ct, None)
    return gx.numpy(), {k: v.numpy() for k, v in gp.items()}


GRAD_CASES = ["tp", *(f"moe-{n}" for n in mw.MOE_CASES), *(f"dec-{n}" for n in mw.MOE_CASES)]


@pytest.mark.parametrize("case", GRAD_CASES)
def test_gradients_match_mesh_free_port(case, ranks42, inputs):
    """(4, 2) gradients of sum(out * ct) (parameters summed over dp, the
    input's rows gathered) against the mesh-free port's: the explicit-TP
    FFN; the MoE at 1.25 against the mesh-free MoE run on each dp shard
    (the mesh's capacity semantics); the decode MoE (no route drops)."""
    inp = _inp(inputs)
    if case == "tp":
        cfg = mw._cfg("tinyllama_1_1b")
        chan = _channel(inputs, "tp_params", cfg, "gqa+ffn")
        x, ct = torch.from_numpy(inp["tp_x"]), torch.from_numpy(inp["tp_ct"])
        gx, gp = _baseline_grads(lambda p, xx: ffn.ffn_forward(p, xx, cfg), chan, x, ct)
        tag = "tp_grad"
    else:
        kind_, name = case.split("-")
        arch, kind = mw.MOE_CASES[name]
        cfg = mw._cfg(arch, 1.25)
        chan = _channel(inputs, f"moe_params/{name}", cfg, kind)
        ct = torch.from_numpy(inp[f"moe_ct/{name}"])
        if kind_ == "moe":
            x = torch.from_numpy(inp[f"moe_x/{name}"])
            gx, gp = _baseline_grads(lambda p, xx: torch.cat(
                [ffn.moe_forward(p, s, cfg) for s in _shards(xx, 4)]), chan, x, ct)
            tag = f"moe_grad/{name}"
        else:
            x = torch.from_numpy(inp[f"moe_xd/{name}"])
            gx, gp = _baseline_grads(lambda p, xx: ffn.moe_forward(p, xx, cfg), chan, x,
                                     ct[:, :1].contiguous())
            tag = f"moe_dec_grad/{name}"
    # against the layer's largest gradient magnitude: with top-1 routing
    # the renormalised gate is exactly 1, and the router's gradient is
    # rounding noise (~1e-6) in both
    scale = max(float(np.abs(v).max()) for v in (gx, *gp.values()))
    for k, v in {"x": gx, **gp}.items():
        err = float(np.abs(ranks42[f"{tag}/{k}"].astype(np.float64) - v).max())
        assert err <= GRAD_TOL * scale, (k, err, scale)


def _ref_dropped(chan: dict, x: np.ndarray, rcfg) -> np.ndarray:
    """(t, E) bool: the routes the reference's body drops for one dp shard
    x, by its own router and top_k calls (`repro/models/ffn.py`:171-190)."""
    m = rcfg.moe
    h = r_attn.rmsnorm(jnp.asarray(x), jnp.asarray(chan["ln"]), rcfg.norm_eps)
    xt = h.reshape(-1, rcfg.d_model)
    t = xt.shape[0]
    probs = jax.nn.softmax(jnp.einsum("td,de->te", xt, jnp.asarray(chan["router"])), -1)
    vals, ids = jax.lax.top_k(probs, m.top_k)
    vals = vals / jnp.maximum(vals.sum(-1, keepdims=True), 1e-9)
    match = ids[:, :, None] == jnp.arange(m.num_experts)[None, None, :]
    gate = jnp.einsum("tk,tke->te", vals, match.astype(vals.dtype))
    top_gate, top_idx = jax.lax.top_k(jnp.where(gate > 0, gate, -1.0).T,
                                      r_ffn._capacity(max(t, 1), rcfg))
    kept = np.zeros((t, m.num_experts), bool)
    top_gate, top_idx = np.asarray(top_gate), np.asarray(top_idx)
    for e in range(m.num_experts):
        kept[top_idx[e][top_gate[e] > 0], e] = True
    return (np.asarray(gate) > 0) & ~kept


@pytest.mark.parametrize("dp", [4, 2])
@pytest.mark.parametrize("name", list(mw.MOE_CASES))
def test_moe_drops_per_dp_shard_match_reference(name, dp, inputs):
    arch, kind = mw.MOE_CASES[name]
    cfg = mw._cfg(arch, 1.25)
    rcfg = r_get_arch(arch, smoke=True).with_overrides(moe=cfg.moe)
    chan = _channel(inputs, f"moe_params/{name}", cfg, kind)
    x = torch.from_numpy(_inp(inputs)[f"moe_x/{name}"])
    total = 0
    for shard in _shards(x, dp):
        h = rmsnorm(shard, chan["ln"], cfg.norm_eps)
        ours = ffn.moe_dropped(chan, h, cfg).numpy()
        want = _ref_dropped({k: v.numpy() for k, v in chan.items()}, shard.numpy(), rcfg)
        assert np.array_equal(ours, want)
        total += int(want.sum())
    assert total > 0      # the shards overflow: the capacity is exercised


@pytest.mark.parametrize("mode", ["full_dp", "seq_shard"])
def test_train_modes_match_mesh_free_port(mode, ranks22, inputs):
    arch = "tinyllama_1_1b"
    _, losses, norms = mw._steps(mw._cfg(arch), Runtime(), mw.TC,
                                 mw._state(_inp(inputs), arch, mw.TC, None), 0, mw.TRAIN_STEPS)
    got = ranks22[1]
    np.testing.assert_allclose(got[f"{mode}_loss"], losses, rtol=MODE_RTOL)
    np.testing.assert_allclose(got[f"{mode}_gnorm"], norms, rtol=MODE_RTOL)


@pytest.mark.parametrize("target", ["4x1", "1x4", "none"])
def test_elastic_restore(target, ranks22):
    """Saved on (2, 2) after three steps; restored onto (4, 1), (1, 4) or
    no mesh, the next three losses equal continuing on (2, 2)."""
    got = ranks22[1]
    np.testing.assert_allclose(got[f"elastic/{target}"], got["elastic/2x2"], rtol=0,
                               atol=ELASTIC_TOL * float(np.abs(got["elastic/2x2"]).max()))


# ---------------------------------------------------------------------------
# forward results against the reference
# ---------------------------------------------------------------------------


def test_explicit_tp_matches_reference(ranks42, reference):
    assert rel_err(ranks42["tp_out"], reference.result()["tp_out/4x2"]) <= TP_TOL


@pytest.mark.parametrize("mesh", ["4x2", "2x2"])
@pytest.mark.parametrize("name", list(mw.MOE_CASES))
def test_moe_matches_reference(name, mesh, ranks42, ranks22, reference):
    """The expert-parallel body at capacity 1.25: routes drop per dp shard,
    so the mesh's output is not the one-device one, and the port's is the
    reference's."""
    ref = reference.result()
    got = (ranks42 if mesh == "4x2" else ranks22[1])[f"moe_out/{name}"]
    assert rel_err(got, ref[f"moe_out/{name}/{mesh}"]) <= MOE_TOL
    assert rel_err(ref[f"moe_out/{name}/{mesh}"], ref[f"moe_out/{name}/1x1"]) > 1e-2


@pytest.mark.parametrize("name", list(mw.MOE_CASES))
def test_decode_gather_matches_reference_and_baseline(name, ranks42, reference, inputs):
    arch, kind = mw.MOE_CASES[name]
    cfg = mw._cfg(arch, 1.25)
    chan = _channel(inputs, f"moe_params/{name}", cfg, kind)
    with torch.no_grad():
        base = ffn.moe_forward(chan, torch.from_numpy(_inp(inputs)[f"moe_xd/{name}"]), cfg)
    got = ranks42[f"moe_dec/{name}"]
    assert rel_err(got, reference.result()[f"moe_dec/{name}/4x2"]) <= MOE_TOL
    assert rel_err(got, base.numpy()) <= MOE_TOL


# ---------------------------------------------------------------------------
# against the reference's run: gradients, training, checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(mw.MOE_CASES))
def test_reference_moe_gradient_mesh_vs_one_device(name, reference):
    """The reference's own gradient through `psum` (shard_map, check_rep
    False) on (2, 2) against (1, 1), at a drop-free capacity."""
    ref = reference.result()
    keys = sorted(k for k in ref.files if k.startswith(f"moe_grad/{name}/2x2/"))
    assert keys
    for k in keys:
        assert rel_err(ref[k], ref[k.replace("/2x2/", "/1x1/")]) <= GRAD_TOL, k


@pytest.mark.parametrize("arch", mw.TRAIN_ARCHS)
def test_train_steps_match_reference(arch, ranks22, reference):
    """Three steps on (2, 2), microbatches 2, int8 compression, f32."""
    got, ref = ranks22[1], reference.result()
    for key in ("train_loss", "train_gnorm"):
        a, b = got[f"{key}/{arch}"], ref[f"{key}/{arch}"]
        np.testing.assert_allclose(a, b, rtol=STEP_RTOL, err_msg=key)


def test_checkpoint_crosses_packages(ranks22, reference, inputs, work):
    """The reference's (4, 2) checkpoint restores in the port, on (2, 2) and
    off the mesh, bit for bit; the port's, written by 4 ranks, restores in
    the reference onto (4, 2) bit for bit."""
    out_dir, got = ranks22
    reference.result()
    inp = _inp(inputs)
    n = sum(1 for k in inp.files if k.startswith("ckpt_params/"))
    assert int(got["ckpt_step"]) == 5
    for i in range(n):
        want = inp[f"ckpt_params/{i}"].view(np.int16)
        assert np.array_equal(got[f"ckpt_mesh/{i}"], want), i
        assert np.array_equal(got[f"ckpt_off/{i}"], want), i
    shards = json.loads((out_dir / "port_ckpt" / "step_00000007" / "manifest.json").read_text())
    assert sorted(p.name for p in (out_dir / "port_ckpt" / "step_00000007").glob("*.npz")) == [
        f"host_{r}_shards.npz" for r in range(4)]
    assert len(shards["shards"]) > len(shards["arrays"])     # sharded leaves: many windows
    back = work / "ref_restored.npz"
    proc = subprocess.run([sys.executable, str(ROOT / "tests" / "mesh_reference.py"), "restore",
                           str(out_dir / "port_ckpt"), str(back)], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = np.load(back)
    assert int(ref["step"]) == 7
    for i in range(n):
        assert np.array_equal(ref[f"leaf/{i}"].view(np.int16),
                              inp[f"ckpt_params/{i}"].view(np.int16)), i
        assert int(ref[f"shards/{i}"]) == 8
