"""The sharded layouts on gloo ranks against the mesh-free port and `repro`
on forced host devices.

On (1, 2), (2, 2) and (4, 2) meshes of gloo ranks (tests/mesh_workers.py
`work_layouts`, one spawn per shape, all started at once), each layout
case (`mesh_workers.LAYOUT_CASES`: GQA with the untied and the tied head,
RG-LRU with local attention past its window, MLA with the MoE and
deepseek's MTP head, GQA with the MoE, SSD; smoke configs, f32, the MoE at
a drop-free capacity so that every mesh computes the same function) runs
with its weights placed by their specs: the loss and every leaf's gradient
(the train step's `compute_grads`: weights gathered at use, heads,
channels, f columns and vocabulary split over 'model', gradients
reduce-scattered back), a prefill into sequence-split caches and 28
decode steps across the ranks' slot boundary (slot 24 of 48; the
local-attention ring's 16 of 32, past its wrap at 32). Beside them the
reference runs the same cases on 8 forced host devices under a (4, 2)
`Auto` mesh (tests/mesh_reference.py `layouts`), and this process runs the
mesh-free port (the baseline).

Tolerances: against the mesh-free port, the loss within 1e-5 relative,
each gradient leaf within 1e-5 of max(its largest magnitude, 1e-2 of the
tree's: the router's gradient under top-1 routing is rounding noise, the
renormalised gate being exactly 1) and the decode logits within 1e-5 of
their largest magnitude (f32 sums over the ranks taken in other orders);
against the reference, test_torch_train.py's rules (loss 1e-5 relative,
each leaf 1e-4 of the same scale: two packages' op orders) and
test_torch_lm.py's (the decode's log-probs within 1e-4 of the reference's
full forward, position by position). Each rank's local shapes of the
weights, the gradients and the caches equal the reference's per-device
shapes under its specs.
"""

import json
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
from jax.sharding import AbstractMesh, AxisType

from repro.configs.base import SHAPES as R_SHAPES
from repro.configs.base import get_arch as r_get_arch
from repro.dist.sharding import Runtime as RRuntime
from repro.launch import specs as r_specs
from repro_torch.dist.sharding import Runtime
from repro_torch.models.params import _map_specs, param_specs

sys.path.insert(0, str(Path(__file__).resolve().parent))
import mesh_workers as mw  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
REF_TIMEOUT, RANKS_TIMEOUT = 170, 170
MESH_TOL, LOSS_RTOL, REF_GRAD_TOL, LOGP_TOL = 1e-5, 1e-5, 1e-4, 1e-4
GRAD_FLOOR = 1e-2
CASES = list(mw.LAYOUT_CASES)
MESHES = [f"{d}x{m}" for d, m in mw.LAYOUT_MESHES]


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith(("RANK", "WORLD_SIZE"))}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    return env


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("layouts")


@pytest.fixture(scope="module")
def inputs(work):
    path = work / "inputs.npz"
    mw.write_layout_inputs(str(path))
    return path


@pytest.fixture(scope="module")
def reference(work, inputs):
    """The reference's run, started with the ranks; the npz once done."""
    out = work / "ref.npz"
    proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "mesh_reference.py"),
                             "layouts", str(inputs), str(out)], cwd=ROOT, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ranks(work, inputs, reference):
    """{mesh: (rank 0's npz, every rank's local shapes)}, the three meshes'
    spawns running at once (beside the reference)."""
    started = {}
    for shape in mw.LAYOUT_MESHES:
        out = work / f"{shape[0]}x{shape[1]}"
        out.mkdir()
        started[out.name] = (out, shape[0] * shape[1], mw.Ranks(
            mw.work_layouts, shape[0] * shape[1], str(inputs), str(out), shape,
            timeout=RANKS_TIMEOUT))
    got = {}
    for name, (out, n, r) in started.items():
        r.wait()
        shapes = [json.loads((out / f"shapes{i}.json").read_text()) for i in range(n)]
        got[name] = (np.load(out / "rank0.npz"), shapes)
    return got


@pytest.fixture(scope="module")
def ref(reference):
    proc, out = reference
    try:
        _, err = proc.communicate(timeout=REF_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, err[-3000:]
    return np.load(out)


@pytest.fixture(scope="module")
def baseline(inputs, ranks):
    """The mesh-free port on the same inputs (after the ranks, which need
    the cores)."""
    inp = np.load(inputs)
    out: dict = {}
    for case in CASES:
        cfg = mw.layout_cfg(case)
        params = mw._tree(inp, f"{case}/params", _map_specs(lambda s: s, param_specs(cfg)))
        mw.layout_run(cfg, params, inp, case, Runtime(), out, {})
    return out


def _grad_keys(npz, case: str) -> list:
    n = sum(1 for k in npz.keys() if k.startswith(f"{case}/grad/"))
    return [f"{case}/grad/{i}" for i in range(n)]


def _assert_grads(got, want, keys, tol):
    top = max(float(np.abs(want[k]).max()) for k in keys)
    for k in keys:
        a, b = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        assert a.shape == b.shape, k
        scale = max(float(np.abs(b).max()), GRAD_FLOOR * top)
        assert float(np.abs(a - b).max()) <= tol * scale, (k, float(np.abs(a - b).max()), scale)


def _log_softmax(a: np.ndarray, vocab: int) -> np.ndarray:
    a = np.asarray(a, np.float64)[..., :vocab]
    m = a.max(-1, keepdims=True)
    return a - m - np.log(np.exp(a - m).sum(-1, keepdims=True))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", CASES)
def test_loss_and_grads_match_mesh_free_port(case, mesh, ranks, baseline):
    got, _ = ranks[mesh]
    want = float(baseline[f"{case}/loss"])
    assert abs(float(got[f"{case}/loss"]) - want) <= LOSS_RTOL * abs(want)
    _assert_grads(got, baseline, _grad_keys(got, case), MESH_TOL)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", CASES)
def test_loss_and_grads_match_reference(case, mesh, ranks, ref):
    got, _ = ranks[mesh]
    want = float(ref[f"{case}/loss"])
    assert abs(float(got[f"{case}/loss"]) - want) <= LOSS_RTOL * abs(want)
    keys = _grad_keys(ref, case)
    assert keys == _grad_keys(got, case)
    _assert_grads(got, ref, keys, REF_GRAD_TOL)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", CASES)
def test_decode_across_rank_boundary(case, mesh, ranks, baseline, ref):
    """The prefill's logits and 28 decode steps' (positions 12..39): equal
    to the mesh-free port's, and the reference's full forward's log-probs
    at the same positions."""
    got = ranks[mesh][0][f"{case}/decode"]
    want = baseline[f"{case}/decode"]
    assert got.shape == want.shape == (mw.LAYOUT_B, mw.DEC_END - mw.DEC_S0 + 1, got.shape[-1])
    assert float(np.abs(got - want).max()) <= MESH_TOL * float(np.abs(want).max())
    v = mw.layout_cfg(case).vocab_size
    fwd = ref[f"{case}/logits"][:, mw.DEC_S0 - 1:mw.DEC_END]
    err = np.abs(_log_softmax(got, v) - _log_softmax(fwd, v)).max()
    assert err < LOGP_TOL, err


def _ref_local(structs) -> list:
    import jax

    return [list(s.sharding.shard_shape(s.shape)) for s in
            jax.tree.leaves(structs, is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", CASES)
def test_local_shapes_equal_reference_spec(case, mesh, ranks):
    """Every rank holds its spec's window of each weight, gradient and
    cache leaf: the reference's per-device shapes on the same mesh."""
    sizes = tuple(int(n) for n in mesh.split("x"))
    rrt = RRuntime(mesh=AbstractMesh(sizes, ("data", "model"),
                                     axis_types=(AxisType.Auto, AxisType.Auto)))
    rcfg = mw.layout_cfg(case, r_get_arch)
    params = _ref_local(r_specs.state_specs(rcfg, rrt)["params"])
    shape = replace(R_SHAPES["decode_32k"], seq_len=mw.DEC_SMAX, global_batch=mw.LAYOUT_B)
    _, cache, _ = r_specs.decode_specs(rcfg, shape, rrt)
    caches = _ref_local(cache)
    for shapes in ranks[mesh][1]:
        assert shapes[f"{case}/param"] == params
        assert shapes[f"{case}/grad"] == params
        assert shapes[f"{case}/cache"] == caches


@pytest.mark.parametrize("mesh", MESHES)
def test_remat_and_weights_once_on_the_mesh(mesh, ranks):
    """Under remat each layer's gathers run again in the backward: the
    gradients equal the plain backward's; weights_once (one gather a step,
    outside 2 microbatches) gives the same two steps as gathering in each."""
    got, _ = ranks[mesh]
    keys = _grad_keys(got, "gqa")
    assert float(got["remat/loss"]) == pytest.approx(float(got["gqa/loss"]), rel=LOSS_RTOL)
    _assert_grads({k: got[k.replace("gqa/", "remat/")] for k in keys}, got, keys, MESH_TOL)
    for key in ("loss", "gnorm"):
        np.testing.assert_allclose(got[f"once1/{key}"], got[f"once0/{key}"], rtol=MESH_TOL)
