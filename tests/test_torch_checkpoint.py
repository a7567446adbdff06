"""The port's checkpoint store: the counterparts of `tests/test_checkpoint.py`
onto one device, and checkpoints that cross between the two packages.

Both packages write the same format (`step_XXXXXXXX/manifest.json` and
`host_0_shards.npz`, keys `path::i`, bf16 as its uint16 bits), so a
checkpoint written by either restores in the other bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from repro.checkpoint import store as r_store
from repro_torch.checkpoint.store import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.tree import leaves
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def _tree():
    return {
        "params": {
            "w": torch.arange(24, dtype=torch.bfloat16).reshape(4, 6),
            "b": torch.ones((3,), dtype=torch.float32) * 0.5,
        },
        "opt": {"step": torch.tensor(7, dtype=torch.int32), "m": [torch.zeros((2, 2))]},
    }


def bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def assert_trees_equal(a, b):
    for x, y in zip(leaves(a), leaves(b), strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(bits(x), bits(y))


def test_roundtrip(tmp_path):
    tree = _tree()
    save_checkpoint(tmp_path, 3, tree)
    restored, step = restore_checkpoint(tmp_path, tree, "cpu")
    assert step == 3
    assert_trees_equal(tree, restored)
    assert restored["opt"]["step"].shape == ()


def test_latest_step_and_multiple(tmp_path):
    t = _tree()
    assert latest_step(tmp_path) is None
    save_checkpoint(tmp_path, 1, t)
    save_checkpoint(tmp_path, 10, t)
    save_checkpoint(tmp_path, 5, t)
    assert latest_step(tmp_path) == 10


def test_atomic_commit_ignores_partial(tmp_path):
    t = _tree()
    save_checkpoint(tmp_path, 2, t)
    # simulate a crash mid-write: a stale .tmp directory
    (tmp_path / "step_00000009.tmp").mkdir()
    assert latest_step(tmp_path) == 2
    _, step = restore_checkpoint(tmp_path, t, "cpu")
    assert step == 2


def test_async_checkpointer(tmp_path):
    t = _tree()
    ck = AsyncCheckpointer(tmp_path)
    ck.save(4, t)
    t["params"]["b"].add_(1.0)       # a later step: the snapshot was taken at save
    ck.wait()
    assert latest_step(tmp_path) == 4
    restored, _ = restore_checkpoint(tmp_path, t, "cpu")
    np.testing.assert_array_equal(bits(restored["params"]["w"]), bits(t["params"]["w"]))
    assert torch.equal(restored["params"]["b"], torch.full((3,), 0.5))


def test_async_error_surfaces(tmp_path):
    # a directory path under a regular file cannot be created, even by root
    blocker = tmp_path / "blocker"
    blocker.write_text("x")
    ck = AsyncCheckpointer(blocker / "sub")
    try:
        ck.save(0, _tree())
        with pytest.raises(Exception):
            ck.wait()
    except (PermissionError, NotADirectoryError):
        pass  # raised synchronously on some systems: equally fine


def test_restore_falls_back_past_corrupt_newest(tmp_path):
    """A crash-landed newest step (manifest truncated or missing): restore
    with step=None warns and falls back to the previous durable step."""
    t = _tree()
    save_checkpoint(tmp_path, 2, t)
    save_checkpoint(tmp_path, 5, t)
    (tmp_path / "step_00000005" / "manifest.json").write_text('{"step": 5,')
    with pytest.warns(UserWarning, match="skipping non-durable checkpoint"):
        restored, step = restore_checkpoint(tmp_path, t, "cpu")
    assert step == 2
    assert torch.equal(restored["params"]["b"], t["params"]["b"])

    save_checkpoint(tmp_path, 9, t)
    (tmp_path / "step_00000009" / "manifest.json").unlink()
    with pytest.warns(UserWarning, match="skipping non-durable checkpoint"):
        _, step = restore_checkpoint(tmp_path, t, "cpu")
    assert step == 2


def test_restore_explicit_step_not_second_guessed(tmp_path):
    """An explicitly requested corrupt step raises: no silent fallback."""
    t = _tree()
    save_checkpoint(tmp_path, 2, t)
    save_checkpoint(tmp_path, 5, t)
    (tmp_path / "step_00000005" / "manifest.json").write_text("garbage")
    with pytest.raises(Exception):
        restore_checkpoint(tmp_path, t, "cpu", step=5)


def test_restore_no_durable_step_is_actionable(tmp_path):
    t = _tree()
    save_checkpoint(tmp_path, 1, t)
    (tmp_path / "step_00000001" / "manifest.json").write_text("{}")
    with pytest.warns(UserWarning, match="skipping non-durable checkpoint"):
        with pytest.raises(FileNotFoundError, match="no durable checkpoint"):
            restore_checkpoint(tmp_path, t, "cpu")


def test_bf16_bit_exact(tmp_path):
    # values that straddle bf16 rounding must round-trip bit-exactly
    w = (torch.arange(64, dtype=torch.float32) * 0.1234567).to(torch.bfloat16)
    save_checkpoint(tmp_path, 0, {"w": w})
    restored, _ = restore_checkpoint(tmp_path, {"w": None}, "cpu")
    np.testing.assert_array_equal(bits(restored["w"]), bits(w))


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------


def _ref_tree():
    w = (jnp.arange(24, dtype=jnp.float32) * 0.1234567).astype(jnp.bfloat16).reshape(4, 6)
    return {
        "params": {"w": w, "b": jnp.linspace(-1, 1, 3, dtype=jnp.float32)},
        "opt": {"step": jnp.int32(7), "m": [jnp.full((2, 2), 1 / 3, jnp.float32)]},
        "err": {"q": jnp.asarray(np.arange(-4, 4, dtype=np.int8))},
    }


def test_reference_checkpoint_restores_bitwise_in_the_port(tmp_path):
    ref = _ref_tree()
    r_store.save_checkpoint(tmp_path, 6, ref)
    ours, step = restore_checkpoint(tmp_path, ref, "cpu")
    assert step == 6
    for x, y in zip(leaves(ours), jax.tree.leaves(ref), strict=True):
        y = np.asarray(y)
        assert str(x.dtype).removeprefix("torch.") == y.dtype.name and x.shape == y.shape
        want = y.view(np.int16) if y.dtype.name == "bfloat16" else y
        np.testing.assert_array_equal(bits(x), want)


def test_port_checkpoint_restores_bitwise_in_the_reference(tmp_path):
    tree = _tree()
    tree["params"]["w"] = (torch.arange(24, dtype=torch.float32) * 0.1234567).to(
        torch.bfloat16).reshape(4, 6)
    ck = AsyncCheckpointer(tmp_path)
    ck.save(11, tree)
    ck.wait()
    mesh = jax.make_mesh((1,), ("data",))
    shardings = jax.tree.map(lambda _: NamedSharding(mesh, P()), skeleton_of(tree))
    ref, step = r_store.restore_checkpoint(tmp_path, skeleton_of(tree), shardings)
    assert step == 11
    for x, y in zip(leaves(tree), jax.tree.leaves(ref), strict=True):
        y = np.asarray(y)
        assert str(x.dtype).removeprefix("torch.") == y.dtype.name and x.shape == y.shape
        want = y.view(np.int16) if y.dtype.name == "bfloat16" else y
        np.testing.assert_array_equal(bits(x), want)


def skeleton_of(tree):
    """tree's structure with 0 at every leaf (a skeleton both packages walk)."""
    if isinstance(tree, dict):
        return {k: skeleton_of(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [skeleton_of(v) for v in tree]
    return 0


def test_reference_train_state_restores_into_the_cli_skeleton(tmp_path):
    """The reference's whole training state (smoke tinyllama_1_1b, bf16
    parameters, f32 moments, compression buffers) restores into the train
    command line's skeleton, equal to the same state carried across."""
    from jax.sharding import AxisType

    from repro.configs.base import get_arch as r_get_arch
    from repro.dist.sharding import Runtime as RRuntime
    from repro.train.step import TrainConfig as RTrainConfig
    from repro.train.step import init_train_state
    from repro_torch.configs.base import get_arch
    from repro_torch.convert import train_state_from_reference
    from repro_torch.launch.train import state_skeleton
    from repro_torch.train.step import TrainConfig

    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
    rstate = init_train_state(r_get_arch("tinyllama_1_1b", smoke=True), RRuntime(mesh=mesh),
                              RTrainConfig(grad_compression=True), jax.random.PRNGKey(4))
    r_store.save_checkpoint(tmp_path, 0, rstate)
    skeleton = state_skeleton(get_arch("tinyllama_1_1b", smoke=True),
                              TrainConfig(grad_compression=True))
    ours, _ = restore_checkpoint(tmp_path, skeleton, "cpu")
    carried = train_state_from_reference(jax.tree.map(np.asarray, rstate), device="cpu")
    assert ours["params"]["embed"].dtype == torch.bfloat16
    assert_trees_equal(ours, carried)
