"""The port's sharding rules against `repro.dist.sharding`, entry for entry.

`logical_to_spec` maps every ParamSpec of `param_specs(cfg)` and of
`cache_specs(cfg, 8, 4096)`, for the ten configs at their published
widths (specs only: nothing is allocated), onto meshes of (1, 1), (2, 2),
(4, 2), (8, 1), (16, 16) and (2, 16, 16) axes, plain, under full_dp,
seq_shard and rules={"embed": None}; the specs must be equal and so must
the `fallbacks` lists. The meshes are abstract on both sides (axis names
and sizes, no devices): the rules read nothing else. `Runtime`'s dp_axes,
dp_size and tp_size follow the reference's `tests/test_dist.py`.
"""

import pytest

from repro.configs.base import get_arch as r_get_arch
from repro.dist.sharding import Runtime as RRuntime
from repro.dist.sharding import abstract_mesh as r_abstract_mesh
from repro.dist.sharding import logical_to_spec as r_logical_to_spec
from repro.models import model as r_model
from repro.models import params as r_params
from repro_torch.configs.base import ARCH_IDS, get_arch
from repro_torch.dist.sharding import P, Runtime, abstract_mesh, logical_to_spec, placements
from repro_torch.launch.mesh import make_production_mesh, mesh_with_stage_axis
from repro_torch.models import model
from repro_torch.models.params import param_specs

MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "8x1": ((8, 1), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
MODES = {"plain": {}, "full_dp": {"full_dp": True}, "seq_shard": {"seq_shard": True},
         "embed_none": {"rules": {"embed": None}}}


def _spec_leaves(tree, prefix="") -> list:
    """(path, spec) of every leaf, dict keys sorted (the segments' `kinds`
    and `repeats` left out)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) if k not in ("kinds", "repeats")
                for x in _spec_leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _spec_leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _mapped(leaves, rt, fn):
    fallbacks = []
    specs = [tuple(fn(tuple(s.logical), tuple(s.shape), rt, fallbacks)) for _, s in leaves]
    return specs, fallbacks


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_logical_to_spec_matches_reference(arch, mesh, mode):
    sizes, names = MESHES[mesh]
    rt = Runtime(mesh=abstract_mesh(sizes, names), **MODES[mode])
    r_rt = RRuntime(mesh=r_abstract_mesh(sizes, names), **MODES[mode])
    cfg, r_cfg = get_arch(arch), r_get_arch(arch)
    for ours_tree, ref_tree in (
            (param_specs(cfg), r_params.param_specs(r_cfg)),
            (model.cache_specs(cfg, 8, 4096), r_model.cache_specs(r_cfg, 8, 4096))):
        ours_l, ref_l = _spec_leaves(ours_tree), _spec_leaves(ref_tree)
        assert [(p, s.shape, s.logical) for p, s in ours_l] == [
            (p, tuple(s.shape), tuple(s.logical)) for p, s in ref_l]
        ours, fb = _mapped(ours_l, rt, logical_to_spec)
        ref, r_fb = _mapped(ref_l, r_rt, r_logical_to_spec)
        assert ours == [tuple(s) for s in ref]
        assert fb == r_fb


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_runtime_axes_match_reference(mesh, mode):
    sizes, names = MESHES[mesh]
    rt = Runtime(mesh=abstract_mesh(sizes, names), **MODES[mode])
    r_rt = RRuntime(mesh=r_abstract_mesh(sizes, names), **MODES[mode])
    assert rt.dp_axes == r_rt.dp_axes
    assert rt.tp_axis == r_rt.tp_axis
    assert (rt.dp_size, rt.tp_size) == (r_rt.dp_size, r_rt.tp_size)
    assert not rt.distributed


def test_reference_rules_cases():
    """The reference's own cases (tests/test_dist.py) on the port."""
    rt = Runtime(mesh=abstract_mesh((1, 1), ("data", "model")))
    assert rt.dp_axes == ("data",) and rt.tp_axis == "model"
    assert rt.dp_size == 1 and rt.tp_size == 1
    assert logical_to_spec(("embed", "ff"), (64, 128), rt) == P("data", "model")
    rt = Runtime(mesh=abstract_mesh((1, 2), ("data", "model")))
    fallbacks = []
    assert logical_to_spec(("heads", "head"), (41, 8), rt, fallbacks) == P(None, None)
    assert fallbacks and fallbacks[0][0] == "heads"
    assert logical_to_spec(("ff",), (64,), Runtime(mesh=abstract_mesh((2,), ("data",)))) == P(None)
    rt = Runtime(mesh=make_production_mesh(multi_pod=True))
    assert rt.dp_axes == ("pod", "data")
    assert rt.dp_size == 32 and rt.tp_size == 16
    assert logical_to_spec(("heads",), (40,), rt) == P(None)
    assert logical_to_spec(("ff",), (27648,), rt) == P("model")
    assert logical_to_spec(("embed",), (5120,), rt) == P(("pod", "data"))
    rt2 = Runtime(mesh=rt.mesh, full_dp=True)
    assert rt2.dp_size == 512
    assert logical_to_spec(("ff",), (27648,), rt2) == P(None)
    assert "pod" not in Runtime(mesh=make_production_mesh()).dp_axes
    stage = mesh_with_stage_axis(2, 4, 2)
    assert stage.axis_names == ("stage", "data", "model") and stage.size == 16


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    mesh = abstract_mesh((2, 4, 2), ("pod", "data", "model"))
    assert placements(P(("pod", "data"), "model"), mesh) == (Shard(0), Shard(0), Shard(1))
    assert placements(P(None, None), mesh) == (Replicate(),) * 3
    assert placements(P(None, "data"), mesh) == (Replicate(), Shard(1), Replicate())


def test_one_card_runtime_is_unchanged():
    rt = Runtime()
    assert (rt.dp_axes, rt.dp_size, rt.tp_size, rt.distributed) == ((), 1, 1, False)
    assert logical_to_spec(("embed", "ff"), (64, 128), rt) == P(None, None)
    # every mode is taken (none raises), with or without a mesh
    Runtime(explicit_tp=True, seq_shard=True, full_dp=True, moe_decode_gather=True)
