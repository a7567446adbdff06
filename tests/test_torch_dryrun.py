"""The dry-run's tools (repro_torch.launch.op_cost, .specs, .dryrun)
against the reference's (repro.launch.hlo_cost, .specs, .dryrun).

The cost model's rules (the counterparts of tests/test_dist.py's HLO cost
checks: exact matrix-product flops, loops counted per trip, the
collective kinds, a fake group's all-gather, a checkpointed layer's
forward counted twice); `optimized_settings` entry for entry; the specs'
global and per-device shapes and dtypes against the reference's
`ShapeDtypeStruct`s on abstract meshes of the production shapes (the
decode caches too, cache_seq and inner over 'model'); a traced train
step's peak live bytes below its whole parameter tree's on a fake 256-rank
group (no point of the step holds every weight whole);
`run_cell` on smoke configs on the 16 x 16 mesh; the dry-run's counts on
a fake 4-rank group against the same counter on rank 0 of 4 real gloo
ranks running the same step (tests/mesh_workers.py `work_cost`); and the
port's matrix-product flops against the `dot` flops of the reference's
compiled programs (its own `HloCostModel`, restricted to dots), with no
mesh.
"""

import json
import math
import os
import sys
from dataclasses import replace
from pathlib import Path

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, AxisType

from repro.configs.base import SHAPES as R_SHAPES
from repro.configs.base import cells as r_cells
from repro.configs.base import get_arch as r_get_arch
from repro.dist.sharding import Runtime as RRuntime
from repro.dist.sharding import set_mesh
from repro.launch import hlo_cost
from repro.launch import specs as r_specs
from repro.models import model as r_model
from repro.train import step as r_step
from repro_torch.configs.base import ARCH_IDS, SHAPES, ShapeConfig, get_arch
from repro_torch.dist.sharding import Runtime
from repro_torch.launch import dryrun, op_cost, specs
from repro_torch.tree import leaves

sys.path.insert(0, str(Path(__file__).resolve().parent))
import mesh_workers as mw  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse fixture)

FLOP_RTOL = 0.01          # the port's matmul flops against the reference's dots
MESHES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}


def _moe16(cfg):
    """A smoke MoE config with 16 experts: the smoke configs' 8 and 4 do
    not divide over the production mesh's 16 'model' ranks."""
    return cfg.with_overrides(moe=replace(cfg.moe, num_experts=16)) if cfg.moe else cfg


# ---------------------------------------------------------------------------
# the cost model's rules
# ---------------------------------------------------------------------------


def test_matmul_flops_exact():
    _, cost = op_cost.count(lambda a, b: a @ b, torch.ones(32, 64), torch.ones(64, 48))
    assert cost.flops == 2 * 32 * 64 * 48 == cost.matmul_flops


def _loop(x, ws, inner: int = 1):
    for w in ws:
        for _ in range(inner):
            x = torch.tanh(x @ w)
    return x


def test_python_loops_count_every_trip():
    """The reference scales a scan body by its trip count; eager dispatch
    sees every trip: 8 trips count 8 times one, a nested 8 x 4 32 times."""
    x, w = torch.ones(64, 128), torch.ones(128, 128)
    one = op_cost.count(_loop, x, [w])[1]
    eight = op_cost.count(_loop, x, [w] * 8)[1]
    nested = op_cost.count(lambda x, ws: _loop(x, ws, 4), x, [w] * 8)[1]
    assert one.matmul_flops == 2 * 64 * 128 * 128
    for name in ("flops", "matmul_flops", "transcendentals", "bytes", "ops"):
        assert getattr(eight, name) == 8 * getattr(one, name), name
        assert getattr(nested, name) == 32 * getattr(one, name), name


def test_collective_kinds_are_the_reference_s():
    assert op_cost.COLLECTIVES == hlo_cost.COLLECTIVES
    assert set(op_cost._COLLECTIVE_OPS.values()) == set(hlo_cost.COLLECTIVES)


def test_fake_group_all_gather_counts_result_bytes():
    """A 4-rank fake group's all-gather of a (4096, 2048) bf16 tensor: one
    all-gather of its result, 4 * 4096 * 2048 * 2 bytes a device."""
    from repro_torch.dist.comm import _gather

    with dryrun.fake_group(4):
        x = torch.empty(4096, 2048, dtype=torch.bfloat16, device="meta")
        out, cost = op_cost.count(lambda t: _gather(t, dist.group.WORLD, 0), x)
    assert out.shape == (4 * 4096, 2048)
    assert cost.collectives == {"all-gather": {"count": 1, "bytes": 4 * 4096 * 2048 * 2}}
    assert cost.collective_bytes == 4 * 4096 * 2048 * 2


def test_checkpointed_forward_counts_twice():
    """Under `torch.utils.checkpoint` a layer's forward runs again in the
    backward and is counted again, as the reference's HLO counts remat."""
    from torch.utils.checkpoint import checkpoint

    x, w = torch.ones(64, 128), torch.ones(128, 96)

    def layer(h, w):
        return torch.tanh(h @ w)

    def step(x, w, remat):
        w = w.detach().requires_grad_()
        y = checkpoint(layer, x, w, use_reentrant=False) if remat else layer(x, w)
        return torch.autograd.grad(y.sum(), [w])[0]

    fwd = op_cost.count(layer, x, w)[1]
    plain = op_cost.count(step, x, w, False)[1]
    remat = op_cost.count(step, x, w, True)[1]
    assert remat.matmul_flops - plain.matmul_flops == fwd.matmul_flops
    assert remat.transcendentals - plain.transcendentals == fwd.transcendentals


def test_peak_memory_follows_frees():
    """The peak counts a storage while it is alive and never twice: a view
    adds nothing, a freed temporary leaves the live bytes."""
    def fn(x):
        t = x * 2                        # 4 MiB alive
        v = t.view(-1)[:10]              # a view: no new storage
        del v
        u = t + 1                        # 8 MiB alive at once
        del t
        return u.sum()

    x = torch.ones(1024, 1024)
    _, cost = op_cost.count(fn, x)
    assert cost.argument_bytes == 4 << 20
    assert cost.peak == 3 * (4 << 20)
    assert cost.output_bytes == 4


def test_meta_replay_counts_as_the_real_run():
    """The metadata cache for meta tensors changes no count: a smoke train
    step with remat on meta stand-ins against the same step on real CPU
    tensors."""
    from repro_torch.train.step import TrainConfig, init_train_state, make_train_step

    cfg = get_arch("tinyllama_1_1b", smoke=True)
    rt, tc = Runtime(remat=True), TrainConfig(microbatches=2)
    state = init_train_state(cfg, rt, tc, torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 2, 32), dtype=torch.int32)
             for k in ("labels", "tokens")}
    real = op_cost.OpCost()
    real.track(state, batch)
    with real:
        make_train_step(cfg, rt, tc)(state, batch)
    fake, _ = dryrun.trace(cfg, ShapeConfig("t", 32, 4, "train"), rt, train_config=tc)
    for name in ("flops", "bytes", "bytes_min", "transcendentals", "ops", "argument_bytes",
                 "peak"):
        assert getattr(fake, name) == getattr(real, name), name


# ---------------------------------------------------------------------------
# optimized settings and specs against the reference
# ---------------------------------------------------------------------------


def test_optimized_settings_equal_reference():
    keep = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import optimized_settings as r_optimized
    finally:                    # the reference's module sets it at import
        if keep is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = keep
    all_cells = r_cells(include_skips=True)
    assert len(all_cells) == 40
    for arch, shape, _ in all_cells:
        assert dryrun.optimized_settings(arch, shape) == r_optimized(arch, shape), (arch, shape)


def _ref_leaves(tree) -> list:
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))


def _port_leaf(t) -> tuple:
    local = getattr(t, "_local_tensor", t)
    return tuple(t.shape), str(t.dtype).replace("torch.", ""), tuple(local.shape)


def _ref_leaf(s) -> tuple:
    local = s.shape if s.sharding is None else s.sharding.shard_shape(s.shape)
    return tuple(s.shape), str(s.dtype), tuple(local)


@pytest.fixture(params=[False, True], ids=["16x16", "2x16x16"])
def meshes(request):
    """(the port's Runtime over a fake group's DeviceMesh, the reference's
    Runtime over an AbstractMesh) of one production mesh shape."""
    from torch.distributed.device_mesh import init_device_mesh

    sizes, names = MESHES[request.param]
    ref = RRuntime(mesh=AbstractMesh(sizes, names, axis_types=(AxisType.Auto,) * len(sizes)))
    with dryrun.fake_group(math.prod(sizes)):
        yield Runtime(mesh=init_device_mesh("cpu", sizes, mesh_dim_names=names)), ref


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_reference_per_device(arch, meshes):
    """Every leaf's global shape, dtype and per-device shape, for the state,
    the batch of every shape (one microbatch and 16), the decode tokens
    and the decode caches (cache_seq and inner over 'model')."""
    rt, rrt = meshes
    cfg, rcfg = get_arch(arch), r_get_arch(arch)
    got = [_port_leaf(t) for t in leaves(specs.state_specs(cfg, rt))]
    want = [_ref_leaf(s) for s in _ref_leaves(r_specs.state_specs(rcfg, rrt))]
    assert got == want
    for name, shape in SHAPES.items():
        for mb in (1, 16) if shape.global_batch % 16 == 0 else (1,):
            got = [_port_leaf(t) for t in leaves(specs.batch_specs(cfg, shape, rt, mb))]
            want = [_ref_leaf(s) for s in
                    _ref_leaves(r_specs.batch_specs(rcfg, R_SHAPES[name], rrt, mb))]
            assert got == want, (name, mb)
        if shape.kind != "decode":
            continue
        tokens, cache, pos = specs.decode_specs(cfg, shape, rt)
        rtokens, rcache, _ = r_specs.decode_specs(rcfg, R_SHAPES[name], rrt)
        assert _port_leaf(tokens) == _ref_leaf(rtokens) and pos == shape.seq_len - 1
        for t, s in zip(leaves(cache), _ref_leaves(rcache), strict=True):
            shape_, dtype, local = _port_leaf(t)
            rshape, rdtype, rlocal = _ref_leaf(s)
            assert (shape_, dtype) == (rshape, rdtype)
            assert local == rlocal, (name, shape_, rlocal)


# ---------------------------------------------------------------------------
# run_cell on smoke configs
# ---------------------------------------------------------------------------


def _local_bytes(tree) -> int:
    return sum(getattr(t, "_local_tensor", t).numel() * t.element_size() for t in leaves(tree))


def _spec_bytes(cfg, shape, rt) -> int:
    if shape.kind == "decode":
        tokens, cache, _ = specs.decode_specs(cfg, shape, rt)
        return _local_bytes(specs.state_specs(cfg, rt)["params"]) + _local_bytes((tokens, cache))
    batch = _local_bytes(specs.batch_specs(cfg, shape, rt))
    if shape.kind == "train":
        return _local_bytes(specs.state_specs(cfg, rt)) + batch
    return _local_bytes(specs.state_specs(cfg, rt)["params"]) + batch


RUN_CELLS = ([(arch, "train_4k") for arch in ARCH_IDS]
             + [(arch, shape) for arch in ("tinyllama_1_1b", "deepseek_v3_671b", "mamba2_1_3b")
                for shape in ("prefill_32k", "decode_32k")])


@pytest.mark.parametrize("arch,shape", RUN_CELLS)
def test_run_cell_on_smoke_configs(arch, shape, monkeypatch):
    """Status ok on the 16 x 16 mesh, the arguments' bytes those of the
    specs, every collective one of the reference's kinds."""
    from torch.distributed.device_mesh import init_device_mesh

    monkeypatch.setattr(dryrun, "get_arch", lambda a: _moe16(get_arch(a, smoke=True)))
    r = dryrun.run_cell(arch, shape, multi_pod=False, verbose=False, device="cpu")
    assert r["status"] == "ok" and r["n_chips"] == 256 and r["mesh"] == "16x16"
    pd = r["per_device"]
    assert pd["flops"] > 0 and pd["bytes_accessed"] >= pd["bytes_min"] > 0
    assert pd["temp_bytes"] > 0 and set(r["collectives"]) <= set(hlo_cost.COLLECTIVES)
    assert isinstance(r["fallbacks"], list)
    assert r["roofline_seconds"]["compute"] == pd["flops"] / dryrun.PEAK_FLOPS
    with dryrun.fake_group(256):
        rt = Runtime(mesh=init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model")))
        want = _spec_bytes(_moe16(get_arch(arch, smoke=True)), SHAPES[shape], rt)
    assert pd["argument_bytes"] == want


PEAK_ARCHS = ("tinyllama_1_1b", "deepseek_v3_671b", "recurrentgemma_2b")


@pytest.mark.parametrize("arch", PEAK_ARCHS)
def test_train_step_never_holds_the_whole_parameter_tree(arch):
    """A smoke config's train step traced on the 16 x 16 fake group (B 16,
    S 8: one row a dp rank, so activations stay small): its peak live
    bytes (arguments, gathered weights, activations and gradients) stay
    below the bytes of the whole bf16 parameter tree. Each layer's
    weights are gathered inside the layer and the gradients come back as
    shards, so no point of the step holds every weight (or gradient)
    whole; gathering them all before the forward did (peak 2.6-6.2 x the
    tree on these configs)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models.params import count_params
    from repro_torch.train.step import TrainConfig

    cfg = _moe16(get_arch(arch, smoke=True))
    with dryrun.fake_group(256):
        rt = Runtime(mesh=init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model")))
        cost, _ = dryrun.trace(cfg, ShapeConfig("peak", 8, 16, "train"), rt,
                               train_config=TrainConfig())
    assert 0 < cost.peak < 2 * count_params(cfg), (cost.peak, 2 * count_params(cfg))


HEAD_FALLBACKS = {"qwen2_5_32b": 40, "llama4_scout_17b_a16e": 40, "llava_next_34b": 56,
                  "minitron_4b": 24, "recurrentgemma_2b": 10}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fallbacks_list_the_heads_the_mesh_does_not_divide(arch):
    """On 16 x 16, the attention heads of five archs do not divide over the
    16 'model' ranks: the dry-run lists them, and those bodies run
    replicated over 'model' (the reference's fallback); no other dim of
    any arch's parameters or decode caches falls back."""
    from repro_torch.launch.mesh import make_production_mesh

    rt = Runtime(mesh=make_production_mesh())
    got = dryrun.spec_fallbacks(get_arch(arch), SHAPES["decode_32k"], rt)
    want = [["heads", HEAD_FALLBACKS[arch], 16]] if arch in HEAD_FALLBACKS else []
    assert got == want


def test_placing_a_cache_window_allocates_nothing():
    """`_place_cache` wraps a rank's window as a DTensor of the cache's
    global shape without making a tensor of that shape (it once read the
    strides off a meta one, which the prefill cells' traces counted as
    live: ~593 of nemotron_4_340b x prefill_32k's 617 GiB of temp)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import model
    from repro_torch.tree import leaves as tree_leaves

    cfg = get_arch("tinyllama_1_1b", smoke=True)
    spec = tree_leaves(model.cache_specs(cfg, 8, 64))[0]
    with dryrun.fake_group(4):
        rt = Runtime(mesh=init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model")))
        local = torch.empty((spec.shape[0], 4, 32, *spec.shape[3:]), dtype=spec.dtype,
                            device="meta")
        out, cost = op_cost.count(lambda t: model._place_cache(t, spec, rt), local)
    assert tuple(out.shape) == spec.shape and tuple(out.to_local().shape) == tuple(local.shape)
    assert cost.peak == cost.argument_bytes


def test_long_500k_skips_full_attention_with_the_reference_reason():
    r = dryrun.run_cell("tinyllama_1_1b", "long_500k", multi_pod=True)
    assert r["status"] == "skipped" and r["reason"] == dryrun.SKIP_REASON
    assert "sub-quadratic" in r["reason"]


def test_cell_refuses_while_a_group_is_up(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="process group is up"):
            dryrun.run_cell("tinyllama_1_1b", "decode_32k", multi_pod=False)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# fake group against real gloo ranks
# ---------------------------------------------------------------------------


def test_fake_group_counts_equal_real_gloo_ranks(tmp_path):
    """The smoke tinyllama's remat train step (2 microbatches) on a (2, 2)
    mesh: flops, bytes and the collectives by kind on a fake 4-rank group
    with meta stand-ins equal, exactly, rank 0's counts on 4 gloo ranks
    running the step on real tensors, less the host copies that gloo
    adds to finish its reduce-scatters."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.train.step import TrainConfig

    ranks = mw.Ranks(mw.work_cost, 4, str(tmp_path), timeout=150)
    try:
        with dryrun.fake_group(4):
            rt = Runtime(mesh=init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model")),
                         remat=True)
            fake, _ = dryrun.trace(get_arch(mw.COST_ARCH, smoke=True),
                                   ShapeConfig("cost", mw.COST_S, mw.COST_B, "train"), rt,
                                   train_config=TrainConfig(microbatches=mw.COST_MB))
    finally:
        ranks.wait()
    real = json.loads((tmp_path / "cost.json").read_text())
    assert fake.collectives == real["collectives"]
    assert set(fake.collectives) == {"all-gather", "all-reduce", "reduce-scatter"}
    assert fake.flops == real["flops"]
    # gloo finishes each reduce-scatter on the host, after the op returns:
    # a split and a copy of the result out of its scratch buffer (2 ops
    # that move 2 x the result's bytes), which the fake group (and NCCL)
    # do not run. Nothing else differs.
    rs = real["collectives"]["reduce-scatter"]
    assert real["ops"] - 2 * rs["count"] == fake.ops
    for name in ("bytes", "bytes_min"):
        assert real[name] - 2 * rs["bytes"] == getattr(fake, name), name


# ---------------------------------------------------------------------------
# matrix-product flops against the reference's compiled programs
# ---------------------------------------------------------------------------


class _DotFlops(hlo_cost.HloCostModel):
    """The reference's loop-aware cost model with flops counted for `dot`
    ops only (loops, calls, conditionals and fusions still roll them up)."""

    def _op_cost(self, comp, op, fused):
        c = super()._op_cost(comp, op, fused)
        if op.kind not in ("dot", "while", "conditional", "call", "async-start", "fusion"):
            c.flops = 0.0
        return c


def _ref_dot_flops(fn, *args) -> float:
    text = jax.jit(fn).lower(*args).compile().as_text()
    return _DotFlops(text).total().flops


FLOP_ARCHS = ("tinyllama_1_1b", "deepseek_v3_671b", "mamba2_1_3b")
FLOP_B, FLOP_S = 4, 64


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", FLOP_ARCHS)
def test_matmul_flops_match_reference_dots(arch, kind):
    """No mesh, B 4 x S 64: the port's matmul flops within 1% of the `dot`
    flops of the reference's compiled train step / prefill."""
    cfg, rcfg = get_arch(arch, smoke=True), r_get_arch(arch, smoke=True)
    shape = ShapeConfig(kind, FLOP_S, FLOP_B, kind)
    cost, _ = dryrun.trace(cfg, shape, Runtime())
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
    rt = RRuntime(mesh=mesh)
    rshape = replace(R_SHAPES["train_4k" if kind == "train" else "prefill_32k"],
                     seq_len=FLOP_S, global_batch=FLOP_B)
    with set_mesh(mesh):
        state = r_specs.state_specs(rcfg, rt)
        batch = r_specs.batch_specs(rcfg, rshape, rt)
        if kind == "train":
            want = _ref_dot_flops(r_step.make_train_step(rcfg, rt, r_step.TrainConfig()),
                                  state, batch)
        else:
            want = _ref_dot_flops(lambda p, b: r_model.prefill(p, b, rcfg, rt),
                                  state["params"], batch)
    assert cost.matmul_flops == pytest.approx(want, rel=FLOP_RTOL), (cost.matmul_flops, want)
