"""The reference's multi-device results for tests/test_torch_mesh.py.

Run as a script, in a process of its own, on 8 forced host devices:

  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      PYTHONPATH=src python tests/mesh_reference.py run INPUTS.npz OUT.npz CKPT_DIR
  ... python tests/mesh_reference.py restore CKPT_DIR OUT.npz
  ... python tests/mesh_reference.py serve GRAPHS.npz OUT.npz
  ... python tests/mesh_reference.py layouts INPUTS.npz OUT.npz

`run` reads the inputs (tests/mesh_workers.py `write_inputs`: weights,
activations, initial training states and cotangents, the same for both
packages) and writes the reference's outputs on meshes of
`AxisType.Auto` axes (its own `make_local_mesh` builds Explicit axes on
this jax, under which `constrain` asserts): the explicit-TP FFN at (4, 2),
the expert-parallel MoE at (4, 2) and (2, 2) at capacity 1.25, the
weights-stationary decode MoE at (4, 2), the MoE's gradients at (2, 2)
and (1, 1), three train steps of tinyllama and deepseek (smoke configs,
f32 parameters, microbatches 2, int8 compression) at (2, 2), and a
checkpoint of a placed training state written at (4, 2). `restore` reads
a checkpoint onto (4, 2) and writes its leaves. `serve` places a sharded
index over the graphs of tests/mesh_workers.py `write_graphs` on (4, 2)
(the segment axis over 'data') and writes what its service's `serve`
returns for the mixed-p requests of tests/mesh_workers.py. `layouts`
(tests/test_torch_layouts.py) reads tests/mesh_workers.py
`write_layout_inputs`' cases and writes, on (4, 2), each one's loss, every
leaf's gradient and its full forward's logits over the decode tokens.
"""

from __future__ import annotations

import sys
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.checkpoint.store import restore_checkpoint, save_checkpoint
from repro.configs.base import get_arch
from repro.data.pipeline import SyntheticTokenPipeline
from repro.dist.sharding import Runtime, set_mesh, spec_shardings
from repro.models import ffn
from repro.models import params as rparams
from repro.optim.adamw import adamw_init
from repro.train import step as rstep
from repro.train.compression import compression_init

MOE_CASES = {"deepseek": ("deepseek_v3_671b", "mla+moe"),
             "llama4": ("llama4_scout_17b_a16e", "gqa+moe")}
TRAIN_ARCHS = ("tinyllama_1_1b", "deepseek_v3_671b")
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_MB = 8, 32, 3, 2
CKPT_ARCH = "tinyllama_1_1b"


def mesh(shape):
    return jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def capacity(cfg, factor: float):
    return cfg.with_overrides(moe=replace(cfg.moe, capacity_factor=factor))


def tree_of(inp, prefix: str, specs, bf16: bool = False):
    """The inputs' prefix/i leaves as the spec tree's structure (leaves in
    `jax.tree.leaves`' order), as jax arrays (bf16 from their bits)."""
    treedef = jax.tree.structure(rparams._map_specs(lambda s: 0, specs))
    arrays = [np.array(inp[f"{prefix}/{i}"]) for i in range(treedef.num_leaves)]
    if bf16:
        arrays = [a.view(jnp.bfloat16) for a in arrays]
    return jax.tree.unflatten(treedef, [jnp.asarray(a) for a in arrays])


def run_moe(inp, out: dict) -> None:
    for name, (arch, kind) in MOE_CASES.items():
        cfg = capacity(get_arch(arch, smoke=True), 1.25)
        p = tree_of(inp, f"moe_params/{name}", rparams.block_specs(cfg, kind)["channel"])
        x, xd, ct = (np.array(inp[f"{k}/{name}"]) for k in ("moe_x", "moe_xd", "moe_ct"))
        # drop-free capacity for the gradients: (2, 2) and (1, 1) then
        # compute the same function, whatever the dp shards' capacities
        free = capacity(cfg, cfg.moe.num_experts / cfg.moe.top_k)
        for shape in ((4, 2), (2, 2), (1, 1)):
            m = mesh(shape)
            rt = Runtime(mesh=m)
            tag = f"{shape[0]}x{shape[1]}"
            with set_mesh(m):
                fwd = jax.jit(lambda pp, xx, rt=rt: ffn.moe_forward(pp, xx, cfg, rt))
                out[f"moe_out/{name}/{tag}"] = np.asarray(fwd(p, jnp.asarray(x)))
                if shape != (4, 2):
                    g = jax.jit(jax.grad(lambda pp, xx, rt=rt: jnp.sum(
                        ffn.moe_forward(pp, xx, free, rt) * ct), argnums=(0, 1)))(
                        p, jnp.asarray(x))
                    for i, leaf in enumerate(jax.tree.leaves(g)):
                        out[f"moe_grad/{name}/{tag}/{i}"] = np.asarray(leaf)
                if shape == (4, 2):
                    rtd = Runtime(mesh=m, moe_decode_gather=True)
                    dec = jax.jit(lambda pp, xx: ffn.moe_forward(pp, xx, cfg, rtd))
                    out[f"moe_dec/{name}/{tag}"] = np.asarray(dec(p, jnp.asarray(xd)))


def run_tp(inp, out: dict) -> None:
    cfg = get_arch("tinyllama_1_1b", smoke=True)
    p = tree_of(inp, "tp_params", rparams.block_specs(cfg, "gqa+ffn")["channel"])
    m = mesh((4, 2))
    rt = Runtime(mesh=m, explicit_tp=True)
    with set_mesh(m):
        y = jax.jit(lambda pp, xx: ffn.ffn_forward(pp, xx, cfg, rt))(p, jnp.asarray(inp["tp_x"]))
    out["tp_out/4x2"] = np.asarray(y)


def split(batch: dict, mb: int) -> dict:
    return {k: a.reshape(mb, a.shape[0] // mb, *a.shape[1:]) for k, a in batch.items()}


def run_train(inp, out: dict) -> None:
    m = mesh((2, 2))
    for arch in TRAIN_ARCHS:
        cfg = get_arch(arch, smoke=True)
        rt = Runtime(mesh=m)
        tc = rstep.TrainConfig(lr=3e-3, warmup_steps=1, total_steps=9, microbatches=TRAIN_MB,
                               grad_compression=True)
        pipe = SyntheticTokenPipeline(cfg, TRAIN_B, TRAIN_S, seed=2)
        with set_mesh(m):
            params = tree_of(inp, f"train_init/{arch}", rparams.param_specs(cfg))
            state = {"params": params, "opt": adamw_init(params),
                     "err": compression_init(params)}
            shard = spec_shardings(rparams.param_specs(cfg), rt)
            state["params"] = jax.device_put(state["params"], shard)
            fn = jax.jit(rstep.make_train_step(cfg, rt, tc))
            rep = NamedSharding(m, P())
            losses, norms = [], []
            for step in range(TRAIN_STEPS):
                batch = jax.device_put(split(pipe.batch(step), TRAIN_MB), rep)
                state, metrics = fn(state, batch)
                losses.append(float(metrics["loss"]))
                norms.append(float(metrics["grad_norm"]))
        out[f"train_loss/{arch}"] = np.array(losses)
        out[f"train_gnorm/{arch}"] = np.array(norms)


def run_ckpt(inp, directory: str) -> None:
    """The inputs' bf16 tinyllama smoke parameters placed at (4, 2), written."""
    m = mesh((4, 2))
    cfg = get_arch(CKPT_ARCH, smoke=True)
    rt = Runtime(mesh=m)
    specs = rparams.param_specs(cfg)
    with set_mesh(m):
        params = jax.device_put(tree_of(inp, "ckpt_params", specs, bf16=True),
                                spec_shardings(specs, rt))
        save_checkpoint(directory, 5, {"params": params})


def restore(directory: str, path: str) -> None:
    """A checkpoint of a tinyllama smoke {"params"} restored onto (4, 2)."""
    m = mesh((4, 2))
    cfg = get_arch(CKPT_ARCH, smoke=True)
    rt = Runtime(mesh=m)
    specs = rparams.param_specs(cfg)
    skeleton = {"params": rparams._map_specs(lambda s: None, specs)}
    with set_mesh(m):
        tree, step = restore_checkpoint(directory, skeleton,
                                        {"params": spec_shardings(specs, rt)})
    out = {"step": np.array(step)}
    for i, leaf in enumerate(jax.tree.leaves(tree["params"])):
        a = np.asarray(leaf)
        out[f"leaf/{i}"] = a.view(np.uint16) if a.dtype == jnp.bfloat16 else a
        out[f"shards/{i}"] = np.array(len(leaf.sharding.device_set))
    np.savez(path, **out)


# tests/mesh_workers.py's index constants and requests
INDEX_T, INDEX_K = 150, 10
INDEX_MIXED = np.array([0.5, 0.8, 1.0, 1.25, 1.5, 2.0, 0.6, 1.7] * 3, np.float32)


def run_serve(graphs: str, path: str) -> None:
    from repro.core.build import HNSWGraph
    from repro.core.uhnsw import UHNSWParams
    from repro.index import SegmentedGraphs, ShardedParams, ShardedUHNSW
    from repro.retrieval.engine import ManualClock
    from repro.retrieval.service import QueryRequest, UniversalVectorService

    npz = np.load(graphs)

    def graph(pre: str) -> HNSWGraph:
        n_lvl = sum(1 for k in npz.files if k.startswith(f"{pre}/adjacency/"))
        entry, top, m, m0 = (int(v) for v in npz[f"{pre}/meta"])
        return HNSWGraph(metric_p=float(npz[f"{pre}/metric_p"]), m=m, m0=m0,
                         ef_construction=0, entry_point=entry, max_level=top,
                         adjacency=[npz[f"{pre}/adjacency/{i}"] for i in range(n_lvl)],
                         level_nodes=[npz[f"{pre}/level_nodes/{i}"] for i in range(n_lvl)],
                         local_index=[npz[f"{pre}/local_index/{i}"] for i in range(n_lvl)],
                         data=npz[f"{pre}/data"], levels=npz[f"{pre}/levels"])

    n = int(npz["n_seg"])
    segs = SegmentedGraphs(graphs1=[graph(f"g1/{s}") for s in range(n)],
                           graphs2=[graph(f"g2/{s}") for s in range(n)],
                           global_ids=[np.array(npz[f"ids/{s}"]) for s in range(n)])
    idx = ShardedUHNSW(segs, np.array(npz["data"]), params=UHNSWParams(t=INDEX_T),
                       delta_capacity=16,
                       sharded_params=ShardedParams(policy="two_phase", probe=2))
    rt = Runtime(mesh=mesh((4, 2)))
    reqs = [QueryRequest(vector=q, p=float(INDEX_MIXED[i % len(INDEX_MIXED)]), k=INDEX_K,
                         request_id=i) for i, q in enumerate(np.array(npz["queries"]))]
    with set_mesh(rt.mesh):
        idx.shard_over(rt)
        res = UniversalVectorService(index=idx, clock=ManualClock()).serve(reqs)
    out = {}
    for i in sorted(res):
        out[f"serve/{i}/ids"], out[f"serve/{i}/dists"] = (np.asarray(a) for a in res[i])
    np.savez(path, **out)


# tests/mesh_workers.py's layout cases
LAYOUT_CASES = {
    "gqa": ("tinyllama_1_1b", {}),
    "tied": ("tinyllama_1_1b", {"tie_embeddings": True}),
    "rglru_local": ("recurrentgemma_2b", {}),
    "mla_moe": ("deepseek_v3_671b", {"capacity": "free"}),
    "gqa_moe": ("llama4_scout_17b_a16e", {"capacity": "free"}),
    "ssd": ("mamba2_1_3b", {}),
}


def layout_cfg(case: str):
    arch, over = LAYOUT_CASES[case]
    over = dict(over)
    cfg = get_arch(arch, smoke=True)
    if over.pop("capacity", None):
        over["moe"] = replace(cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k)
    return cfg.with_overrides(**over)


def run_layouts(inputs: str, path: str) -> None:
    from repro.models import model as rmodel

    inp = np.load(inputs)
    m = mesh((4, 2))
    rt = Runtime(mesh=m)
    out = {}
    for case in LAYOUT_CASES:
        cfg = layout_cfg(case)
        specs = rparams.param_specs(cfg)
        batch = {k: jnp.asarray(inp[f"{case}/{k}"]) for k in ("tokens", "labels")}
        with set_mesh(m):
            params = jax.device_put(tree_of(inp, f"{case}/params", specs),
                                    spec_shardings(specs, rt))
            (loss, _), grads = jax.jit(jax.value_and_grad(
                lambda p, b, cfg=cfg: rmodel.loss_fn(p, b, cfg, rt), has_aux=True))(params, batch)
            logits = jax.jit(lambda p, t, cfg=cfg: jnp.einsum(
                "bsd,dv->bsv", rmodel.forward_train(p, {"tokens": t}, cfg, rt),
                rmodel._head_matrix(p, cfg)))(params, jnp.asarray(inp[f"{case}/dec_tokens"]))
        out[f"{case}/loss"] = np.asarray(loss)
        for i, g in enumerate(jax.tree.leaves(grads)):
            out[f"{case}/grad/{i}"] = np.asarray(g)
        out[f"{case}/logits"] = np.asarray(logits)
    np.savez(path, **out)


def main(argv) -> int:
    if jax.device_count() < 8:
        raise SystemExit("needs 8 devices: set XLA_FLAGS=--xla_force_host_platform_device_count=8")
    if argv[0] == "run":
        inp = np.load(argv[1])
        out: dict = {}
        run_ckpt(inp, argv[3])
        run_tp(inp, out)
        run_moe(inp, out)
        run_train(inp, out)
        np.savez(argv[2], **out)
        return 0
    if argv[0] == "restore":
        restore(argv[1], argv[2])
        return 0
    if argv[0] == "serve":
        run_serve(argv[1], argv[2])
        return 0
    if argv[0] == "layouts":
        run_layouts(argv[1], argv[2])
        return 0
    raise SystemExit(f"unknown mode {argv[0]}")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
