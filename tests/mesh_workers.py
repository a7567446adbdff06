"""The port's multi-rank checks, run by tests/test_torch_mesh.py on gloo
ranks (one `torch.multiprocessing` spawn per mesh shape).

Each worker joins a gloo group over a file store, builds its meshes with
`repro_torch.launch.mesh.make_local_mesh`, runs the port on the
reference's inputs (tests/mesh_reference.py's npz) and writes what it
computed to `out_dir/rank<r>.npz`; the test compares. This module imports
torch and the port only: every rank imports it afresh.
"""

from __future__ import annotations

import os
import time
from dataclasses import replace
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.store import restore_checkpoint, save_checkpoint
from repro_torch.configs.base import get_arch
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.dist.sharding import Runtime, distribute_params, full
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import ffn
from repro_torch.models.params import _map_specs, block_specs, param_specs
from repro_torch.train.step import TrainConfig, make_train_step, train_state_specs
from repro_torch.tree import leaves, unflatten

MOE_CASES = {"deepseek": ("deepseek_v3_671b", "mla+moe"),
             "llama4": ("llama4_scout_17b_a16e", "gqa+moe")}
MOE_B, MOE_S = 8, 16
TP_B, TP_S = 8, 4
TRAIN_ARCHS = ("tinyllama_1_1b", "deepseek_v3_671b")
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_MB = 8, 32, 3, 2
GROUP_TIMEOUT = timedelta(seconds=120)


def _flat(out: dict, prefix: str, tree) -> None:
    for i, leaf in enumerate(leaves(tree)):
        out[f"{prefix}/{i}"] = (leaf.view(torch.int16).numpy().view(np.uint16)
                                if leaf.dtype == torch.bfloat16 else leaf.numpy())


def _block(cfg, kind: str, seed: int) -> dict:
    """One layer's channel weights of `kind`, f32, from init_params' rules."""
    from repro_torch.models.params import _init_leaf

    gen = torch.Generator().manual_seed(seed)
    return _map_specs(lambda s: _init_leaf(replace(s, dtype=torch.float32), gen, "cpu"),
                      block_specs(cfg, kind)["channel"])


def _skewed(b: int, s: int, d: int, seed: int) -> np.ndarray:
    """Normal draws plus a shared offset, which skews the routing so that
    experts overflow at 1.25 (tests/test_torch_moe.py's inputs)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, d)) + rng.normal(size=d)).astype(np.float32)


def write_inputs(path: str) -> None:
    """Both packages' inputs, made by the port from seeds: the FFN and MoE
    layers' f32 weights, their activations and cotangents, the training
    archs' f32 initial parameters, and bf16 tinyllama parameters for the
    checkpoints (leaves in `jax.tree.leaves`' order, bf16 as bits)."""
    from repro_torch.models.model import init_params

    out: dict = {}
    cfg = _cfg("tinyllama_1_1b")
    _flat(out, "tp_params", _block(cfg, "gqa+ffn", 7))
    out["tp_x"] = np.random.default_rng(8).normal(size=(TP_B, TP_S, cfg.d_model)).astype(
        np.float32)
    out["tp_ct"] = np.random.default_rng(11).normal(size=out["tp_x"].shape).astype(np.float32)
    for name, (arch, kind) in MOE_CASES.items():
        cfg = _cfg(arch)
        _flat(out, f"moe_params/{name}", _block(cfg, kind, 3))
        out[f"moe_x/{name}"] = _skewed(MOE_B, MOE_S, cfg.d_model, 4)
        out[f"moe_xd/{name}"] = _skewed(MOE_B, 1, cfg.d_model, 5)
        out[f"moe_ct/{name}"] = np.random.default_rng(6).normal(
            size=(MOE_B, MOE_S, cfg.d_model)).astype(np.float32)
    for arch in TRAIN_ARCHS:
        _flat(out, f"train_init/{arch}", init_params(
            _cfg(arch), torch.Generator().manual_seed(3), dtype=torch.float32, device="cpu"))
    _flat(out, "ckpt_params", init_params(_cfg("tinyllama_1_1b"),
                                          torch.Generator().manual_seed(9), device="cpu"))
    np.savez(path, **out)


class Ranks:
    """fn(rank, nprocs, store_path, *args) on nprocs spawned ranks, started
    at once; `wait()` joins them, failing (and killing them) past timeout
    seconds from the start."""

    def __init__(self, fn, nprocs: int, *args, timeout: float = 150.0):
        import tempfile

        import torch.multiprocessing as mp

        store = os.path.join(tempfile.mkdtemp(prefix="mesh_store_"), "store")
        self.name, self.nprocs = fn.__name__, nprocs
        self.deadline = time.monotonic() + timeout
        self.ctx = mp.start_processes(fn, args=(nprocs, store, *args), nprocs=nprocs,
                                      join=False, start_method="spawn")

    def wait(self) -> None:
        try:
            while not self.ctx.join(timeout=max(self.deadline - time.monotonic(), 0.1)):
                if time.monotonic() > self.deadline:
                    raise TimeoutError(f"{self.name} on {self.nprocs} ranks timed out")
        finally:
            for p in self.ctx.processes:
                if p.is_alive():
                    p.kill()


def spawn(fn, nprocs: int, *args, timeout: float = 150.0) -> None:
    Ranks(fn, nprocs, *args, timeout=timeout).wait()


def _join(rank: int, world: int, store: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=GROUP_TIMEOUT)


def _cfg(arch: str, factor: float | None = None):
    cfg = get_arch(arch, smoke=True)
    if factor is not None:
        cfg = cfg.with_overrides(moe=replace(cfg.moe, capacity_factor=factor))
    return cfg


def _tree(inp, prefix: str, skeleton):
    """The npz's prefix/i leaves as the skeleton's tree (f32 tensors)."""
    n = len(leaves(skeleton))
    return unflatten(skeleton, [torch.from_numpy(np.array(inp[f"{prefix}/{i}"]))
                                for i in range(n)])


def _rows(x: torch.Tensor, rt: Runtime) -> torch.Tensor:
    n = x.shape[0] // rt.dp_size
    return x[rt.dp_rank * n:(rt.dp_rank + 1) * n]


def _gather(x: torch.Tensor, rt: Runtime) -> torch.Tensor:
    from repro_torch.dist import comm

    return comm.all_gather(x.contiguous(), rt, rt.dp_axes, 0)


def _grads(fn, params: dict, x: torch.Tensor, ct: torch.Tensor, rt: Runtime | None,
           placed: dict | None = None):
    """d sum(fn(params, x) * ct) on full parameter leaves and this rank's
    rows. On a mesh the parameters' gradients are reduced as the train step
    reduces them (`_reduce_grads` onto `placed`'s shards) and gathered
    whole; x's rows are gathered."""
    live = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    xs = x.detach().clone().requires_grad_()
    with torch.enable_grad():
        out = fn(live, xs)
        gx, *gp = torch.autograd.grad((out * ct).sum(), [xs, *live.values()])
    if rt is None:
        return gx, dict(zip(live, gp))
    gp = [full(g) for g in reduce_full_grads(gp, [placed[k] for k in live], rt)]
    return _gather(gx, rt), dict(zip(live, gp))


def reduce_full_grads(grads: list, params: list, rt: Runtime) -> list:
    """Whole per-rank gradients (of weights passed whole) -> each
    parameter's shard of their sum over dp, as DTensors placed like the
    parameters: a reduce-scatter back to the shards of the leaves sharded
    over dp, an all-reduce for the rest; each rank keeps its window of
    the dims sharded over 'model'."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.dist import comm
    from repro_torch.dist.sharding import mesh_names, window

    names = mesh_names(rt.mesh)
    dp = set(rt.dp_axes)
    out = []
    for g, p in zip(grads, params):
        pl = p.placements
        rep = tuple(a for a, q in zip(names, pl) if a in dp and not isinstance(q, Shard))
        if rep:
            g = comm.all_reduce(g, rt, rep)
        by_dim: dict[int, list[str]] = {}
        for a, q in zip(names, pl):
            if isinstance(q, Shard) and a in dp:
                by_dim.setdefault(q.dim, []).append(a)
        for dim, axes in by_dim.items():
            g = comm.reduce_scatter(g, rt, tuple(axes), dim)
        spec = [None] * g.dim()
        for a, q in zip(names, pl):
            if isinstance(q, Shard) and a not in dp:
                spec[q.dim] = a
        g = g[window(tuple(g.shape), tuple(spec), rt)]
        out.append(DTensor.from_local(g.contiguous(), p.device_mesh, pl, run_check=False,
                                      shape=p.shape, stride=p.stride()))
    return out


def _save_grads(out: dict, tag: str, gx, gp: dict) -> None:
    out[f"{tag}/x"] = gx.numpy()
    for k, v in gp.items():
        out[f"{tag}/{k}"] = v.numpy()


def work_4x2(rank: int, world: int, store: str, inputs: str, out_dir: str) -> None:
    """(4, 2): the explicit-TP FFN, the MoE, the decode MoE and their
    gradients."""
    _join(rank, world, store)
    inp = np.load(inputs)
    mesh = make_local_mesh(4, 2, device="cpu")
    out: dict = {}

    # explicit TP
    cfg = _cfg("tinyllama_1_1b")
    spec = block_specs(cfg, "gqa+ffn")["channel"]
    chan = _tree(inp, "tp_params", spec)
    rt = Runtime(mesh=mesh, explicit_tp=True)
    placed = distribute_params(chan, spec, rt)
    x = torch.from_numpy(inp["tp_x"])
    with torch.no_grad():
        out["tp_out"] = _gather(ffn.ffn_forward(placed, _rows(x, rt), cfg, rt), rt).numpy()
    ct = torch.from_numpy(inp["tp_ct"])
    gx, gp = _grads(lambda p, xx: ffn.ffn_forward(p, xx, cfg, rt), chan, _rows(x, rt),
                    _rows(ct, rt), rt, placed)
    _save_grads(out, "tp_grad", gx, gp)

    # MoE at 1.25, the decode MoE, gradients at 1.25 and through the decode
    for name, (arch, kind) in MOE_CASES.items():
        cfg = _cfg(arch, 1.25)
        spec = block_specs(cfg, kind)["channel"]
        chan = _tree(inp, f"moe_params/{name}", spec)
        rt = Runtime(mesh=mesh)
        placed = distribute_params(chan, spec, rt)
        x = torch.from_numpy(inp[f"moe_x/{name}"])
        xd = torch.from_numpy(inp[f"moe_xd/{name}"])
        rtd = Runtime(mesh=mesh, moe_decode_gather=True)
        with torch.no_grad():
            out[f"moe_out/{name}"] = _gather(
                ffn.moe_forward(placed, _rows(x, rt), cfg, rt), rt).numpy()
            out[f"moe_dec/{name}"] = _gather(
                ffn.moe_forward(placed, _rows(xd, rtd), cfg, rtd), rtd).numpy()
        ct = torch.from_numpy(inp[f"moe_ct/{name}"])
        gx, gp = _grads(lambda p, xx: ffn.moe_forward(p, xx, cfg, rt), chan, _rows(x, rt),
                        _rows(ct, rt), rt, placed)
        _save_grads(out, f"moe_grad/{name}", gx, gp)
        ctd = ct[:, :1].contiguous()
        gx, gp = _grads(lambda p, xx: ffn.moe_forward(p, xx, cfg, rtd), chan, _rows(xd, rtd),
                        _rows(ctd, rtd), rtd, placed)
        _save_grads(out, f"moe_dec_grad/{name}", gx, gp)
    if rank == 0:
        np.savez(os.path.join(out_dir, "rank0.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


def _split(batch: dict, mb: int) -> dict:
    return {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:]) for k, v in batch.items()}


def _state(inp, arch: str, tc: TrainConfig, rt: Runtime | None) -> dict:
    """The reference's initial f32 state (npz train_init), placed by its
    specs on rt's mesh (or whole, off a mesh)."""
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.compression import compression_init

    specs = train_state_specs(_cfg(arch), tc)
    params = _tree(inp, f"train_init/{arch}", specs["params"])
    state = {"params": params, "opt": adamw_init(params), "err": compression_init(params)}
    if rt is None or not rt.distributed:
        return state
    return place_state(state, specs, rt)


def place_state(state: dict, specs: dict, rt: Runtime) -> dict:
    out = {"params": distribute_params(state["params"], specs["params"], rt),
           "opt": {"m": distribute_params(state["opt"]["m"], specs["opt"]["m"], rt),
                   "v": distribute_params(state["opt"]["v"], specs["opt"]["v"], rt),
                   "step": state["opt"]["step"]}}
    if "err" in state:
        out["err"] = distribute_params(state["err"], specs["err"], rt)
    return out


def _steps(cfg, rt, tc, state, first: int, n: int):
    fn = make_train_step(cfg, rt, tc)
    pipe = SyntheticTokenPipeline(cfg, TRAIN_B, TRAIN_S, seed=2, device="cpu")
    losses, norms = [], []
    for step in range(first, first + n):
        state, m = fn(state, _split(pipe.batch(step), tc.microbatches))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return state, losses, norms


TC = TrainConfig(lr=3e-3, warmup_steps=1, total_steps=9, microbatches=TRAIN_MB,
                 grad_compression=True)


def work_2x2(rank: int, world: int, store: str, inputs: str, out_dir: str,
             ref_ckpt: str) -> None:
    """(2, 2) and the other 4-rank meshes: the MoE, training against the
    reference, full_dp and seq_shard, the elastic restore, and the
    checkpoints that cross packages."""
    _join(rank, world, store)
    inp = np.load(inputs)
    m22 = make_local_mesh(2, 2, device="cpu")
    out: dict = {}
    for name, (arch, kind) in MOE_CASES.items():
        cfg = _cfg(arch, 1.25)
        spec = block_specs(cfg, kind)["channel"]
        rt = Runtime(mesh=m22)
        placed = distribute_params(_tree(inp, f"moe_params/{name}", spec), spec, rt)
        x = torch.from_numpy(inp[f"moe_x/{name}"])
        with torch.no_grad():
            out[f"moe_out/{name}"] = _gather(
                ffn.moe_forward(placed, _rows(x, rt), cfg, rt), rt).numpy()

    # three steps against the reference's (2, 2) run
    for arch in TRAIN_ARCHS:
        rt = Runtime(mesh=m22)
        _, losses, norms = _steps(_cfg(arch), rt, TC, _state(inp, arch, TC, rt), 0, TRAIN_STEPS)
        out[f"train_loss/{arch}"], out[f"train_gnorm/{arch}"] = losses, norms
    # full_dp and seq_shard on (2, 2)
    arch = "tinyllama_1_1b"
    for mode in ("full_dp", "seq_shard"):
        rt = Runtime(mesh=m22, **{mode: True})
        _, losses, norms = _steps(_cfg(arch), rt, TC, _state(inp, arch, TC, rt), 0, TRAIN_STEPS)
        out[f"{mode}_loss"], out[f"{mode}_gnorm"] = losses, norms

    # elastic: steps 0-2 on (2, 2), a checkpoint, then steps 3-5 on (2, 2),
    # (4, 1), (1, 4) and off the mesh from it
    cfg = _cfg(arch)
    rt = Runtime(mesh=m22)
    state, _, _ = _steps(cfg, rt, TC, _state(inp, arch, TC, rt), 0, TRAIN_STEPS)
    ck = os.path.join(out_dir, "elastic")
    save_checkpoint(ck, TRAIN_STEPS - 1, state)
    _, out["elastic/2x2"], _ = _steps(cfg, rt, TC, state, TRAIN_STEPS, TRAIN_STEPS)
    specs = train_state_specs(cfg, TC)
    for shape in ((4, 1), (1, 4)):
        rt2 = Runtime(mesh=make_local_mesh(*shape, device="cpu"))
        st, step = restore_checkpoint(ck, specs, rt2)
        assert step == TRAIN_STEPS - 1
        _, out[f"elastic/{shape[0]}x{shape[1]}"], _ = _steps(cfg, rt2, TC, st, TRAIN_STEPS,
                                                             TRAIN_STEPS)
    st, _ = restore_checkpoint(ck, specs, "cpu")
    _, out["elastic/none"], _ = _steps(cfg, Runtime(), TC, st, TRAIN_STEPS, TRAIN_STEPS)

    # the reference's (4, 2) checkpoint (ref_ckpt, once it is written) onto
    # (2, 2) and off the mesh; then those params written by the 4 ranks for
    # the reference to read
    deadline = time.monotonic() + 120
    while not os.path.exists(os.path.join(ref_ckpt, "step_00000005", "manifest.json")):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no reference checkpoint under {ref_ckpt}")
        time.sleep(0.2)
    pspecs = {"params": _map_specs(lambda s: s, param_specs(_cfg("tinyllama_1_1b")))}
    on_mesh, step = restore_checkpoint(ref_ckpt, pspecs, rt)
    off, _ = restore_checkpoint(ref_ckpt, pspecs, "cpu")
    out["ckpt_step"] = step
    for i, (a, b) in enumerate(zip(leaves(on_mesh), leaves(off))):
        a = full(a)
        out[f"ckpt_mesh/{i}"] = a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 \
            else a.numpy()
        out[f"ckpt_off/{i}"] = b.view(torch.int16).numpy() if b.dtype == torch.bfloat16 \
            else b.numpy()
    save_checkpoint(os.path.join(out_dir, "port_ckpt"), 7, {"params": on_mesh["params"]})
    if rank == 0:
        np.savez(os.path.join(out_dir, "rank0.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()



# ---------------------------------------------------------------------------
# the sharded index placed over the mesh (tests/test_torch_mesh_index.py)
# ---------------------------------------------------------------------------

INDEX_POLICIES = {"independent": {}, "two_phase": {"probe": 2}, "round_robin": {"probe": 2}}
INDEX_P = (0.5, 1.25, 2.0, "mixed")
INDEX_MIXED = np.array([0.5, 0.8, 1.0, 1.25, 1.5, 2.0, 0.6, 1.7] * 3, np.float32)
INDEX_T, INDEX_K = 150, 10
STATS = ("n_b", "n_b_probe", "n_b_spill", "n_p", "hops")


def write_graphs(path: str, segments, data: np.ndarray, queries: np.ndarray) -> None:
    """A reference SegmentedGraphs' graphs (both base metrics), ids, corpus
    and queries, for the ranks to carry across."""
    out = {"data": data, "queries": queries, "n_seg": np.array(len(segments.graphs1))}
    for s, (g1, g2) in enumerate(zip(segments.graphs1, segments.graphs2)):
        out[f"ids/{s}"] = segments.global_ids[s]
        for tag, g in (("g1", g1), ("g2", g2)):
            pre = f"{tag}/{s}"
            for name in ("adjacency", "level_nodes", "local_index"):
                for lvl, a in enumerate(getattr(g, name)):
                    out[f"{pre}/{name}/{lvl}"] = np.asarray(a)
            out[f"{pre}/levels"] = np.asarray(g.levels)
            out[f"{pre}/data"] = np.asarray(g.data)
            out[f"{pre}/meta"] = np.array([g.entry_point, g.max_level, g.m, g.m0], np.int64)
            out[f"{pre}/metric_p"] = np.array(g.metric_p, np.float64)
    np.savez(path, **out)


def _graph(npz, pre: str):
    from repro_torch.convert import graph_from_reference

    n_lvl = sum(1 for k in npz.files if k.startswith(f"{pre}/adjacency/"))
    entry, top, m, m0 = (int(v) for v in npz[f"{pre}/meta"])
    return graph_from_reference(
        [npz[f"{pre}/adjacency/{i}"] for i in range(n_lvl)],
        [npz[f"{pre}/level_nodes/{i}"] for i in range(n_lvl)],
        [npz[f"{pre}/local_index/{i}"] for i in range(n_lvl)],
        entry, top, npz[f"{pre}/levels"], npz[f"{pre}/data"], float(npz[f"{pre}/metric_p"]),
        m, m0, device="cpu")


def make_index(npz, policy: str, delta_capacity: int = 16):
    """A fresh port ShardedUHNSW over the npz's segments."""
    from repro_torch.core.uhnsw import UHNSWParams
    from repro_torch.index import SegmentedGraphs, ShardedParams, ShardedUHNSW

    n = int(npz["n_seg"])
    segs = SegmentedGraphs(graphs1=[_graph(npz, f"g1/{s}") for s in range(n)],
                           graphs2=[_graph(npz, f"g2/{s}") for s in range(n)],
                           global_ids=[np.array(npz[f"ids/{s}"]) for s in range(n)])
    return ShardedUHNSW(segs, np.array(npz["data"]), params=UHNSWParams(t=INDEX_T),
                        delta_capacity=delta_capacity,
                        sharded_params=ShardedParams(policy=policy, **INDEX_POLICIES[policy]))


def index_searches(idx, Q: np.ndarray, tag: str, out: dict, ps=INDEX_P) -> None:
    for p in ps:
        pv = INDEX_MIXED if p == "mixed" else p
        ids, d, st = idx.search(torch.from_numpy(Q), pv, INDEX_K)
        out[f"{tag}/{p}/ids"], out[f"{tag}/{p}/dists"] = ids.numpy(), d.numpy()
        for name in STATS:
            out[f"{tag}/{p}/{name}"] = np.asarray(getattr(st, name))


def compact_vectors(data: np.ndarray) -> np.ndarray:
    rng = np.random.default_rng(5)
    return (data.mean(0) + 6.0 * rng.standard_normal((16, data.shape[1]))).astype(np.float32)


def index_paths(idx_for, npz, out: dict, snap_dir: str | None) -> None:
    """Every check's searches on indexes made by idx_for(policy): the three
    policies, after a compaction (5 segments), after a poisoned segment's
    restore, and the service's grouped serving."""
    from repro_torch.index.persist import restore_segment, save_snapshot
    from repro_torch.retrieval.engine.faults import poison_segment

    Q = np.array(npz["queries"])
    for policy in INDEX_POLICIES:
        index_searches(idx_for(policy), Q, policy, out)
    idx = idx_for("independent")
    for v in compact_vectors(np.array(npz["data"])):
        idx.add(v)                     # the 16th add compacts: 5 segments
    out["compacted/n_seg"] = np.array(idx.num_segments)
    out["compacted/placed"] = np.array(idx._place is not None)
    index_searches(idx, Q, "compacted", out, (0.5, "mixed"))
    if snap_dir is not None:
        idx = idx_for("two_phase")
        if not dist.is_initialized() or dist.get_rank() == 0:
            save_snapshot(idx, snap_dir)
        if dist.is_initialized():
            dist.barrier()
        poison_segment(idx, 1)
        out["restored/ok"] = np.array(restore_segment(idx, 1, snap_dir))
        index_searches(idx, Q, "restored", out, (1.25, "mixed"))


def _requests(Q: np.ndarray):
    from repro_torch.retrieval.service import QueryRequest

    return [QueryRequest(vector=q, p=float(INDEX_MIXED[i % len(INDEX_MIXED)]), k=INDEX_K,
                         request_id=i) for i, q in enumerate(Q)]


def service_results(svc, Q: np.ndarray, out: dict, tag: str) -> None:
    res = svc.serve_grouped(_requests(Q))
    for i in sorted(res):
        out[f"{tag}/{i}/ids"], out[f"{tag}/{i}/dists"] = (np.asarray(a) for a in res[i])


SERVICE_N = 1000


def work_index(rank: int, world: int, store: str, graphs: str, out_dir: str,
               snap_dir: str) -> None:
    """shard_over on `world` ranks over the npz's 4 segments."""
    from repro_torch.retrieval.service import UniversalVectorService

    _join(rank, world, store)
    npz = np.load(graphs)
    rt = Runtime(mesh=make_local_mesh(world, 1, device="cpu"))
    out: dict = {}
    placed = make_index(npz, "independent").shard_over(rt)
    out["placed/axis"] = np.array(placed._place is not None)
    out["placed/held"] = np.array(placed.segments.held)
    out["placed/stack_rows"] = np.array([placed.segments.X.shape[0],
                                         placed.segments.arrays1.adj0.shape[0],
                                         placed.segments.arrays2.adj0.shape[0],
                                         placed.segments.node_ids.shape[0], placed.X.shape[0]])
    index_paths(lambda policy: make_index(npz, policy).shard_over(rt), npz, out, snap_dir)
    data = np.array(npz["data"])[:SERVICE_N]
    svc = UniversalVectorService.build(data, num_segments=4, m=12, method="bulk", rt=rt,
                                       device="cpu")
    out["service/placed"] = np.array(svc.index._place is not None)
    service_results(svc, np.array(npz["queries"]), out, "service")
    mine: dict = {}
    serve_paths(lambda **kw: make_index(npz, "two_phase").shard_over(rt), npz, mine,
                os.path.join(snap_dir, "serve"))
    out.update(mine)
    # every rank's own serve results, for the every-rank-alike check
    np.savez(os.path.join(out_dir, f"serve_rank{rank}.npz"),
             **{k: v for k, v in mine.items() if k.endswith(("/ids", "/dists"))})
    if rank == 0:
        np.savez(os.path.join(out_dir, "rank0.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


SERVE_STATS = ("queries", "batches", "faults", "retries", "quarantine_splits", "failed",
               "poison_detected", "seg_quarantined", "seg_recovered")
SERVE_FAULTS = {"rate": 0.3, "seed": 3}


def _served(res: dict, out: dict, tag: str) -> None:
    for i in sorted(res):
        out[f"{tag}/{i}/ids"], out[f"{tag}/{i}/dists"] = (np.asarray(a) for a in res[i])


def serve_paths(index_for, npz, out: dict, snap_dir: str) -> None:
    """`UniversalVectorService.serve` under a ManualClock over indexes made
    by index_for(): the mixed-p requests clean, under injected transient
    faults (rank 0's injector), and around a poisoned segment (served at
    reduced coverage once it is quarantined, then restored from the
    snapshot and re-admitted by the next serve); with rank 0's stats."""
    from repro_torch.index.persist import DurableIndex
    from repro_torch.retrieval.engine import FaultInjector, ManualClock
    from repro_torch.retrieval.engine.faults import poison_segment
    from repro_torch.retrieval.service import UniversalVectorService

    reqs = _requests(np.array(npz["queries"]))

    def stats(svc, tag):
        for name in SERVE_STATS:
            out[f"{tag}/stats/{name}"] = np.array(svc.stats[name])

    svc = UniversalVectorService(index=index_for(), clock=ManualClock())
    _served(svc.serve(reqs), out, "serve/clean")
    stats(svc, "serve/clean")
    svc = UniversalVectorService(index=index_for(), clock=ManualClock(),
                                 fault_injector=FaultInjector(**SERVE_FAULTS))
    _served(svc.serve(reqs), out, "serve/faults")
    stats(svc, "serve/faults")
    out["serve/faults/failed_ids"] = np.array(sorted(svc.engine.take_failures()), np.int64)
    os.makedirs(snap_dir, exist_ok=True)
    dur = DurableIndex.create(index_for(), snap_dir, sync=False)
    if dist.is_initialized():
        dist.barrier()                 # rank 0 wrote the snapshot
    svc = UniversalVectorService(index=dur, clock=ManualClock())
    poison_segment(dur, 1)
    _served(svc.serve(reqs), out, "serve/poisoned")
    out["serve/poisoned/alive"] = np.array(dur.health.alive())
    _served(svc.serve(reqs), out, "serve/restored")
    out["serve/restored/alive"] = np.array(dur.health.alive())
    stats(svc, "serve/restored")


COST_ARCH, COST_B, COST_S, COST_MB = "tinyllama_1_1b", 8, 32, 2


def cost_step(rt: Runtime):
    """(step, state, batch) of the fake-against-real cost check: the smoke
    tinyllama's train step of COST_MB microbatches, its bf16 state from
    seed 3 and a token batch from seed 4, placed on rt's mesh as the
    dry-run's specs place them (`launch.specs`)."""
    from repro_torch.dist.sharding import place
    from repro_torch.train.step import init_train_state

    cfg = get_arch(COST_ARCH, smoke=True)
    tc = TrainConfig(microbatches=COST_MB)
    state = init_train_state(cfg, rt, tc, torch.Generator().manual_seed(3), device="cpu")
    gen = torch.Generator().manual_seed(4)
    shape = (COST_MB, COST_B // COST_MB, COST_S)
    batch = {k: place(torch.randint(0, cfg.vocab_size, shape, generator=gen,
                                    dtype=torch.int32), (None, "batch", None), rt)
             for k in ("labels", "tokens")}
    return make_train_step(cfg, rt, tc), state, batch


def work_cost(rank: int, world: int, store: str, out_dir: str) -> None:
    """One counted train step (`launch.op_cost.OpCost` on real tensors) on
    a (2, 2) gloo mesh; rank 0 writes its counts."""
    import json

    from repro_torch.launch.op_cost import OpCost

    _join(rank, world, store)
    rt = Runtime(mesh=make_local_mesh(2, 2, device="cpu"), remat=True)
    step, state, batch = cost_step(rt)
    cost = OpCost()
    cost.track(state, batch)
    with cost:
        step(state, batch)
    if rank == 0:
        with open(os.path.join(out_dir, "cost.json"), "w") as f:
            json.dump({"flops": cost.flops, "bytes": cost.bytes, "bytes_min": cost.bytes_min,
                       "collectives": cost.collectives, "ops": cost.ops}, f)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the sharded layouts (tests/test_torch_layouts.py)
# ---------------------------------------------------------------------------

# case -> (arch, overrides): every mixer kind, the MoE at a drop-free
# capacity (E / top_k: every mesh computes the same function), the tied
# and the untied heads, and deepseek's MTP head
LAYOUT_CASES = {
    "gqa": ("tinyllama_1_1b", {}),
    "tied": ("tinyllama_1_1b", {"tie_embeddings": True}),
    "rglru_local": ("recurrentgemma_2b", {}),
    "mla_moe": ("deepseek_v3_671b", {"capacity": "free"}),
    "gqa_moe": ("llama4_scout_17b_a16e", {"capacity": "free"}),
    "ssd": ("mamba2_1_3b", {}),
}
LAYOUT_MESHES = ((1, 2), (2, 2), (4, 2))
LAYOUT_B, LAYOUT_S = 4, 64          # the loss's batch
# prefill DEC_S0 tokens into caches of DEC_SMAX slots, then decode to
# DEC_END: the full caches' rank boundary is slot 24, the local-attention
# ring's (32 slots) slot 16, and the ring wraps at 32
DEC_S0, DEC_SMAX, DEC_END, DEC_FWD = 12, 48, 40, 48


def layout_cfg(case: str, get=get_arch):
    arch, over = LAYOUT_CASES[case]
    over = dict(over)
    cfg = get(arch, smoke=True)
    if over.pop("capacity", None):
        m = cfg.moe
        over["moe"] = replace(m, capacity_factor=m.num_experts / m.top_k)
    return cfg.with_overrides(**over)


def write_layout_inputs(path: str) -> None:
    """Each case's f32 parameters (init_params' rules, seed 11), its loss
    batch (tokens, labels with padding) and its decode tokens."""
    from repro_torch.models.model import init_params

    out: dict = {}
    for i, case in enumerate(LAYOUT_CASES):
        cfg = layout_cfg(case)
        _flat(out, f"{case}/params", init_params(cfg, torch.Generator().manual_seed(11 + i),
                                                 dtype=torch.float32, device="cpu"))
        rng = np.random.default_rng(20 + i)
        toks = rng.integers(0, cfg.vocab_size, size=(LAYOUT_B, LAYOUT_S + 1)).astype(np.int32)
        labels = toks[:, 1:].copy()
        labels[0, -7:] = -1
        out[f"{case}/tokens"], out[f"{case}/labels"] = toks[:, :-1], labels
        out[f"{case}/dec_tokens"] = rng.integers(0, cfg.vocab_size,
                                                 size=(LAYOUT_B, DEC_FWD)).astype(np.int32)
    np.savez(path, **out)


def layout_run(cfg, params, inp, case: str, rt: Runtime, out: dict, shapes: dict) -> None:
    """One case on rt: the loss and every leaf's gradient (the train step's
    `compute_grads`, summed over dp by `_reduce_grads`, gathered whole for
    the comparison), the prefill's logits and the decode's across the
    ranks' slot boundary; the local shapes of the weights, the gradients
    and the caches in `shapes`. Off a mesh the same calls (the baseline)."""
    from repro_torch.models.model import decode_step, head_logits, prefill
    from repro_torch.train.step import _reduce_grads

    batch = {"tokens": torch.from_numpy(np.array(inp[f"{case}/tokens"])),
             "labels": torch.from_numpy(np.array(inp[f"{case}/labels"]))}
    grads, metrics = make_train_step(cfg, rt, TrainConfig()).compute_grads(params, batch)
    grads = leaves(grads)
    if rt.distributed:
        shapes[f"{case}/param"] = [list(p.to_local().shape) for p in leaves(params)]
        grads = _reduce_grads(grads, leaves(params), rt)
        shapes[f"{case}/grad"] = [list(g.to_local().shape) for g in grads]
    out[f"{case}/loss"] = np.array(float(metrics["loss"]))
    for i, g in enumerate(grads):
        out[f"{case}/grad/{i}"] = full(g).numpy()
    toks = torch.from_numpy(np.array(inp[f"{case}/dec_tokens"]))
    with torch.no_grad():
        last, cache = prefill(params, {"tokens": toks[:, :DEC_S0]}, cfg, rt, s_max=DEC_SMAX)
        if rt.distributed:
            shapes[f"{case}/cache"] = [list(t.to_local().shape) for t in leaves(cache)]
        logits = [head_logits(params, last, cfg, rt)]
        for pos in range(DEC_S0, DEC_END):
            lg, cache = decode_step(params, toks[:, pos:pos + 1], cache, pos, cfg, rt)
            logits.append(lg)
    out[f"{case}/decode"] = torch.cat(logits, dim=1).numpy()


def layout_extras(cfg, params, inp, rt: Runtime, out: dict) -> None:
    """The gqa case again under remat (each layer's gathers recomputed in
    the backward) and two train steps of 2 microbatches with and without
    weights_once (one gather a step)."""
    from repro_torch.optim.adamw import adamw_init

    batch = {"tokens": torch.from_numpy(np.array(inp["gqa/tokens"])),
             "labels": torch.from_numpy(np.array(inp["gqa/labels"]))}
    rtr = replace(rt, remat=True)
    grads, m = make_train_step(cfg, rtr, TrainConfig()).compute_grads(params, batch)
    from repro_torch.train.step import _reduce_grads

    grads = leaves(grads)
    if rt.distributed:
        grads = _reduce_grads(grads, leaves(params), rt)
    out["remat/loss"] = np.array(float(m["loss"]))
    for i, g in enumerate(grads):
        out[f"remat/grad/{i}"] = full(g).numpy()
    for once in (False, True):
        tc = TrainConfig(lr=1e-3, warmup_steps=1, total_steps=4, microbatches=2,
                         weights_once=once)
        p = unflatten(params, [x.clone() if not hasattr(x, "to_local") else
                               _clone_placed(x) for x in leaves(params)])
        state = {"params": p, "opt": adamw_init(p)}
        step = make_train_step(cfg, rt, tc)
        losses, norms = [], []
        for _ in range(2):
            state, mm = step(state, _split(batch, 2))
            losses.append(float(mm["loss"]))
            norms.append(float(mm["grad_norm"]))
        out[f"once{int(once)}/loss"], out[f"once{int(once)}/gnorm"] = losses, norms


def _clone_placed(x):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(x.to_local().clone(), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape, stride=x.stride())


def work_layouts(rank: int, world: int, store: str, inputs: str, out_dir: str,
                 shape: tuple) -> None:
    """Every layout case on a `shape` mesh of gloo ranks (rank 0 writes the
    results, every rank its local shapes)."""
    import json

    _join(rank, world, store)
    inp = np.load(inputs)
    rt = Runtime(mesh=make_local_mesh(*shape, device="cpu"))
    out: dict = {}
    shapes: dict = {}
    for case in LAYOUT_CASES:
        cfg = layout_cfg(case)
        specs = _map_specs(lambda s: s, param_specs(cfg))
        params = distribute_params(_tree(inp, f"{case}/params", specs), specs, rt)
        layout_run(cfg, params, inp, case, rt, out, shapes)
        if case == "gqa":
            layout_extras(cfg, params, inp, rt, out)
    if rank == 0:
        np.savez(os.path.join(out_dir, "rank0.npz"), **out)
    with open(os.path.join(out_dir, f"shapes{rank}.json"), "w") as f:
        json.dump(shapes, f)
    dist.barrier()
    dist.destroy_process_group()
