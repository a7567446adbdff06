"""The port's training path against `repro`: the flash backward, the loss
and its gradients, AdamW, int8 gradient compression, the train step
(microbatches, compression) and the training command line.

Weights and training states are drawn by the reference and carried across
(`repro_torch.convert`), batches come from both packages' pipelines (equal
bit for bit), and the reference runs under a (1, 1) mesh of `AxisType.Auto`
axes: its own `make_local_mesh` builds `Explicit` axes on this jax, under
which `constrain` asserts (why `tests/test_train_features.py` fails here).

Tolerances: the flash backward within 1e-5 of each gradient's largest
magnitude (f32; the products are summed in other orders); the loss within
1e-5 relative and each gradient leaf within 1e-4 of its largest magnitude;
AdamW in f32 within 1e-6 relative, in bf16 within one bf16 ulp; the int8
values and scales equal, the error buffers within one f32 ulp; three train
steps' losses and grad norms within 1e-4 relative with f32 parameters
(1e-2 with bf16 ones, which round every product and gradient), and the
parameters within 2e-2 (the reference test's rule for two bf16
trajectories).
"""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stderr
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs.base import get_arch as r_get_arch
from repro.data.pipeline import SyntheticTokenPipeline as RPipeline
from repro.dist.sharding import Runtime as RRuntime
from repro.dist.sharding import set_mesh
from repro.models import attention as r_attn
from repro.models import model as r_model
from repro.models import params as r_params
from repro.optim import adamw as r_adamw
from repro.train import compression as r_comp
from repro.train import step as r_step
from repro_torch.configs.base import get_arch
from repro_torch.convert import lm_params_from_reference, train_state_from_reference
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.dist.sharding import Runtime
from repro_torch.launch import train as train_cli
from repro_torch.models import attention as attn
from repro_torch.models import model
from repro_torch.optim.adamw import adamw_init, adamw_update, cosine_schedule
from repro_torch.train.compression import (
    _quantize_leaf,
    compress_decompress_grads,
    compression_init,
)
from repro_torch.train.step import TrainConfig, init_train_state, make_train_step
from repro_torch.tree import leaves, tree_map
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
RT = Runtime()
FLASH_TOL = 1e-5
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
STEP_RTOL, PARAM_ATOL = 1e-4, 2e-2


def ref_mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def assert_leaves_close(ours, theirs, tol, what):
    """Each leaf within tol of its largest reference magnitude."""
    ours, theirs = leaves(ours), jax.tree.leaves(theirs)
    assert len(ours) == len(theirs)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        a, b = f32(a), f32(b)
        assert a.shape == b.shape, (what, i)
        top = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a - b).max())
        assert err <= tol * top, f"{what} leaf {i} {b.shape}: {err} vs {tol} x {top}"


# ---------------------------------------------------------------------------
# the flash backward
# ---------------------------------------------------------------------------


def flash_inputs(g: int, s: int = 64, seed: int = 0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    b, kv, hd = 2, 2, 8
    q = rng.normal(size=(b, s, kv * g, hd)).astype(dtype)
    k = rng.normal(size=(b, s, kv, hd)).astype(dtype)
    v = rng.normal(size=(b, s, kv, hd)).astype(dtype)
    do = rng.normal(size=(b, s, kv, g, hd)).astype(dtype)
    return q, k, v, do


# chunk_q >= chunk_k: with chunk_q < chunk_k the reference's forward rounds
# j_hi = (i + 1) * chunk_q // chunk_k down to 0 for the first query chunk,
# which then reaches no key (out 0, lse -1e30, an infinite gradient) in
# both packages; the models always take equal chunks
@pytest.mark.parametrize("chunks", [(16, 16), (32, 32), (32, 16)])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("window", [None, 24])
def test_flash_backward_matches_reference_vjp(chunks, g, window):
    cq, ck = chunks
    q, k, v, do = flash_inputs(g)
    scale = q.shape[-1] ** -0.5
    out_r, vjp = jax.vjp(lambda a, b, c: r_attn._flash_core(a, b, c, window, cq, ck, scale),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_r = vjp(jnp.asarray(do))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = attn._FlashCore.apply(qt, kt, vt, window, cq, ck, scale)
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    top = float(np.abs(np.asarray(out_r)).max())
    assert float(np.abs(f32(out) - np.asarray(out_r)).max()) <= FLASH_TOL * top
    for name, ours, theirs in zip("qkv", grads, grads_r):
        theirs = np.asarray(theirs)
        assert ours.dtype == torch.float32 and ours.shape == theirs.shape
        err = float(np.abs(f32(ours) - theirs).max())
        assert err <= FLASH_TOL * float(np.abs(theirs).max()), (name, err)
    # without a gradient the forward alone runs, with the same bits
    with torch.no_grad():
        plain = attn._flash_fwd(qt, kt, vt, window, cq, ck, scale)[0]
    assert torch.equal(plain, out.detach())


@pytest.mark.parametrize("window", [None, 3])
def test_flash_backward_gradcheck_f64(window):
    q, k, v, _ = flash_inputs(2, s=8, seed=1, dtype=np.float64)
    inputs = tuple(torch.from_numpy(a[:1, :, :, :4]).contiguous().requires_grad_()
                   for a in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda a, b, c: attn._FlashCore.apply(a, b, c, window, 4, 2, 0.5), inputs)


def test_flash_attention_takes_the_backward_only_with_grad():
    q, k, v, _ = flash_inputs(4)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    with torch.no_grad():
        plain = attn.flash_attention(qt, kt, vt, chunk_q=16, chunk_k=16)
    assert plain.grad_fn is None
    live = qt.clone().requires_grad_()
    out = attn.flash_attention(live, kt, vt, chunk_q=16, chunk_k=16)
    assert type(out.grad_fn).__name__ == "ViewBackward0"     # the Function's reshaped output
    assert torch.equal(out.detach(), plain)


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------

LOSS_CASES = {
    "tinyllama_1_1b": ("tinyllama_1_1b", {}),
    "qwen2_5_32b": ("qwen2_5_32b", {}),             # q/k/v biases
    "musicgen_large": ("musicgen_large", {}),       # stub frontend: frames
    "mtp": ("tinyllama_1_1b", {"mtp_heads": 1}),     # the multi-token auxiliary
    "padded_vocab": ("tinyllama_1_1b", {"vocab_size": 200}),   # padded to 256
}


def loss_batches(rcfg, cfg, b=2, s=32):
    ref = RPipeline(rcfg, b, s, seed=4).batch(3)
    ours = SyntheticTokenPipeline(cfg, b, s, seed=4, device="cpu").batch(3)
    labels = np.asarray(ref["labels"]).copy()
    labels[0, -5:] = -1                              # padding positions
    ref["labels"] = jnp.asarray(labels)
    ours["labels"] = torch.from_numpy(labels)
    return ref, ours


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_and_grads_match_reference(case):
    arch, over = LOSS_CASES[case]
    rcfg = r_get_arch(arch, smoke=True).with_overrides(**over)
    cfg = get_arch(arch, smoke=True).with_overrides(**over)
    rbatch, batch = loss_batches(rcfg, cfg)
    mesh = ref_mesh()
    rt = RRuntime(mesh=mesh)
    with set_mesh(mesh):
        rparams = r_params.init_params(rcfg, jax.random.PRNGKey(5), dtype=jnp.float32)
        (rloss, rmetrics), rgrads = jax.value_and_grad(
            lambda p: r_model.loss_fn(p, rbatch, rcfg, rt), has_aux=True)(rparams)
    params = lm_params_from_reference(np_tree(rparams), device="cpu")
    grads, metrics = make_train_step(cfg, RT, TrainConfig()).compute_grads(params, batch)
    assert metrics.keys() == rmetrics.keys()
    for key in metrics:
        assert abs(float(metrics[key]) - float(rmetrics[key])) <= LOSS_RTOL * abs(
            float(rmetrics[key])), key
    loss, _ = model.loss_fn(params, batch, cfg, RT)
    assert float(loss) == float(metrics["loss"])
    assert_leaves_close(grads, rgrads, GRAD_TOL, case)


def test_remat_gives_the_same_grads():
    cfg = get_arch("tinyllama_1_1b", smoke=True)
    params = model.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    batch = SyntheticTokenPipeline(cfg, 2, 32, seed=1, device="cpu").batch(0)
    plain, m_plain = make_train_step(cfg, RT, TrainConfig()).compute_grads(params, batch)
    remat, m_remat = make_train_step(cfg, Runtime(remat=True), TrainConfig()).compute_grads(
        params, batch)
    assert torch.equal(m_plain["loss"], m_remat["loss"])
    for a, b in zip(leaves(plain), leaves(remat)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch,n_layers", [("deepseek_v3_671b", None),
                                            ("recurrentgemma_2b", 4)])
def test_remat_gives_the_same_grads_over_segments(arch, n_layers):
    """An arch whose layer plan has two segments (deepseek's dense layer
    then its MoE layers; recurrentgemma's 3-block unit then one rglru
    layer): each layer's recompute runs its own segment's body. (It once
    ran the last segment's, whose closure the loop had rebound.)"""
    from repro_torch.models.params import layer_plan

    cfg = get_arch(arch, smoke=True)
    if n_layers is not None:
        cfg = cfg.with_overrides(n_layers=n_layers)
    assert len(layer_plan(cfg)) == 2
    params = model.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    batch = SyntheticTokenPipeline(cfg, 2, 32, seed=1, device="cpu").batch(0)
    plain, m_plain = make_train_step(cfg, RT, TrainConfig()).compute_grads(params, batch)
    remat, m_remat = make_train_step(cfg, Runtime(remat=True), TrainConfig()).compute_grads(
        params, batch)
    assert torch.equal(m_plain["loss"], m_remat["loss"])
    for a, b in zip(leaves(plain), leaves(remat)):
        assert torch.equal(a, b)


def test_chunked_xent_masks_padding_and_padded_vocab():
    cfg = get_arch("tinyllama_1_1b", smoke=True).with_overrides(vocab_size=5)
    rng = np.random.default_rng(0)
    hidden = torch.from_numpy(rng.normal(size=(2, 8, 4)).astype(np.float32))
    head = torch.from_numpy(rng.normal(size=(4, 7)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 5, size=(2, 8)).astype(np.int32))
    labels[1, 3:] = -1
    got = model._chunked_xent(hidden, labels, head, cfg)
    lp = torch.log_softmax((hidden @ head)[..., :5].double(), dim=-1)
    valid = labels >= 0
    want = -lp.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0][valid].mean()
    assert abs(float(got) - float(want)) <= 1e-6 * float(want)


# ---------------------------------------------------------------------------
# AdamW and the schedule
# ---------------------------------------------------------------------------


def bf16_ulp(a: np.ndarray) -> np.ndarray:
    a = np.abs(a.astype(np.float64))
    return np.where(a > 0, 2.0 ** (np.floor(np.log2(np.where(a > 0, a, 1.0))) - 7), 2.0 ** -133)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(dtype):
    rng = np.random.default_rng(7)
    shapes = {"w": (6, 5), "stack": (2, 3, 4), "bias": (5,), "norm": (4,)}
    p_np = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    rparams = {k: jnp.asarray(a).astype(jdt) for k, a in p_np.items()}
    params = lm_params_from_reference(np_tree(rparams), device="cpu")
    assert params["w"].dtype == getattr(torch, dtype)
    rstate, state = r_adamw.adamw_init(rparams), adamw_init(params)
    rsched, sched = r_adamw.cosine_schedule(1e-2, 2, 10), cosine_schedule(1e-2, 2, 10)
    for step in range(3):
        # gradients of global norm ~3 x 5: the clip to 1.0 is active
        g_np = {k: (rng.normal(size=s) * 3).astype(np.float32) for k, s in shapes.items()}
        rparams, rstate, rm = r_adamw.adamw_update(
            rparams, {k: jnp.asarray(a).astype(jdt) for k, a in g_np.items()}, rstate, rsched)
        params, state, m = adamw_update(
            params, lm_params_from_reference(
                np_tree({k: jnp.asarray(a).astype(jdt) for k, a in g_np.items()}),
                device="cpu"), state, sched)
        assert float(rm["grad_norm"]) > 1.0
        assert int(state["step"]) == int(rstate["step"]) == step + 1
        for key in ("grad_norm", "lr"):
            assert abs(float(m[key]) - float(rm[key])) <= 1e-6 * abs(float(rm[key])), key
        for k in shapes:
            ours, theirs = f32(params[k]), np.asarray(rparams[k], np.float32)
            if dtype == "float32":
                np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=0)
            else:
                assert (np.abs(ours - theirs) <= bf16_ulp(theirs)).all(), k
            for mom in ("m", "v"):
                np.testing.assert_allclose(f32(state[mom][k]), np.asarray(rstate[mom][k]),
                                           rtol=1e-6, atol=1e-12)


def test_adamw_decays_only_matrices():
    params = {"w": torch.ones(2, 2), "b": torch.ones(2)}
    zeros = {"w": torch.zeros(2, 2), "b": torch.zeros(2)}
    params, _, _ = adamw_update(params, zeros, adamw_init(params), 0.5, weight_decay=0.1)
    assert torch.allclose(params["w"], torch.full((2, 2), 0.95))
    assert torch.equal(params["b"], torch.ones(2))


def test_cosine_schedule_matches_reference():
    for base, warm, total in ((3e-4, 10, 100), (1e-3, 1, 4), (2e-3, 0, 7)):
        rs, ps = r_adamw.cosine_schedule(base, warm, total), cosine_schedule(base, warm, total)
        for step in range(total + 3):
            want = float(rs(jnp.int32(step)))
            got = float(ps(torch.tensor(step, dtype=torch.int32)))
            # relative to base: near the end 1 + cos(pi * frac) cancels, and
            # one f32 ulp of the cosine is 3e-8 of base there
            assert abs(got - want) <= 1e-6 * base, (base, warm, total, step)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------


def test_compression_matches_reference():
    rng = np.random.default_rng(3)
    g_np = {"a": (rng.normal(size=(16, 8)) * 1e-3).astype(np.float32),
            "b": (rng.normal(size=(8,)) * 10).astype(np.float32),
            "zero": np.zeros((3,), np.float32)}
    e_np = {k: (rng.normal(size=a.shape) * 1e-5).astype(np.float32) for k, a in g_np.items()}
    for dt in (jnp.float32, jnp.bfloat16):
        rg = {k: jnp.asarray(a).astype(dt) for k, a in g_np.items()}
        re = {k: jnp.asarray(a) for k, a in e_np.items()}
        g = lm_params_from_reference(np_tree(rg), device="cpu")
        e = {k: torch.from_numpy(a) for k, a in e_np.items()}
        for k in g_np:
            rq, rs = r_comp._quantize_leaf(rg[k].astype(jnp.float32) + re[k])
            q, s = _quantize_leaf(g[k].float() + e[k])
            assert q.dtype == torch.int8
            np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
            assert float(s) == float(rs)
        rdeq, rerr = r_comp.compress_decompress_grads(rg, re)
        deq, err = compress_decompress_grads(g, e)
        for k in g_np:
            assert deq[k].dtype == g[k].dtype and err[k].dtype == torch.float32
            np.testing.assert_array_equal(f32(deq[k]), np.asarray(rdeq[k], np.float32))
            theirs = np.asarray(rerr[k])
            assert (np.abs(f32(err[k]) - theirs) <= np.spacing(np.abs(theirs))).all(), k


def test_compression_error_feedback():
    g = {"w": torch.from_numpy((np.random.default_rng(0).normal(size=(64, 64)) * 1e-3)
                               .astype(np.float32))}
    err = compression_init(g)
    total_true = np.zeros((64, 64))
    total_deq = np.zeros((64, 64))
    for step in range(20):
        gs = tree_map(lambda a: a * (1 + 0.1 * step), g)
        deq, err = compress_decompress_grads(gs, err)
        total_true += gs["w"].numpy()
        total_deq += deq["w"].numpy()
    # error feedback keeps the accumulated quantized stream faithful
    assert np.abs(total_deq - total_true).max() < 0.02 * np.abs(total_true).max()


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

STEP_CASES = {"mb1": {}, "mb2": {"microbatches": 2}, "compressed": {"grad_compression": True}}
# losses and grad norms, relative: f32 parameters sum in another order only;
# bf16 parameters also round each product's output and each gradient to
# bf16 after sums taken in other orders (read: 1.2e-4 and 3.3e-3)
STEP_METRIC_RTOL = {"float32": STEP_RTOL, "bfloat16": 1e-2}


def split(batch, mb: int, lib):
    if mb == 1:
        return batch
    return {k: lib.reshape(a, (mb, a.shape[0] // mb, *a.shape[1:])) for k, a in batch.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_steps_match_reference(case, dtype):
    """Three steps from the reference's initial state carried across (its
    bf16 parameters, or the same cast to f32 on both sides)."""
    rcfg, cfg = r_get_arch("tinyllama_1_1b", smoke=True), get_arch("tinyllama_1_1b", smoke=True)
    over = STEP_CASES[case]
    rtc = r_step.TrainConfig(lr=3e-3, warmup_steps=1, total_steps=6, **over)
    tc = TrainConfig(lr=3e-3, warmup_steps=1, total_steps=6, **over)
    mesh = ref_mesh()
    rt = RRuntime(mesh=mesh)
    rpipe = RPipeline(rcfg, 8, 32, seed=2)
    pipe = SyntheticTokenPipeline(cfg, 8, 32, seed=2, device="cpu")
    mb = tc.microbatches
    rtol = STEP_METRIC_RTOL[dtype]
    first_err = None
    with set_mesh(mesh):
        rstate = r_step.init_train_state(rcfg, rt, rtc, jax.random.PRNGKey(3))
        rstate["params"] = jax.tree.map(lambda a: a.astype(dtype), rstate["params"])
        state = train_state_from_reference(np_tree(rstate), device="cpu")
        rfn = jax.jit(r_step.make_train_step(rcfg, rt, rtc))
        fn = make_train_step(cfg, RT, tc)
        for step in range(3):
            rstate, rm = rfn(rstate, split(rpipe.batch(step), mb, jnp))
            state, m = fn(state, split(pipe.batch(step), mb, torch))
            if step == 0 and tc.grad_compression and dtype == "float32":
                first_err = ([t.clone() for t in leaves(state["err"])],
                             jax.tree.leaves(np_tree(rstate["err"])))
            assert m.keys() == rm.keys()
            for key in ("loss", "grad_norm", "lr"):
                assert abs(float(m[key]) - float(rm[key])) <= rtol * abs(float(rm[key])), (
                    step, key, float(m[key]), float(rm[key]))
    assert state.keys() == rstate.keys()
    assert state["params"]["embed"].dtype == getattr(torch, dtype)
    assert int(state["opt"]["step"]) == 3
    for a, b in zip(leaves(state["params"]), jax.tree.leaves(rstate["params"])):
        np.testing.assert_allclose(f32(a), np.asarray(b, np.float32), rtol=0, atol=PARAM_ATOL)
    if first_err is not None:
        # after the first step from equal states, with f32 gradients: where
        # g lies near a rounding boundary, gradients summed in other orders
        # round to neighbouring int8 values and the error buffers differ by
        # one quantization step; elsewhere they agree
        for a, b in zip(*first_err):
            a, b = f32(a), np.asarray(b)
            close = np.abs(a - b) <= 1e-3 * np.abs(b).max()
            assert close.mean() >= 0.99, (b.shape, close.mean())


KIND_ARCHS = ["deepseek_v3_671b", "llama4_scout_17b_a16e", "recurrentgemma_2b", "mamba2_1_3b"]


@pytest.mark.parametrize("arch", KIND_ARCHS)
def test_train_steps_match_reference_every_kind(arch):
    """Two steps of the other block kinds (MLA + MoE + the MTP loss, top-1
    MoE, RG-LRU + local attention, SSD) from the reference's initial state
    cast to f32: losses (the MTP auxiliary's too) and grad norms within
    1e-4 relative, then the parameters within PARAM_ATOL."""
    rcfg, cfg = r_get_arch(arch, smoke=True), get_arch(arch, smoke=True)
    rtc = r_step.TrainConfig(lr=3e-3, warmup_steps=1, total_steps=6)
    tc = TrainConfig(lr=3e-3, warmup_steps=1, total_steps=6)
    mesh = ref_mesh()
    rt = RRuntime(mesh=mesh)
    rpipe = RPipeline(rcfg, 4, 32, seed=3)
    pipe = SyntheticTokenPipeline(cfg, 4, 32, seed=3, device="cpu")
    with set_mesh(mesh):
        rstate = r_step.init_train_state(rcfg, rt, rtc, jax.random.PRNGKey(4))
        rstate["params"] = jax.tree.map(lambda a: a.astype(jnp.float32), rstate["params"])
        state = train_state_from_reference(np_tree(rstate), device="cpu")
        rfn = jax.jit(r_step.make_train_step(rcfg, rt, rtc))
        fn = make_train_step(cfg, RT, tc)
        for step in range(2):
            rstate, rm = rfn(rstate, rpipe.batch(step))
            state, m = fn(state, pipe.batch(step))
            assert m.keys() == rm.keys()
            assert ("mtp_loss" in m) == bool(cfg.mtp_heads)
            for key in m:
                assert abs(float(m[key]) - float(rm[key])) <= STEP_RTOL * abs(float(rm[key])), (
                    step, key, float(m[key]), float(rm[key]))
    for a, b in zip(leaves(state["params"]), jax.tree.leaves(rstate["params"]), strict=True):
        np.testing.assert_allclose(f32(a), np.asarray(b, np.float32), rtol=0, atol=PARAM_ATOL)


def run_steps(cfg, tc, n_steps, batch_fn, seed=0):
    state = init_train_state(cfg, RT, tc, torch.Generator().manual_seed(seed), device="cpu")
    step = make_train_step(cfg, RT, tc)
    losses = []
    for i in range(n_steps):
        state, m = step(state, batch_fn(i))
        losses.append(float(m["loss"]))
    return losses, state


@pytest.fixture(scope="module")
def smoke_cfg():
    return get_arch("tinyllama_1_1b", smoke=True)


def test_loss_decreases(smoke_cfg):
    tc = TrainConfig(lr=3e-3, warmup_steps=2, total_steps=30)
    pipe = SyntheticTokenPipeline(smoke_cfg, 8, 64, seed=0, device="cpu")
    losses, _ = run_steps(smoke_cfg, tc, 25, pipe.batch)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses


def test_microbatch_equivalence(smoke_cfg):
    """Gradient accumulation over 2 microbatches == the full-batch step."""
    batch = SyntheticTokenPipeline(smoke_cfg, 8, 32, seed=5, device="cpu").batch(0)
    tc1 = TrainConfig(lr=1e-3, warmup_steps=1, total_steps=4, microbatches=1)
    tc2 = TrainConfig(lr=1e-3, warmup_steps=1, total_steps=4, microbatches=2)
    _, s1 = run_steps(smoke_cfg, tc1, 1, lambda _: batch)
    _, s2 = run_steps(smoke_cfg, tc2, 1, lambda _: split(batch, 2, torch))
    for a, b in zip(leaves(s1["params"]), leaves(s2["params"])):
        np.testing.assert_allclose(f32(a), f32(b), rtol=0, atol=PARAM_ATOL)   # bf16 params


def test_compressed_training_converges(smoke_cfg):
    tc = TrainConfig(lr=3e-3, warmup_steps=2, total_steps=30, grad_compression=True)
    pipe = SyntheticTokenPipeline(smoke_cfg, 8, 64, seed=0, device="cpu")
    losses, _ = run_steps(smoke_cfg, tc, 20, pipe.batch)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


def test_weights_once_changes_nothing(smoke_cfg):
    batch = SyntheticTokenPipeline(smoke_cfg, 4, 16, seed=1, device="cpu").batch(0)
    runs = [run_steps(smoke_cfg, replace(TrainConfig(lr=1e-3, microbatches=2), weights_once=w),
                      1, lambda _: split(batch, 2, torch))[1] for w in (False, True)]
    for a, b in zip(leaves(runs[0]), leaves(runs[1])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def test_crash_resume_trajectory(tmp_path):
    """Kill at step 7, resume, and match the uninterrupted trajectory."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "tinyllama_1_1b",
            "--smoke", "--steps", "12", "--batch", "4", "--seq", "32", "--save-every", "5",
            "--log-every", "1", "--device", "cpu"]

    def run(*extra):
        return subprocess.run(base + list(extra), env=env, capture_output=True, text=True,
                              cwd=ROOT, timeout=300)

    ref = run("--ckpt-dir", str(tmp_path / "ref"), "--metrics-out", str(tmp_path / "ref.json"))
    assert ref.returncode == 0, ref.stderr[-2000:]
    crash = run("--ckpt-dir", str(tmp_path / "ft"), "--fail-at-step", "7")
    assert crash.returncode == 42
    assert "FAULT-INJECTION: crashing at step 7" in crash.stdout
    resume = run("--ckpt-dir", str(tmp_path / "ft"), "--metrics-out", str(tmp_path / "ft.json"))
    assert resume.returncode == 0, resume.stderr[-2000:]
    assert "resumed from step 4" in resume.stdout
    assert "done: final loss" in resume.stdout
    ref_losses = json.loads((tmp_path / "ref.json").read_text())["losses"]
    ft_losses = json.loads((tmp_path / "ft.json").read_text())["losses"]
    assert len(ref_losses) == 12 and len(ft_losses) == 7
    # the resumed run covers steps 5..11; its final losses must match the
    # uninterrupted run's (deterministic pipeline + bitwise state restore)
    np.testing.assert_allclose(ft_losses[-3:], ref_losses[-3:], atol=1e-2)


@pytest.mark.parametrize("argv,item", [
    (["--data", "2"], "11(c)"),
    (["--model", "4"], "11(c)"),
])
def test_cli_refuses_what_is_not_ported(argv, item):
    """A mesh (item 11(c), ported) of more than one rank is refused unless
    torch.distributed.run started the ranks (tests/test_torch_mesh.py
    trains through it)."""
    err = io.StringIO()
    with redirect_stderr(err), pytest.raises(SystemExit) as exc:
        train_cli.main(["--smoke", "--device", "cpu", *argv])
    assert exc.value.code == 2
    assert item == "11(c)" and "start them with python -m torch.distributed.run" in err.getvalue()


def test_cli_trains_the_recurrent_archs(tmp_path):
    """`launch.train --smoke` on an SSD arch and an RG-LRU + local-attention
    one: every step's loss finite, a checkpoint written and resumed from."""
    for arch in ("mamba2_1_3b", "recurrentgemma_2b"):
        argv = ["--arch", arch, "--smoke", "--steps", "4", "--batch", "2", "--seq", "32",
                "--save-every", "2", "--ckpt-dir", str(tmp_path / arch), "--device", "cpu",
                "--metrics-out", str(tmp_path / f"{arch}.json")]
        assert train_cli.main(argv) == 0
        losses = json.loads((tmp_path / f"{arch}.json").read_text())["losses"]
        assert len(losses) == 4 and np.isfinite(losses).all()
        assert train_cli.main(argv[:3] + ["--steps", "6"] + argv[5:]) == 0
