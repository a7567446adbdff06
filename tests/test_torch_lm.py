"""The port's LM serving path against `repro`: configs, parameter specs,
prefill, decode, greedy generation and the command line, for every block
kind (GQA, local attention, MLA, MoE, RG-LRU, SSD).

Weights: the reference's `init_params` draws them (jax.random), and
`repro_torch.convert.lm_params_from_reference` carries them across leaf for
leaf, so parity does not depend on the two packages' random draws. Inputs
are numpy arrays from seeded generators.

The reference runs under a (1, 1) mesh whose axes are `AxisType.Auto`:
`repro.launch.mesh.make_local_mesh` builds `Explicit` axes on this jax
(0.9), under which `repro.dist.sharding.constrain` asserts inside
`_backbone`. That is why the reference's own `test_serve_consistency.py`
fails here; under Auto axes the same calls run unchanged.

Tolerances: in f32 the port's log-probs agree with the reference's within
1e-4 (the two frameworks sum in other orders), hidden states and caches
within 1e-4 absolute, and greedy tokens are equal on the stated seeds. In
bf16, rounding differences compound through the layers, so the rule is
the reference test's own: log-probs within 0.15 and argmax agreement at
least 0.85 (0.2 for the recurrent and MoE archs: the reference test's
rule for them).

Local attention: the reference's decode matches its own forward only below
the window (its prefill pads the cache to s_max and its decode attends to
all of it, ROADMAP queue 3); the port keeps a ring of min(s_max, window)
slots, which equals the reference's decode below the window and the
reference's forward past it.
"""

import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_arch as r_get_arch
from repro.dist.sharding import Runtime as RRuntime
from repro.dist.sharding import set_mesh
from repro.models import model as r_model
from repro.models import params as r_params
from repro.serve.engine import ServeEngine as RServeEngine
from repro_torch.configs.base import get_arch
from repro_torch.convert import lm_params_from_reference
from repro_torch.dist.sharding import Runtime, abstract_mesh
from repro_torch.models import model
from repro_torch.models import params as p_params
from repro_torch.serve.engine import ServeEngine
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
B, S0, S = 2, 16, 32
F32_TOL = 1e-4
BF16_TOL, BF16_AGREE = 0.15, 0.85
DENSE = ["tinyllama_1_1b", "qwen2_5_32b", "nemotron_4_340b", "musicgen_large", "minitron_4b",
         "llava_next_34b"]
KINDS = ["deepseek_v3_671b", "llama4_scout_17b_a16e", "recurrentgemma_2b", "mamba2_1_3b"]
BF16_RULE = {"tinyllama_1_1b": BF16_TOL, "qwen2_5_32b": BF16_TOL,
             "recurrentgemma_2b": 0.2, "mamba2_1_3b": 0.2, "llama4_scout_17b_a16e": 0.2}
RT = Runtime()


def ref_mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))


def log_softmax(a: np.ndarray, vocab: int) -> np.ndarray:
    a = np.asarray(a, np.float64)[..., :vocab]
    m = a.max(-1, keepdims=True)
    return a - m - np.log(np.exp(a - m).sum(-1, keepdims=True))


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy().copy()


def ref_tree_np(params):
    return jax.tree.map(np.asarray, params)


def frames_for(cfg, tokens: np.ndarray) -> np.ndarray:
    """The pipeline's stub frames for these tokens, in f32."""
    return np.sin(tokens[..., None] * np.linspace(0.01, 1, cfg.frontend_dim)).astype(np.float32)


def reference_run(arch: str, dtype):
    """The reference's outputs on the smoke config: the full forward's
    hidden (and logits), prefill's last hidden and caches, and each decode
    step's logits; with the weights as numpy arrays and the tokens."""
    cfg = r_get_arch(arch, smoke=True)
    mesh = ref_mesh()
    rt = RRuntime(mesh=mesh)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    out = {"tokens": tokens}
    with set_mesh(mesh):
        params = r_params.init_params(cfg, jax.random.PRNGKey(1), dtype=dtype)
        head = r_model._head_matrix(params, cfg)
        hidden = jax.jit(lambda p, t: r_model.forward_train(p, {"tokens": t}, cfg, rt))(
            params, jnp.asarray(tokens))
        out["hidden"] = np.asarray(hidden, np.float32)
        out["full_logits"] = np.asarray(jnp.einsum("bsd,dv->bsv", hidden, head), np.float32)
        if cfg.frontend:
            fr = jnp.asarray(frames_for(cfg, tokens), jnp.bfloat16)
            out["frames_hidden"] = np.asarray(
                r_model.forward_train(params, {"frames": fr}, cfg, rt), np.float32)
        last, cache = r_model.prefill(params, {"tokens": jnp.asarray(tokens[:, :S0])}, cfg, rt,
                                      s_max=S)
        out["last"] = np.asarray(last, np.float32)
        out["cache"] = jax.tree.map(lambda a: np.asarray(a, np.float32), cache)
        step = jax.jit(lambda p, t, c, pos: r_model.decode_step(p, t, c, pos, cfg, rt))
        logits = []
        for t in range(S0, S):
            lg, cache = step(params, jnp.asarray(tokens[:, t:t + 1]), cache, jnp.int32(t))
            logits.append(np.asarray(lg[:, 0], np.float32))
        out["decode_logits"] = np.stack(logits, 1)
        out["params"] = ref_tree_np(params)
    return cfg, out


def port_run(arch: str, params: dict, tokens: np.ndarray):
    cfg = get_arch(arch, smoke=True)
    tok = torch.from_numpy(tokens)
    out = {}
    with torch.no_grad():
        hidden = model.forward_train(params, {"tokens": tok}, cfg, RT)
        out["hidden"] = to_np(hidden)
        out["full_logits"] = to_np(hidden @ model._head_matrix(params, cfg))
        if cfg.frontend:
            fr = torch.from_numpy(frames_for(cfg, tokens)).to(torch.bfloat16)
            out["frames_hidden"] = to_np(model.forward_train(params, {"frames": fr}, cfg, RT))
        last, cache = model.prefill(params, {"tokens": tok[:, :S0]}, cfg, RT, s_max=S)
        out["last"] = to_np(last)
        out["cache"] = [[{k: to_np(v) for k, v in e.items()} for e in seg] for seg in cache]
        logits = []
        for t in range(S0, S):
            lg, cache = model.decode_step(params, tok[:, t:t + 1], cache, t, cfg, RT)
            logits.append(to_np(lg[:, 0]))
        out["decode_logits"] = np.stack(logits, 1)
    return cfg, out


@functools.cache
def f32_run(arch: str):
    cfg, ref = reference_run(arch, jnp.float32)
    params = lm_params_from_reference(ref["params"], device="cpu")
    return cfg, ref, params, port_run(arch, params, ref["tokens"])[1]


def spec_rows(tree, prefix=""):
    """(path, shape, logical, init, fan_in, dtype name) of every leaf."""
    if isinstance(tree, dict):
        return [r for k in sorted(tree) if k not in ("kinds", "repeats")
                for r in spec_rows(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [r for i, v in enumerate(tree) for r in spec_rows(v, f"{prefix}/{i}")]
    dt = tree.dtype
    name = str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) else np.dtype(dt).name
    return [(prefix, tuple(tree.shape), tuple(tree.logical), tree.init,
             tuple(tree.fan_in_axes), name)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_specs_and_counts_match_reference(arch):
    """Every config, full and smoke: the same fields, layer plan, spec tree
    (shapes, logical axes, inits, fan-in, dtypes) and parameter counts."""
    for smoke in (False, True):
        cfg, rcfg = get_arch(arch, smoke=smoke), r_get_arch(arch, smoke=smoke)
        assert repr(cfg) == repr(rcfg)
        assert p_params.layer_plan(cfg) == r_params.layer_plan(rcfg)
        assert spec_rows(p_params.param_specs(cfg)) == spec_rows(r_params.param_specs(rcfg))
        for active in (False, True):
            assert p_params.count_params(cfg, active) == r_params.count_params(rcfg, active)
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.active_param_count() == rcfg.active_param_count()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_params_shapes_dtypes_and_constant_inits(arch):
    """The port's init_params gives the reference's tree of shapes and
    dtypes, and the reference's constant leaves (ones, zeros) exactly."""
    cfg = get_arch(arch, smoke=True)
    ours = model.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    theirs = r_params.init_params(r_get_arch(arch, smoke=True), jax.random.PRNGKey(0))
    specs = {row[0]: row for row in spec_rows(p_params.param_specs(cfg))}

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            return {p: v for k in tree for p, v in leaves(tree[k], f"{prefix}/{k}").items()}
        if isinstance(tree, list):
            return {p: v for i, t in enumerate(tree) for p, v in leaves(t, f"{prefix}/{i}").items()}
        return {prefix: tree}

    ol, tl = leaves(ours), leaves(theirs)
    assert ol.keys() == tl.keys() == specs.keys()
    for path, t in ol.items():
        assert tuple(t.shape) == tuple(tl[path].shape), path
        assert str(t.dtype).replace("torch.", "") == str(tl[path].dtype), path
        if specs[path][3] in ("ones", "zeros"):
            np.testing.assert_array_equal(to_np(t), np.asarray(tl[path], np.float32))
        elif specs[path][3] == "normal":
            assert float(t.float().std()) > 0, path


def test_lm_params_from_reference_keeps_bf16_bits():
    cfg = r_get_arch("qwen2_5_32b", smoke=True)
    ref = ref_tree_np(r_params.init_params(cfg, jax.random.PRNGKey(2)))
    ours = lm_params_from_reference(ref, device="cpu")
    wq_ref = ref["segments"][0]["blocks"][0]["mixer"]["wq"]
    wq = ours["segments"][0]["blocks"][0]["mixer"]["wq"]
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(wq.view(torch.int16).numpy(), wq_ref.view(np.int16))
    assert lm_params_from_reference(ref, device="cpu", dtype=torch.float32)["embed"].dtype \
        == torch.float32


@pytest.mark.parametrize("arch", KINDS)
def test_lm_params_from_reference_carries_every_leaf_bitwise(arch):
    """The other kinds' leaves (lam, a_log, dt_bias, the router, the experts
    and the rest), bf16 and f32, carried bit for bit in the reference's
    tree order."""
    from repro_torch.tree import leaves

    ref = ref_tree_np(r_params.init_params(r_get_arch(arch, smoke=True),
                                           jax.random.PRNGKey(4)))
    ours = leaves(lm_params_from_reference(ref, device="cpu"))
    theirs = jax.tree.leaves(ref)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert tuple(a.shape) == b.shape and str(a.dtype).replace("torch.", "") == str(b.dtype)
        if a.dtype == torch.bfloat16:
            np.testing.assert_array_equal(a.view(torch.int16).numpy(), b.view(np.int16))
        else:
            np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("arch", DENSE + KINDS)
def test_forward_prefill_decode_match_reference_f32(arch):
    """Forward, prefill (last hidden and every cache entry: KV, latent,
    ring, recurrent state and conv tail) and decode, below the local window
    (S = 32 = its length)."""
    cfg, ref, _, ours = f32_run(arch)
    v = cfg.vocab_size
    np.testing.assert_allclose(ours["hidden"], ref["hidden"], atol=F32_TOL, rtol=0)
    if cfg.frontend:
        np.testing.assert_allclose(ours["frames_hidden"], ref["frames_hidden"], atol=F32_TOL,
                                   rtol=0)
    np.testing.assert_allclose(ours["last"], ref["last"], atol=F32_TOL, rtol=0)
    assert len(ours["cache"]) == len(ref["cache"])
    for seg_o, seg_r in zip(ours["cache"], ref["cache"]):
        for eo, er in zip(seg_o, seg_r):
            assert eo.keys() == er.keys()
            for key in eo:
                assert eo[key].shape == er[key].shape
                np.testing.assert_allclose(eo[key], er[key], atol=F32_TOL, rtol=0)
    err = np.abs(log_softmax(ours["decode_logits"], v) - log_softmax(ref["decode_logits"], v))
    assert err.max() < F32_TOL, err.max()
    assert (ours["decode_logits"][..., :v].argmax(-1)
            == ref["decode_logits"][..., :v].argmax(-1)).all()


@pytest.mark.parametrize("arch", DENSE + KINDS)
def test_port_decode_matches_its_own_forward(arch):
    """Teacher forcing: prefill + decode give the full forward's
    log-probs position by position (the reference's invariant), in f32."""
    cfg = get_arch(arch, smoke=True)
    params = model.init_params(cfg, torch.Generator().manual_seed(1), dtype=torch.float32,
                               device="cpu")
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    _, out = port_run(arch, params, tokens)
    v = cfg.vocab_size
    err = np.abs(log_softmax(out["decode_logits"], v)
                 - log_softmax(out["full_logits"][:, S0:], v))
    assert err.max() < F32_TOL, err.max()
    assert (out["decode_logits"][..., :v].argmax(-1)
            == out["full_logits"][:, S0:, :v].argmax(-1)).all()


@pytest.mark.parametrize("arch", sorted(BF16_RULE))
def test_decode_matches_reference_bf16(arch):
    cfg, ref = reference_run(arch, jnp.bfloat16)
    params = lm_params_from_reference(ref["params"], device="cpu")
    _, ours = port_run(arch, params, ref["tokens"])
    v = cfg.vocab_size
    for a, b in ((ours["decode_logits"], ref["decode_logits"]),
                 (ours["decode_logits"], ours["full_logits"][:, S0:])):
        g, w = log_softmax(a, v), log_softmax(b, v)
        assert np.abs(g - w).max() < BF16_RULE[arch]
        assert (g.argmax(-1) == w.argmax(-1)).mean() >= BF16_AGREE


@pytest.mark.parametrize("seed", [0, 5])
def test_serve_engine_greedy_matches_reference(seed):
    """Greedy tokens equal the reference's ServeEngine's, f32 weights carried
    across; a second call returns the same tokens."""
    rcfg = r_get_arch("tinyllama_1_1b", smoke=True)
    mesh = ref_mesh()
    prompts = np.random.default_rng(seed).integers(0, rcfg.vocab_size, size=(2, 8)).astype(
        np.int32)
    with set_mesh(mesh):
        rparams = r_params.init_params(rcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
        want = RServeEngine(rcfg, RRuntime(mesh=mesh), rparams, max_seq=24).generate(
            prompts, steps=10)
    cfg = get_arch("tinyllama_1_1b", smoke=True)
    eng = ServeEngine(cfg, RT, lm_params_from_reference(ref_tree_np(rparams), device="cpu"),
                      max_seq=24)
    got = eng.generate(prompts, steps=10)
    assert got.dtype == np.int32 and got.shape == (2, 10)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(eng.generate(prompts, steps=10), got)
    sampled = eng.generate(prompts, steps=10, temperature=0.8, seed=3)
    np.testing.assert_array_equal(eng.generate(prompts, steps=10, temperature=0.8, seed=3),
                                  sampled)
    assert ((sampled >= 0) & (sampled < cfg.vocab_size)).all()


@pytest.mark.parametrize("s0,s_end", [(16, 32), (16, 64), (48, 64)])
def test_local_attention_ring(s0, s_end):
    """recurrentgemma (window 32): prefill s0 tokens into a cache of s_end,
    decode to s_end. The port's log-probs against the reference's forward
    at every decoded position, past the window too (16 -> 64 wraps the
    ring in decode, 48 -> 64 fills it from a prefill longer than it); below
    the window (16 -> 32) also against the reference's own decode."""
    arch = "recurrentgemma_2b"
    rcfg = r_get_arch(arch, smoke=True)
    assert rcfg.local_window == 32
    mesh = ref_mesh()
    rt = RRuntime(mesh=mesh)
    tokens = np.random.default_rng(6).integers(0, rcfg.vocab_size, size=(B, s_end)).astype(
        np.int32)
    with set_mesh(mesh):
        rparams = r_params.init_params(rcfg, jax.random.PRNGKey(7), dtype=jnp.float32)
        hidden = jax.jit(lambda p, t: r_model.forward_train(p, {"tokens": t}, rcfg, rt))(
            rparams, jnp.asarray(tokens))
        want = np.asarray(jnp.einsum("bsd,dv->bsv", hidden, r_model._head_matrix(rparams, rcfg)),
                          np.float32)[:, s0:]
        if s_end <= rcfg.local_window:
            _, rcache = r_model.prefill(rparams, {"tokens": jnp.asarray(tokens[:, :s0])}, rcfg,
                                        rt, s_max=s_end)
            step = jax.jit(lambda p, t, c, pos: r_model.decode_step(p, t, c, pos, rcfg, rt))
            ref_dec = []
            for t in range(s0, s_end):
                lg, rcache = step(rparams, jnp.asarray(tokens[:, t:t + 1]), rcache, jnp.int32(t))
                ref_dec.append(np.asarray(lg[:, 0], np.float32))
    cfg = get_arch(arch, smoke=True)
    params = lm_params_from_reference(ref_tree_np(rparams), device="cpu")
    tok = torch.from_numpy(tokens)
    got = []
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": tok[:, :s0]}, cfg, RT, s_max=s_end)
        ring = [e for seg in cache for e in seg if "k" in e]
        assert ring and all(e["k"].shape[2] == min(s_end, cfg.local_window) for e in ring)
        for t in range(s0, s_end):
            lg, cache = model.decode_step(params, tok[:, t:t + 1], cache, t, cfg, RT)
            got.append(to_np(lg[:, 0]))
    got = np.stack(got, 1)
    v = cfg.vocab_size
    refs = [want] if s_end > rcfg.local_window else [want, np.stack(ref_dec, 1)]
    for ref in refs:
        err = np.abs(log_softmax(got, v) - log_softmax(ref, v))
        assert err.max() < F32_TOL, err.max()
        assert (got[..., :v].argmax(-1) == ref[..., :v].argmax(-1)).all()


def test_prefill_ring_holds_the_last_window_positions():
    """A prefill longer than the window leaves position p's key at slot
    p % window for the last window positions; shorter, the keys in order
    and zeros after them."""
    cfg = get_arch("recurrentgemma_2b", smoke=True)
    w = cfg.local_window
    k = torch.arange(45 * 3, dtype=torch.float32).reshape(1, 45, 1, 3) + 1
    full = model._cache_entry("local_attn+ffn", {"k": k}, 64, cfg)["k"]
    assert full.shape == (1, w, 1, 3)
    for p in range(45 - w, 45):
        assert torch.equal(full[:, p % w], k[:, p])
    short = model._cache_entry("local_attn+ffn", {"k": k[:, :20]}, 64, cfg)["k"]
    assert torch.equal(short[:, :20], k[:, :20]) and not short[:, 20:].any()
    padded = model._cache_entry("gqa+ffn", {"k": k[:, :20]}, 64, cfg)["k"]
    assert padded.shape == (1, 64, 1, 3) and torch.equal(padded[:, :20], k[:, :20])
    state = torch.ones((1, 5), dtype=torch.bfloat16)
    tail = torch.ones((1, 3, 5), dtype=torch.bfloat16)
    rec = model._cache_entry("rglru+ffn", {"state": state, "tail": tail}, 64, cfg)
    assert rec["state"].dtype == torch.float32 and rec["state"].shape == (1, 5)
    assert rec["tail"] is tail


@pytest.mark.parametrize("arch", KINDS)
def test_serve_engine_greedy_matches_reference_every_kind(arch):
    """Greedy tokens equal the reference's ServeEngine's (f32 weights
    carried across, max_seq 24: below recurrentgemma's window)."""
    rcfg = r_get_arch(arch, smoke=True)
    mesh = ref_mesh()
    prompts = np.random.default_rng(9).integers(0, rcfg.vocab_size, size=(2, 8)).astype(np.int32)
    with set_mesh(mesh):
        rparams = r_params.init_params(rcfg, jax.random.PRNGKey(9), dtype=jnp.float32)
        want = RServeEngine(rcfg, RRuntime(mesh=mesh), rparams, max_seq=24).generate(
            prompts, steps=10)
    eng = ServeEngine(get_arch(arch, smoke=True), RT,
                      lm_params_from_reference(ref_tree_np(rparams), device="cpu"), max_seq=24)
    np.testing.assert_array_equal(eng.generate(prompts, steps=10), want)


def test_runtime_refuses_a_mesh_and_its_modes():
    """Since the mesh's port no mode is refused: a Runtime takes any mesh
    and mode, and mesh=None stays one card (tests/test_torch_dist.py holds
    the rules on meshes, tests/test_torch_mesh.py the paths on ranks)."""
    for kw in ({"mesh": abstract_mesh((2, 2), ("data", "model"))}, {"explicit_tp": True},
               {"seq_shard": True}, {"full_dp": True}):
        rt = Runtime(**kw)
        assert not rt.distributed
    rt = Runtime(remat=True, moe_decode_gather=True)
    assert (rt.dp_size, rt.tp_size, rt.dp_axes) == (1, 1, ())


def run_cli(*args):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                          capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)


def test_cli_serves_the_lm_and_refuses_what_is_not_ported():
    for arch in ("tinyllama_1_1b", "mamba2_1_3b", "recurrentgemma_2b"):
        out = run_cli("--arch", arch, "--smoke", "--device", "cpu")
        assert out.returncode == 0, out.stderr
        assert out.stdout.splitlines()[0].startswith("generated (4, 32) tokens")
    # a mesh of 2 ranks needs torch.distributed.run to start them
    # (tests/test_torch_mesh.py serves through it)
    mesh = run_cli("--smoke", "--device", "cpu", "--model", "2")
    assert mesh.returncode == 2 and "torch.distributed.run" in mesh.stderr


@pytest.mark.parametrize("arch", ["deepseek_v3_671b", "llama4_scout_17b_a16e"])
def test_cli_serves_the_moe_archs(arch):
    out = run_cli("--arch", arch, "--smoke", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[0].startswith("generated (4, 32) tokens")
