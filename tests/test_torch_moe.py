"""The port's capacity MoE against `repro.models.ffn.moe_forward`: outputs at
a drop-free capacity and at the published 1.25, and the dropped routes.

With top-1 routing (llama4_scout) every renormalised gate is exactly 1.0,
so an expert that overflows chooses among equal weights: the reference's
`jax.lax.top_k` keeps the lowest token indices, and the port's stable
descending sort must keep the same ones (`torch.topk` promises no order).
The dropped routes are held against the reference's selection (its
router and `top_k` calls, restated here since they run inside its
`shard_map` body) and against a brute-force recount by rank.

Weights: a MoE layer of the reference's smoke config (`init_params`, f32),
carried across; the reference runs under a (1, 1) mesh of `AxisType.Auto`
axes, as in `test_torch_lm.py`. Inputs: seeded normal draws plus a shared
offset, which skews the routing so that experts overflow at 1.25.
Tolerance: outputs within 1e-5 of their largest magnitude (f32, up to
~30 with the offset; a wrong drop moves a row by O(1)).
"""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs.base import get_arch as r_get_arch
from repro.dist.sharding import Runtime as RRuntime
from repro.dist.sharding import set_mesh
from repro.models import attention as r_attn
from repro.models import ffn as r_ffn
from repro.models import params as r_params
from repro_torch.configs.base import get_arch
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import ffn
from repro_torch.models.attention import rmsnorm
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

TOL = 1e-5
B, S = 2, 64
CASES = {  # arch, segment index of a MoE layer, capacity factor
    "llama4_top1_drop_free": ("llama4_scout_17b_a16e", 0, 8.0),
    "llama4_top1_published": ("llama4_scout_17b_a16e", 0, 1.25),
    "deepseek_top2_drop_free": ("deepseek_v3_671b", 1, 8.0),
    "deepseek_top2_published": ("deepseek_v3_671b", 1, 1.25),
}


def with_capacity(cfg, factor: float):
    return cfg.with_overrides(moe=replace(cfg.moe, capacity_factor=factor))


@functools.cache
def moe_case(case: str):
    """(cfg, the reference's output and dropped mask, the port's channel
    params, x) for a case."""
    arch, seg, factor = CASES[case]
    rcfg = with_capacity(r_get_arch(arch, smoke=True), factor)
    cfg = with_capacity(get_arch(arch, smoke=True), factor)
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(B, S, cfg.d_model)) + rng.normal(size=cfg.d_model)).astype(np.float32)
    with set_mesh(mesh):
        tree = r_params.init_params(rcfg, jax.random.PRNGKey(3), dtype=jnp.float32)
        chan = jax.tree.map(lambda a: np.asarray(a)[0],
                            tree["segments"][seg]["blocks"][0]["channel"])
        out = jax.jit(lambda p, xx: r_ffn.moe_forward(p, xx, rcfg, RRuntime(mesh=mesh)))(
            jax.tree.map(jnp.asarray, chan), jnp.asarray(x))
    return cfg, np.asarray(out), ref_dropped(chan, x, rcfg), \
        lm_params_from_reference(chan, device="cpu"), x


def ref_dropped(chan: dict, x: np.ndarray, rcfg) -> np.ndarray:
    """(t, E) bool: the routes the reference's capacity drops, by its own
    router and top_k calls (`repro/models/ffn.py` moe_forward's inner)."""
    m = rcfg.moe
    h = r_attn.rmsnorm(jnp.asarray(x), jnp.asarray(chan["ln"]), rcfg.norm_eps)
    xt = h.reshape(-1, rcfg.d_model)
    t = xt.shape[0]
    probs = jax.nn.softmax(jnp.einsum("td,de->te", xt.astype(jnp.float32), chan["router"]), -1)
    vals, ids = jax.lax.top_k(probs, m.top_k)
    vals = vals / jnp.maximum(vals.sum(-1, keepdims=True), 1e-9)
    match = ids[:, :, None] == jnp.arange(m.num_experts)[None, None, :]
    gate = jnp.einsum("tk,tke->te", vals, match.astype(vals.dtype))
    top_gate, top_idx = jax.lax.top_k(jnp.where(gate > 0, gate, -1.0).T,
                                      r_ffn._capacity(t, rcfg))
    kept = np.zeros((t, m.num_experts), bool)
    for e in range(m.num_experts):
        kept[np.asarray(top_idx[e])[np.asarray(top_gate[e]) > 0], e] = True
    return np.asarray(gate > 0) & ~kept


def recount(gate: np.ndarray, cap: int) -> np.ndarray:
    """Brute force: a route is dropped when at least cap routes to its
    expert rank above it (a higher gate, or an equal gate and a lower token
    index)."""
    t, e = gate.shape
    out = np.zeros_like(gate, dtype=bool)
    for j in range(e):
        for i in range(t):
            if gate[i, j] > 0:
                above = (gate[:, j] > gate[i, j]) | ((gate[:, j] == gate[i, j])
                                                     & (np.arange(t) < i))
                out[i, j] = above.sum() >= cap
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_forward_matches_reference(case):
    cfg, want, _, params, x = moe_case(case)
    with torch.no_grad():
        got = ffn.moe_forward(params, torch.from_numpy(x), cfg)
    assert got.shape == (B, S, cfg.d_model) and got.dtype == torch.float32
    err = float(np.abs(got.numpy() - want).max())
    assert err <= TOL * float(np.abs(want).max()), err


@pytest.mark.parametrize("case", sorted(CASES))
def test_dropped_routes_match_reference(case):
    """The same (token, expert) routes dropped as the reference drops; none
    at the drop-free capacity, some at 1.25 (the skewed inputs overflow)."""
    cfg, _, want, params, x = moe_case(case)
    h = rmsnorm(torch.from_numpy(x), params["ln"], cfg.norm_eps)
    got = ffn.moe_dropped(params, h, cfg).numpy()
    np.testing.assert_array_equal(got, want)
    if cfg.moe.capacity_factor >= 8.0:
        assert not got.any()
    else:
        assert got.sum() > 0, "no expert overflowed: the case tests nothing"
    gate = ffn._route(params["router"], h.reshape(-1, cfg.d_model), cfg).numpy()
    np.testing.assert_array_equal(got, recount(gate, ffn._capacity(B * S, cfg)))


def test_top1_ties_keep_the_lowest_token_indices():
    """Equal weights: `_top` keeps the lowest indices, in index order, as
    jax.lax.top_k does."""
    score = torch.tensor([[1.0, -1.0, 1.0, 1.0, -1.0, 1.0, 1.0, 1.0]])
    vals, idx = ffn._top(score, 4)
    want_v, want_i = jax.lax.top_k(jnp.asarray(score.numpy()), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))
    assert idx.tolist() == [[0, 2, 3, 5]]


def test_capacity_matches_reference():
    for arch in ("llama4_scout_17b_a16e", "deepseek_v3_671b"):
        for smoke in (False, True):
            cfg, rcfg = get_arch(arch, smoke=smoke), r_get_arch(arch, smoke=smoke)
            for t in (1, 2, 7, 64, 256, 1000, 4096):
                assert ffn._capacity(t, cfg) == r_ffn._capacity(t, rcfg)
