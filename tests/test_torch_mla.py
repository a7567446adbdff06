"""The port's MLA (DeepSeek-V3's multi-head latent attention) against
`repro.models.attention`: the full-sequence forward (expanded K and V
through the flash attention), its gradients, and the absorbed-matrix
decode against the latent cache.

Weights: layer 0's mixer of the reference's smoke config (`init_params`),
carried across with `lm_params_from_reference`; inputs from seeded numpy
generators. f32 throughout (the reference's own serving test holds MLA in
f32). Tolerances: outputs and caches within 1e-5 absolute (O(1) values,
products summed in other orders); gradients within 1e-4 of each one's
largest magnitude.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as r_get_arch
from repro.models import attention as r_attn
from repro.models import params as r_params
from repro_torch.configs.base import get_arch
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import attention as attn
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

ARCH = "deepseek_v3_671b"
TOL, GRAD_TOL = 1e-5, 1e-4
B, S0, S = 2, 16, 24


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy().copy()
    return np.asarray(a, np.float32)


@pytest.fixture(scope="module")
def mla():
    rcfg = r_get_arch(ARCH, smoke=True)
    tree = r_params.init_params(rcfg, jax.random.PRNGKey(2), dtype=jnp.float32)
    mix = jax.tree.map(lambda a: np.asarray(a)[0], tree["segments"][0]["blocks"][0]["mixer"])
    x = np.random.default_rng(0).normal(size=(B, S, rcfg.d_model)).astype(np.float32)
    return rcfg, get_arch(ARCH, smoke=True), jax.tree.map(jnp.asarray, mix), \
        lm_params_from_reference(mix, device="cpu"), x


@functools.cache
def ref_fns():
    cfg = r_get_arch(ARCH, smoke=True)
    return (jax.jit(lambda p, x, pos: r_attn.mla_forward(p, x, pos, cfg)),
            jax.jit(lambda p, x, c, k, pos: r_attn.mla_decode(p, x, c, k, pos, cfg)))


def positions(b: int, s: int, lib):
    if lib is torch:
        return torch.arange(s, dtype=torch.int32)[None].expand(b, s)
    return jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (b, s))


def test_forward_matches_reference(mla):
    _, cfg, pj, pt, x = mla
    out_r, (ckv_r, krope_r) = ref_fns()[0](pj, jnp.asarray(x), positions(B, S, jnp))
    with torch.no_grad():
        out, (ckv, krope) = attn.mla_forward(pt, torch.from_numpy(x), positions(B, S, torch),
                                             cfg)
    assert out.shape == (B, S, cfg.d_model)
    assert ckv.shape == (B, S, cfg.mla.kv_lora_rank)
    assert krope.shape == (B, S, 1, cfg.mla.rope_head_dim)
    for got, want in ((out, out_r), (ckv, ckv_r), (krope, krope_r)):
        np.testing.assert_allclose(f32(got), f32(want), rtol=0, atol=TOL)


def test_forward_gradients_match_reference(mla):
    """Through the flash backward at qk dim nope + rope and v dim
    v_head_dim (unequal), against jax.grad of the reference's forward."""
    _, cfg, pj, pt, x = mla
    cot = np.random.default_rng(1).normal(size=(B, S, cfg.d_model)).astype(np.float32)
    fwd_r = ref_fns()[0]
    g_r = jax.jit(jax.grad(lambda p, xx: jnp.sum(fwd_r(p, xx, positions(B, S, jnp))[0] * cot),
                           argnums=(0, 1)))(pj, jnp.asarray(x))
    live = {k: v.clone().requires_grad_() for k, v in pt.items()}
    x_live = torch.from_numpy(x).requires_grad_()
    out, _ = attn.mla_forward(live, x_live, positions(B, S, torch), cfg)
    (out * torch.from_numpy(cot)).sum().backward()
    for got, want in [(live[k].grad, g_r[0][k]) for k in sorted(live)] + [(x_live.grad, g_r[1])]:
        want = f32(want)
        err = float(np.abs(f32(got) - want).max())
        assert err <= GRAD_TOL * max(float(np.abs(want).max()), 1e-30), err


def test_absorbed_decode_matches_reference(mla):
    """Prefill's latent caches (the forward on the first S0 positions,
    right-padded to S), then a decode step at each later position: outputs
    and both caches against the reference's, and the outputs against the
    full forward's at the same positions (the absorbed form is exact)."""
    _, cfg, pj, pt, x = mla
    fwd_r, dec_r = ref_fns()
    _, (ckv_r, krope_r) = fwd_r(pj, jnp.asarray(x[:, :S0]), positions(B, S0, jnp))
    ckv_r = jnp.pad(ckv_r, ((0, 0), (0, S - S0), (0, 0)))
    krope_r = jnp.pad(krope_r, ((0, 0), (0, S - S0), (0, 0), (0, 0)))
    ckv, krope = torch.from_numpy(f32(ckv_r)), torch.from_numpy(f32(krope_r))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        full, _ = attn.mla_forward(pt, xt, positions(B, S, torch), cfg)
        for pos in range(S0, S):
            out_r, (ckv_r, krope_r) = dec_r(pj, jnp.asarray(x[:, pos:pos + 1]), ckv_r, krope_r,
                                            jnp.int32(pos))
            out, (ckv_o, krope_o) = attn.mla_decode(pt, xt[:, pos:pos + 1], ckv, krope, pos, cfg)
            assert ckv_o is ckv and krope_o is krope        # written in place
            np.testing.assert_allclose(f32(out), f32(out_r), rtol=0, atol=TOL)
            np.testing.assert_allclose(f32(out[:, 0]), f32(full[:, pos]), rtol=0, atol=TOL)
            np.testing.assert_allclose(f32(ckv), f32(ckv_r), rtol=0, atol=TOL)
            np.testing.assert_allclose(f32(krope), f32(krope_r), rtol=0, atol=TOL)
