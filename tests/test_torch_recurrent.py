"""The port's recurrent mixers against `repro.models.recurrent`: the causal
conv, RG-LRU (the log-depth scan) and Mamba2's chunked SSD, over a
sequence and step by step, from zero and from a carried state and tail.

Weights: the reference's `init_params` (smoke configs) draws them and
`repro_torch.convert.lm_params_from_reference` carries them across; the
RG-LRU gate weights, zeros at init, are replaced by seeded normal draws on
both sides so the gates vary by channel and input. Inputs are numpy arrays
from seeded generators.

Tolerances: in f32 every output, state and tail within 1e-5 absolute (the
outputs are O(1–10); the scans sum in other orders: a log-depth tree
against `associative_scan`'s, a loop over chunks against `lax.scan`). In
bf16 the reference's serving test's rule, on the output's channels in place
of a vocabulary: max |difference| under 0.2 and argmax agreement at least
0.85.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as r_get_arch
from repro.models import params as r_params
from repro.models import recurrent as r_rec
from repro_torch.configs.base import get_arch
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import recurrent as rec
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

F32_TOL = 1e-5
BF16_TOL, BF16_AGREE = 0.2, 0.85
B = 2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MIXERS = {"rglru": "recurrentgemma_2b", "ssd": "mamba2_1_3b"}


def mixer_params(kind: str, dtype: str):
    """Layer 0's mixer of the smoke config: (cfg, the reference's leaves as
    jax arrays, the same carried to torch)."""
    arch = MIXERS[kind]
    rcfg = r_get_arch(arch, smoke=True)
    tree = r_params.init_params(rcfg, jax.random.PRNGKey(1), dtype=DTYPES[dtype][0])
    mix = jax.tree.map(lambda a: np.asarray(a)[0], tree["segments"][0]["blocks"][0]["mixer"])
    if kind == "rglru":
        rng = np.random.default_rng(11)
        for key in ("wa", "ba", "wi_g", "bi_g"):
            mix[key] = rng.normal(size=mix[key].shape).astype(np.float32)
    return (get_arch(arch, smoke=True), jax.tree.map(jnp.asarray, mix),
            lm_params_from_reference(mix, device="cpu"))


@functools.cache
def ref_fns(kind: str):
    """The reference's forward and decode for this kind, jitted (op by op
    they take seconds a call)."""
    cfg = r_get_arch(MIXERS[kind], smoke=True)
    fwd, dec = ((r_rec.rglru_forward, r_rec.rglru_decode) if kind == "rglru"
                else (r_rec.ssd_forward, r_rec.ssd_decode))
    return (jax.jit(lambda p, x, s=None, t=None: fwd(p, x, cfg, s, t)),
            jax.jit(lambda p, x, s, t: dec(p, x, s, t, cfg)))


@pytest.fixture(scope="module")
def weights():
    return {(k, d): mixer_params(k, d) for k in MIXERS for d in DTYPES}


def inputs(shape, dtype: str, seed: int):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(x).astype(DTYPES[dtype][0]), torch.from_numpy(x).to(DTYPES[dtype][1])


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(a, np.float32)     # a writable copy


def assert_close(ours, theirs, dtype: str, what: str):
    a, b = f32(ours), f32(theirs)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = float(np.abs(a - b).max())
    if dtype == "float32":
        assert err <= F32_TOL, (what, err)
        return
    assert err < BF16_TOL, (what, err)
    agree = float((a.argmax(-1) == b.argmax(-1)).mean())
    assert agree >= BF16_AGREE, (what, agree)


@pytest.mark.parametrize("width", [1, 4])
@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv1d_matches_reference(width, with_tail):
    xj, xt = inputs((B, 9, 6), "float32", 0)
    wj, wt = inputs((width, 6), "float32", 1)
    tj, tt = inputs((B, width - 1, 6), "float32", 2) if with_tail else (None, None)
    out_r, tail_r = r_rec.causal_conv1d(xj, wj, tj)
    out, tail = rec.causal_conv1d(xt, wt, tt)
    np.testing.assert_allclose(f32(out), f32(out_r), rtol=0, atol=1e-6)
    np.testing.assert_allclose(f32(tail), f32(tail_r), rtol=0, atol=0)


def test_linear_scan_matches_a_loop():
    """The log-depth scan gives the recurrence h_t = a_t h_{t-1} + b_t at
    every length, powers of two and not."""
    rng = np.random.default_rng(3)
    for s in (1, 2, 5, 16, 37):
        la = torch.from_numpy(-rng.uniform(0, 0.5, size=(2, s, 3)))
        b = torch.from_numpy(rng.normal(size=(2, s, 3)))
        h, want = torch.zeros(2, 3, dtype=torch.float64), []
        for t in range(s):
            h = torch.exp(la[:, t]) * h + b[:, t]
            want.append(h)
        np.testing.assert_allclose(rec._linear_scan(la, b).numpy(),
                                   torch.stack(want, 1).numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", sorted(MIXERS))
@pytest.mark.parametrize("carried", [False, True])
def test_forward_matches_reference(weights, kind, dtype, carried):
    """The mixer over a sequence (SSD: four chunks), from zeros or from a
    carried state and conv tail."""
    cfg, pj, pt = weights[(kind, dtype)]
    seq = 4 * cfg.ssm.chunk if kind == "ssd" else 40
    xj, xt = inputs((B, seq, cfg.d_model), dtype, 5)
    state = tail = None
    if carried:
        # the state and tail a prefix of the same kind leaves behind
        pj_, _ = inputs((B, seq // 2, cfg.d_model), dtype, 6)
        _, (state_j, tail_j) = ref_fns(kind)[0](pj, pj_)
        state = torch.from_numpy(f32(state_j))
        tail = torch.from_numpy(f32(tail_j)).to(DTYPES[dtype][1])
        out_r, (s_r, t_r) = ref_fns(kind)[0](pj, xj, state_j, tail_j)
    else:
        out_r, (s_r, t_r) = ref_fns(kind)[0](pj, xj)
    fwd = rec.rglru_forward if kind == "rglru" else rec.ssd_forward
    out, (s, t) = fwd(pt, xt, cfg, state, tail)
    assert out.dtype == DTYPES[dtype][1] and s.dtype == torch.float32
    assert_close(out, out_r, dtype, "out")
    assert_close(t, t_r, dtype, "tail")
    assert_close(s, s_r, dtype, "state")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", sorted(MIXERS))
def test_decode_steps_match_reference(weights, kind, dtype):
    """A prefix through the forward, then six single-token steps, each fed
    the state and tail the previous one left."""
    cfg, pj, pt = weights[(kind, dtype)]
    seq = 2 * cfg.ssm.chunk if kind == "ssd" else 12
    xj, xt = inputs((B, seq + 6, cfg.d_model), dtype, 8)
    fwd_r, dec_r = ref_fns(kind)
    fwd, dec = (rec.rglru_forward, rec.rglru_decode) if kind == "rglru" else (
        rec.ssd_forward, rec.ssd_decode)
    _, (s_r, t_r) = fwd_r(pj, xj[:, :seq])
    _, (s, t) = fwd(pt, xt[:, :seq], cfg)
    for i in range(seq, seq + 6):
        out_r, (s_r, t_r) = dec_r(pj, xj[:, i:i + 1], s_r, t_r)
        out, (s, t) = dec(pt, xt[:, i:i + 1], s, t, cfg)
        assert out.shape == (B, 1, cfg.d_model)
        assert_close(out, out_r, dtype, f"step {i}")
        assert_close(t, t_r, dtype, f"tail {i}")
        assert_close(s, s_r, dtype, f"state {i}")


@pytest.mark.parametrize("kind", sorted(MIXERS))
def test_decode_continues_the_forward(weights, kind):
    """In f32, the forward over a sequence equals the forward over its first
    part followed by single steps: the chunked and recurrent forms agree."""
    cfg, _, pt = weights[(kind, "float32")]
    seq = 3 * cfg.ssm.chunk if kind == "ssd" else 24
    _, xt = inputs((B, seq, cfg.d_model), "float32", 9)
    fwd, dec = (rec.rglru_forward, rec.rglru_decode) if kind == "rglru" else (
        rec.ssd_forward, rec.ssd_decode)
    want, _ = fwd(pt, xt, cfg)
    half = seq - (cfg.ssm.chunk if kind == "ssd" else 8)
    _, (s, t) = fwd(pt, xt[:, :half], cfg)
    for i in range(half, seq):
        out, (s, t) = dec(pt, xt[:, i:i + 1], s, t, cfg)
        np.testing.assert_allclose(f32(out[:, 0]), f32(want[:, i]), rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("kind", sorted(MIXERS))
def test_gradients_match_reference(weights, kind):
    """Autograd through the scan and the chunked SSD against jax.grad, f32:
    each gradient within 1e-4 of its largest magnitude."""
    cfg, pj, pt = weights[(kind, "float32")]
    seq = 2 * cfg.ssm.chunk if kind == "ssd" else 16
    xj, xt = inputs((B, seq, cfg.d_model), "float32", 10)
    cot = np.random.default_rng(12).normal(size=(B, seq, cfg.d_model)).astype(np.float32)
    fwd_r = ref_fns(kind)[0]
    fwd = rec.rglru_forward if kind == "rglru" else rec.ssd_forward
    g_r = jax.jit(jax.grad(lambda p, x: jnp.sum(fwd_r(p, x)[0] * cot), argnums=(0, 1)))(pj, xj)
    live = {k: v.clone().requires_grad_() for k, v in pt.items()}
    x_live = xt.clone().requires_grad_()
    (fwd(live, x_live, cfg)[0] * torch.from_numpy(cot)).sum().backward()
    pairs = [(live[k].grad, g_r[0][k]) for k in sorted(live)] + [(x_live.grad, g_r[1])]
    for got, want in pairs:
        want = f32(want)
        err = float(np.abs(f32(got) - want).max())
        assert err <= 1e-4 * max(float(np.abs(want).max()), 1e-30), err
