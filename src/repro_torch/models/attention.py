"""Attention mixers: GQA (full and local) and MLA, prefill, training and
decode paths (plain PyTorch).

Counterpart of `repro.models.attention`. Prefill and training
attention is the reference's flash formulation: a loop over query chunks
with an inner loop over only the causally reachable (and, with a window,
window-reachable) KV chunks, carrying online-softmax statistics in f32. It
keeps peak memory at one (Tq, Tk) score tile per head group.

The backward is the reference's `_flash_bwd_impl`, attached to the forward
by `_FlashCore`, a `torch.autograd.Function` (the reference's `custom_vjp`
`_flash_core`): a loop over KV chunks accumulating dk and dv, an inner loop
over only the reachable query chunks, dq accumulated across them. It saves
q, k, v, the output and the log-sum-exp, never a score tile. Under
`torch.no_grad()` the same forward runs and nothing is kept.

Decode attends one query position against the whole KV cache. Local
attention's cache is a ring of min(s_max, window) slots (`gqa_decode`);
MLA decodes against its latent cache with the absorbed matrices
(`mla_decode`).

Precision follows the reference: the score and PV products take their
inputs at the activations' dtype and accumulate and return f32 (the
reference's `preferred_element_type=jnp.float32`). A bf16 input is exact in
f32, so the products run on f32 copies (f64 inputs stay f64, which lets
`torch.autograd.gradcheck` hold the backward); on the card they need TF32
off, which is torch's default for matrix products.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig

_NEG = -1e30


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm in f32, cast back to x's dtype before the weight multiplies."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on half-split pairs. x: (..., S, H, hd), positions:
    (..., S). Angles, cos and sin in f32; the result in x's dtype."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., :, None].float() * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _f32(t: torch.Tensor) -> torch.Tensor:
    """t widened to f32 (an f64 tensor stays f64)."""
    return t if t.dtype in (torch.float32, torch.float64) else t.float()


def _chunk_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int | None) -> torch.Tensor:
    mask = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    return mask


def _flash_fwd(q, k, v, window, chunk_q: int, chunk_k: int, scale: float):
    """(out (B, S, KV, G, vd) in q's dtype, lse (B, S, KV, G) f32), the
    reference's `_flash_fwd_impl`: each query chunk visits only its
    reachable KV chunks."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    vd = v.shape[-1]
    g = h // kv
    nq, nk = s // chunk_q, s // chunk_k
    qr = q.reshape(b, nq, chunk_q, kv, g, hd)
    kr = k.reshape(b, nk, chunk_k, kv, hd)
    vr = v.reshape(b, nk, chunk_k, kv, vd)
    ar = torch.arange(max(chunk_q, chunk_k), device=q.device)
    acc_dtype = torch.promote_types(q.dtype, torch.float32)
    outs, lses = [], []
    for i in range(nq):
        qc = _f32(qr[:, i])
        q_pos = i * chunk_q + ar[:chunk_q]
        j_hi = (i + 1) * chunk_q // chunk_k
        j_lo = 0 if window is None else max(i * chunk_q - (window - 1), 0) // chunk_k
        acc = torch.zeros((b, chunk_q, kv, g, vd), dtype=acc_dtype, device=q.device)
        m = torch.full((b, chunk_q, kv, g), _NEG, dtype=acc_dtype, device=q.device)
        l = torch.zeros((b, chunk_q, kv, g), dtype=acc_dtype, device=q.device)
        for j in range(j_lo, j_hi):
            kc, vc = kr[:, j], vr[:, j]
            k_pos = j * chunk_k + ar[:chunk_k]
            scores = torch.einsum("bqkgd,btkd->bqkgt", qc, _f32(kc)) * scale
            mask = _chunk_mask(q_pos, k_pos, window)
            scores = torch.where(mask[None, :, None, None, :], scores, _NEG)
            m_new = torch.maximum(m, scores.amax(dim=-1))
            p = torch.exp(scores - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bqkgt,btkd->bqkgd", _f32(p.to(vc.dtype)), _f32(vc))
            acc = acc * alpha[..., None] + pv
            m = m_new
        l_safe = torch.clamp_min(l, 1e-30)
        outs.append((acc / l_safe[..., None]).to(q.dtype))
        lses.append(m + torch.log(l_safe))
    out = torch.stack(outs, dim=1).reshape(b, s, kv, g, vd)
    lse = torch.stack(lses, dim=1).reshape(b, s, kv, g)
    return out, lse


def _flash_bwd(q, k, v, out, lse, do, window, chunk_q: int, chunk_k: int, scale: float):
    """(dq, dk, dv) in q's, k's and v's dtypes, the reference's
    `_flash_bwd_impl`. out and do are (B, S, H, vd), lse (B, S, KV, G).
    Each KV chunk j visits the query chunks i_lo..i_hi that reach it; the
    probabilities are recomputed from lse, and every product runs in f32."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    vd = v.shape[-1]
    g = h // kv
    nq, nk = s // chunk_q, s // chunk_k
    qr = q.reshape(b, nq, chunk_q, kv, g, hd)
    kr = k.reshape(b, nk, chunk_k, kv, hd)
    vr = v.reshape(b, nk, chunk_k, kv, vd)
    dor = do.reshape(b, nq, chunk_q, kv, g, vd)
    lser = lse.reshape(b, nq, chunk_q, kv, g)
    # delta_i = rowsum(do * out)
    delta = torch.sum(_f32(do) * _f32(out), dim=-1)
    deltar = delta.reshape(b, nq, chunk_q, kv, g)
    ar = torch.arange(max(chunk_q, chunk_k), device=q.device)
    acc_dtype = torch.promote_types(q.dtype, torch.float32)
    dq = torch.zeros((b, nq, chunk_q, kv, g, hd), dtype=acc_dtype, device=q.device)
    dks, dvs = [], []
    for j in range(nk):
        kc, vc = _f32(kr[:, j]), _f32(vr[:, j])
        k_pos = j * chunk_k + ar[:chunk_k]
        i_lo = (j * chunk_k) // chunk_q
        i_hi = nq if window is None else min(((j + 1) * chunk_k - 1 + window - 1) // chunk_q + 1,
                                              nq)
        dk_j = torch.zeros((b, chunk_k, kv, hd), dtype=acc_dtype, device=q.device)
        dv_j = torch.zeros((b, chunk_k, kv, vd), dtype=acc_dtype, device=q.device)
        for i in range(i_lo, i_hi):
            qc, doc = _f32(qr[:, i]), _f32(dor[:, i])
            q_pos = i * chunk_q + ar[:chunk_q]
            scores = torch.einsum("bqkgd,btkd->bqkgt", qc, kc) * scale
            mask = _chunk_mask(q_pos, k_pos, window)
            p = torch.where(mask[None, :, None, None, :],
                            torch.exp(scores - lser[:, i][..., None]), 0.0)
            dv_j = dv_j + torch.einsum("bqkgt,bqkgd->btkd", p, doc)
            dp = torch.einsum("bqkgd,btkd->bqkgt", doc, vc)
            ds = p * (dp - deltar[:, i][..., None]) * scale
            dq[:, i] += torch.einsum("bqkgt,btkd->bqkgd", ds, kc)
            dk_j = dk_j + torch.einsum("bqkgt,bqkgd->btkd", ds, qc)
        dks.append(dk_j)
        dvs.append(dv_j)
    dq = dq.reshape(b, s, h, hd).to(q.dtype)
    dk = torch.stack(dks, dim=1).reshape(b, s, kv, hd).to(k.dtype)
    dv = torch.stack(dvs, dim=1).reshape(b, s, kv, vd).to(v.dtype)
    return dq, dk, dv


class _FlashCore(torch.autograd.Function):
    """The flash forward with the flash backward as its gradient: (q, k, v)
    -> out (B, S, KV, G, vd), the reference's `_flash_core`. Saves q, k, v,
    out and lse; the window, chunks and scale are constants."""

    @staticmethod
    def forward(ctx, q, k, v, window, chunk_q: int, chunk_k: int, scale: float):
        out, lse = _flash_fwd(q, k, v, window, chunk_q, chunk_k, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.consts = (window, chunk_q, chunk_k, scale)
        return out

    @staticmethod
    def backward(ctx, g_out):
        q, k, v, out, lse = ctx.saved_tensors
        b, s, kv, grp, vd = out.shape
        dq, dk, dv = _flash_bwd(q, k, v, out.reshape(b, s, kv * grp, vd), lse,
                                g_out.reshape(b, s, kv * grp, vd), *ctx.consts)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int | None = None, chunk_q: int = 512, chunk_k: int = 512,
                    scale: float | None = None) -> torch.Tensor:
    """Causal (optionally windowed) flash attention (`_FlashCore`: the flash
    backward is its gradient).

    q (B, S, H, hd), k (B, S, KV, hd), v (B, S, KV, vd) -> (B, S, H, vd) in
    q's dtype. Chunks of min(512, S); S must divide by them, as the
    reference asserts."""
    b, s, h, hd = q.shape
    vd = v.shape[-1]
    scale = scale if scale is not None else hd ** -0.5
    chunk_q = min(chunk_q, s)
    chunk_k = min(chunk_k, s)
    if s % chunk_q or s % chunk_k:
        raise ValueError(f"sequence length {s} does not divide by the chunks "
                         f"({chunk_q}, {chunk_k})")
    return _FlashCore.apply(q, k, v, window, chunk_q, chunk_k, scale).reshape(b, s, h, vd)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int,
                     *, window: int | None = None, scale: float | None = None) -> torch.Tensor:
    """One-token attention against the full cache.

    q (B, 1, H, hd), caches (B, S_max, KV, hd | vd), pos the number of
    cached tokens before this one. f32 scores; (p / l) cast to the cache's
    dtype before the PV product."""
    b, _, h, hd = q.shape
    kv = k_cache.shape[2]
    g = h // kv
    scale = scale if scale is not None else hd ** -0.5
    qh = q.reshape(b, kv, g, hd) * scale
    scores = torch.einsum("bkgd,btkd->bkgt", _f32(qh), _f32(k_cache))
    k_pos = torch.arange(k_cache.shape[1], device=q.device)
    mask = k_pos[None, :] <= pos
    if window is not None:
        mask &= (pos - k_pos[None, :]) < window
    scores = torch.where(mask[:, None, None, :], scores, _NEG)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgt,btkd->bkgd", _f32((p / l).to(v_cache.dtype)), _f32(v_cache))
    return out.reshape(b, 1, h, -1).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------


def _qkv(params: dict, h: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig):
    q = torch.einsum("bsd,dhe->bshe", h, params["wq"])
    k = torch.einsum("bsd,dke->bske", h, params["wk"])
    v = torch.einsum("bsd,dke->bske", h, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


def gqa_forward(params: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig, *,
                window: int | None = None):
    """Full-sequence GQA (prefill). Returns (out, (k, v))."""
    h = rmsnorm(x, params["ln"], cfg.norm_eps)
    q, k, v = _qkv(params, h, positions, cfg)
    out = flash_attention(q, k, v, window=window)
    return torch.einsum("bshe,hed->bsd", out, params["wo"]), (k, v)


def gqa_decode(params: dict, x: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               pos: int, cfg: ArchConfig, *, window: int | None = None):
    """Single-token GQA. Writes this token's k and v into the caches in
    place at pos % cache_len (the reference's `dynamic_update_slice` on a
    donated cache) and returns (out, (k_cache, v_cache)).

    Local attention (a window) keeps a ring of L = min(s_max, window) slots,
    as `models.model.cache_specs` sizes it: keys carry their absolute rotary
    embedding, so once the ring has wrapped it holds exactly the window's
    keys and needs no mask; before that (pos < L) the slots past pos are
    masked. Full attention is the same formula with L = s_max. The
    reference's decode writes at pos % s_max into a cache that its prefill
    pads to s_max and attends to all of it, which equals this below the
    window only (ROADMAP queue 3); this is its forward's window."""
    del window  # the ring's length carries it
    h = rmsnorm(x, params["ln"], cfg.norm_eps)
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(params, h, positions, cfg)
    write_idx = pos % k_cache.shape[1]
    k_cache[:, write_idx] = k[:, 0]
    v_cache[:, write_idx] = v[:, 0]
    out = decode_attention(q, k_cache, v_cache, pos)
    return torch.einsum("bshe,hed->bsd", out, params["wo"]), (k_cache, v_cache)


# ---------------------------------------------------------------------------
# MLA block (DeepSeek-V3)
# ---------------------------------------------------------------------------


def _mla_qkv(params: dict, h: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig):
    """(q_nope, q_rope, c_kv, k_rope): the query through its low-rank
    projection and norm, the latent c_kv (B, S, r) and the shared rotary
    key (B, S, 1, rope_hd)."""
    m = cfg.mla
    q_lat = rmsnorm(torch.einsum("bsd,dr->bsr", h, params["wq_a"]), params["q_norm"],
                    cfg.norm_eps)
    q = torch.einsum("bsr,rhe->bshe", q_lat, params["wq_b"])
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    kv_a = torch.einsum("bsd,dr->bsr", h, params["wkv_a"])
    c_kv = rmsnorm(kv_a[..., :m.kv_lora_rank], params["kv_norm"], cfg.norm_eps)
    k_rope = rope(kv_a[..., m.kv_lora_rank:][:, :, None, :], positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def _mla_scale(cfg: ArchConfig) -> float:
    return (cfg.mla.nope_head_dim + cfg.mla.rope_head_dim) ** -0.5


def mla_forward(params: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig):
    """Full-sequence MLA (prefill, training): per-head K and V expanded from
    the latent, then the flash attention (qk dim nope + rope, v dim
    v_head_dim; its backward is `_FlashCore`'s). Returns (out, (c_kv,
    k_rope))."""
    m = cfg.mla
    h = rmsnorm(x, params["ln"], cfg.norm_eps)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(params, h, positions, cfg)
    k_nope = torch.einsum("bsr,rhe->bshe", c_kv, params["wk_b"])
    v = torch.einsum("bsr,rhe->bshe", c_kv, params["wv_b"])
    k_rope_b = k_rope.expand(*k_rope.shape[:2], cfg.n_heads, m.rope_head_dim)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope_b], dim=-1)
    out = flash_attention(q_full, k_full, v, scale=_mla_scale(cfg))
    return torch.einsum("bshe,hed->bsd", out, params["wo"]), (c_kv, k_rope)


def mla_decode(params: dict, x: torch.Tensor, ckv_cache: torch.Tensor,
               krope_cache: torch.Tensor, pos: int, cfg: ArchConfig):
    """Absorbed-matrix MLA decode: scores straight against the latent cache.

    scores = (q_nope W_uk) . c_kv + q_rope . k_rope, so the per-head K is
    never formed; the value path contracts the latent first. Writes this
    token's c_kv and k_rope into the caches (B, S_max, r) and (B, S_max, 1,
    rope_hd) in place at pos. Scores and context in f32, the mask k_pos <=
    pos; p is cast to the cache's dtype, the context to x's. Returns (out,
    (ckv_cache, krope_cache))."""
    b = x.shape[0]
    h = rmsnorm(x, params["ln"], cfg.norm_eps)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv(params, h, positions, cfg)
    ckv_cache[:, pos] = c_kv_new[:, 0]
    krope_cache[:, pos] = k_rope_new[:, 0]

    # absorb W_uk into q: (B, 1, H, nope) x (r, H, nope) -> (B, H, r)
    q_lat = torch.einsum("bshe,rhe->bhr", q_nope, params["wk_b"])
    scores = (torch.einsum("bhr,btr->bht", _f32(q_lat), _f32(ckv_cache))
              + torch.einsum("bshe,bte->bht", _f32(q_rope), _f32(krope_cache[:, :, 0, :]))
              ) * _mla_scale(cfg)
    k_pos = torch.arange(ckv_cache.shape[1], device=x.device)
    scores = torch.where(k_pos[None, None, :] <= pos, scores, _NEG)
    p = torch.softmax(scores, dim=-1)
    ctx_lat = torch.einsum("bht,btr->bhr", _f32(p.to(ckv_cache.dtype)), _f32(ckv_cache))
    out = torch.einsum("bhr,rhe->bhe", ctx_lat.to(x.dtype), params["wv_b"])
    out = torch.einsum("bhe,hed->bd", out, params["wo"])[:, None, :]
    return out, (ckv_cache, krope_cache)
