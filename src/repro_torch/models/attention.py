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

On a mesh (an `rt` with more than one 'model' rank) the mixers split by
query heads where the ranks divide them (`_gqa_weights`, `_mla_weights`),
and a decode cache split over the sequence is scored window by window,
the ranks' softmax combined over 'model' (`decode_attention`,
`_split_softmax`, `cache_write`).

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
from repro_torch.dist import comm
from repro_torch.dist.sharding import tp_split
from repro_torch.dist.tp import body_weights, split_out

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
                     *, window: int | None = None, scale: float | None = None,
                     rt=None) -> torch.Tensor:
    """One-token attention against the full cache.

    q (B, 1, H, hd), caches (B, S_max, KV, hd | vd), pos the number of
    cached tokens before this one. f32 scores; (p / l) cast to the cache's
    dtype before the PV product.

    With rt, the caches are this 'model' rank's window of the sequence
    (slots rank * S_loc onwards; the sequence-split decode): the max over
    the slots and the sum of exp are all-reduced over 'model' before p / l
    is formed, and the PV products are summed over 'model', so the result
    is the whole cache's on every rank."""
    b, _, h, hd = q.shape
    kv = k_cache.shape[2]
    g = h // kv
    scale = scale if scale is not None else hd ** -0.5
    qh = q.reshape(b, kv, g, hd) * scale
    scores = torch.einsum("bkgd,btkd->bkgt", _f32(qh), _f32(k_cache))
    k_pos = _slot_positions(k_cache.shape[1], q.device, rt)
    mask = k_pos[None, :] <= pos
    if window is not None:
        mask &= (pos - k_pos[None, :]) < window
    scores = torch.where(mask[:, None, None, :], scores, _NEG)
    p = _split_softmax(scores, rt)
    out = torch.einsum("bkgt,btkd->bkgd", _f32(p.to(v_cache.dtype)), _f32(v_cache))
    if rt is not None:
        out = comm.all_reduce(out, rt, (rt.tp_axis,))
    return out.reshape(b, 1, h, -1).to(q.dtype)


def _slot_positions(n: int, device, rt=None) -> torch.Tensor:
    """The global slot indices of a cache window of n slots: 0.. off a
    split, this 'model' rank's window on one."""
    off = 0 if rt is None else rt.tp_rank * n
    return off + torch.arange(n, device=device)


def _split_softmax(scores: torch.Tensor, rt=None) -> torch.Tensor:
    """softmax over the last dim, which rt (when given) splits over
    'model': the max and the sum of exp all-reduced over it."""
    m = scores.amax(dim=-1, keepdim=True)
    if rt is not None:
        m = comm.all_reduce(m, rt, (rt.tp_axis,), op="max")
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    if rt is not None:
        l = comm.all_reduce(l, rt, (rt.tp_axis,))
    return p / l


def cache_write(cache: torch.Tensor, slot: int, value: torch.Tensor, rt=None) -> None:
    """cache[:, slot] = value, where slot is global: on a sequence-split
    cache (rt given) only the 'model' rank whose window holds it writes."""
    n = cache.shape[1]
    if rt is None:
        cache[:, slot] = value
    elif slot // n == rt.tp_rank:
        cache[:, slot % n] = value


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------


def _kv(params: dict, h: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig, kv_idx=None):
    """k (rotary embedded) and v of the normed input h; with kv_idx, of
    those KV heads only (a 'model' rank's, `_kv_index`)."""
    wk, wv = params["wk"], params["wv"]
    bk, bv = params.get("bk"), params.get("bv")
    if kv_idx is not None:
        wk, wv = wk[:, kv_idx], wv[:, kv_idx]
        if cfg.qkv_bias:
            bk, bv = bk[kv_idx], bv[kv_idx]
    k = torch.einsum("bsd,dke->bske", h, wk)
    v = torch.einsum("bsd,dke->bske", h, wv)
    if cfg.qkv_bias:
        k = k + bk
        v = v + bv
    return rope(k, positions, cfg.rope_theta), v


def _qkv(params: dict, h: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig, kv_idx=None):
    """q, k, v of the normed input h, rotary embedded (`_kv`)."""
    q = torch.einsum("bsd,dhe->bshe", h, params["wq"])
    if cfg.qkv_bias:
        q = q + params["bq"]
    return (rope(q, positions, cfg.rope_theta), *_kv(params, h, positions, cfg, kv_idx))


def _kv_index(cfg: ArchConfig, rt) -> slice:
    """The KV heads that this 'model' rank's query heads (its 1 / tp_size
    of them, contiguous) attend with: the groups' own heads when whole
    groups land on the rank, the one head they share when the rank holds
    part of one group (`_heads_split`)."""
    g = cfg.n_heads // cfg.n_kv_heads
    h_loc = cfg.n_heads // rt.tp_size
    lo = rt.tp_rank * h_loc
    return slice(lo // g, (lo + h_loc - 1) // g + 1)


def _heads_split(cfg: ArchConfig, rt) -> bool:
    """Whether GQA splits over 'model' by query heads: the ranks divide
    the heads, and each rank's heads are whole KV groups or part of one."""
    if not tp_split(rt, cfg.n_heads):
        return False
    g, h_loc = cfg.n_heads // cfg.n_kv_heads, cfg.n_heads // rt.tp_size
    return h_loc % g == 0 or g % h_loc == 0


def _gqa_weights(params: dict, x: torch.Tensor, cfg: ArchConfig, rt):
    """(weights at use, x, split): split over 'model' by query heads where
    `_heads_split` allows (wq, bq, wo this rank's heads; wk, wv, the
    biases and the norm whole), else every weight gathered whole."""
    split = _heads_split(cfg, rt)
    return (*body_weights(params, x, rt, split, {"wq": 1, "bq": 0, "wo": 0}), split)


def cache_rows(h: torch.Tensor, positions: torch.Tensor, rows: torch.Tensor):
    """(h at rows, their positions, valid): the inputs of a cache window
    whose slots hold the positions `rows` (-1 for an empty slot)."""
    sel = rows.clamp_min(0)
    return h[:, sel], positions[:, sel], (rows >= 0)


def gqa_forward(params: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig, *,
                window: int | None = None, rt=None, rows: torch.Tensor | None = None):
    """Full-sequence GQA (prefill). Returns (out, (k, v)).

    On a mesh whose 'model' ranks divide the heads, each rank attends with
    its query heads against the KV heads they use (`_kv_index`) and the
    output projection's partial sums are summed over 'model'. With rows
    (a 'model' rank's window of a sequence-split cache: the position each
    slot holds, -1 for none), (k, v) are that window's, every KV head,
    zero in empty slots."""
    w, x, split = _gqa_weights(params, x, cfg, rt)
    h = rmsnorm(x, w["ln"], cfg.norm_eps)
    kv_idx = _kv_index(cfg, rt) if split else None
    q, k, v = _qkv(w, h, positions, cfg, kv_idx)
    out = flash_attention(q, k, v, window=window)
    y = split_out(torch.einsum("bshe,hed->bsd", out, w["wo"]), rt, split)
    if rows is None:
        return y, (k, v)
    hr, pr, valid = cache_rows(h, positions, rows)
    k, v = _kv(w, hr, pr, cfg)
    mask = valid[None, :, None, None]
    return y, (torch.where(mask, k, 0.0).to(k.dtype), torch.where(mask, v, 0.0).to(v.dtype))


def gqa_decode(params: dict, x: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               pos: int, cfg: ArchConfig, *, window: int | None = None, rt=None,
               seq_split: bool = False):
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
    window only (ROADMAP queue 3); this is its forward's window.

    On a mesh: the query heads split over 'model' as in `gqa_forward` are
    all-gathered for the one token; with seq_split the caches are this
    'model' rank's window of the slots: the rank that holds slot pos % L
    writes it, and `decode_attention` combines the ranks' partial results
    by their log-sum-exp."""
    del window  # the ring's length carries it
    w, x, split = _gqa_weights(params, x, cfg, rt)
    h = rmsnorm(x, w["ln"], cfg.norm_eps)
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(w, h, positions, cfg)
    if split:
        q = comm.all_gather(q, rt, (rt.tp_axis,), 2)
    srt = rt if seq_split else None
    length = k_cache.shape[1] * (rt.tp_size if seq_split else 1)
    cache_write(k_cache, pos % length, k[:, 0], srt)
    cache_write(v_cache, pos % length, v[:, 0], srt)
    out = decode_attention(q, k_cache, v_cache, pos, rt=srt)
    if split:
        h_loc = w["wo"].shape[0]
        out = out[:, :, rt.tp_rank * h_loc:(rt.tp_rank + 1) * h_loc]
    return split_out(torch.einsum("bshe,hed->bsd", out, w["wo"]), rt, split), (k_cache, v_cache)


# ---------------------------------------------------------------------------
# MLA block (DeepSeek-V3)
# ---------------------------------------------------------------------------


def _mla_q(params: dict, h: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig):
    """(q_nope, q_rope): the query through its low-rank projection and norm."""
    m = cfg.mla
    q_lat = rmsnorm(torch.einsum("bsd,dr->bsr", h, params["wq_a"]), params["q_norm"],
                    cfg.norm_eps)
    q = torch.einsum("bsr,rhe->bshe", q_lat, params["wq_b"])
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    return q_nope, rope(q_rope, positions, cfg.rope_theta)


def _mla_kv(params: dict, h: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig):
    """(c_kv, k_rope): the latent (B, S, r) and the shared rotary key (B, S,
    1, rope_hd)."""
    m = cfg.mla
    kv_a = torch.einsum("bsd,dr->bsr", h, params["wkv_a"])
    c_kv = rmsnorm(kv_a[..., :m.kv_lora_rank], params["kv_norm"], cfg.norm_eps)
    k_rope = rope(kv_a[..., m.kv_lora_rank:][:, :, None, :], positions, cfg.rope_theta)
    return c_kv, k_rope


def _mla_qkv(params: dict, h: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig):
    """(q_nope, q_rope, c_kv, k_rope) (`_mla_q`, `_mla_kv`)."""
    return (*_mla_q(params, h, positions, cfg), *_mla_kv(params, h, positions, cfg))


def _mla_scale(cfg: ArchConfig) -> float:
    return (cfg.mla.nope_head_dim + cfg.mla.rope_head_dim) ** -0.5


def _mla_weights(params: dict, x: torch.Tensor, cfg: ArchConfig, rt):
    """As `_gqa_weights`: wq_b, wk_b, wv_b and wo split over heads, the
    latent projections and norms whole."""
    split = tp_split(rt, cfg.n_heads)
    return (*body_weights(params, x, rt, split, {"wq_b": 1, "wk_b": 1, "wv_b": 1, "wo": 0}),
            split)


def mla_forward(params: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig, *,
                rt=None, rows: torch.Tensor | None = None):
    """Full-sequence MLA (prefill, training): per-head K and V expanded from
    the latent, then the flash attention (qk dim nope + rope, v dim
    v_head_dim; its backward is `_FlashCore`'s). Returns (out, (c_kv,
    k_rope)). On a mesh the heads split over 'model' as `gqa_forward`'s,
    and rows gives a cache window's (c_kv, k_rope) as there."""
    m = cfg.mla
    w, x, split = _mla_weights(params, x, cfg, rt)
    h = rmsnorm(x, w["ln"], cfg.norm_eps)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(w, h, positions, cfg)
    k_nope = torch.einsum("bsr,rhe->bshe", c_kv, w["wk_b"])
    v = torch.einsum("bsr,rhe->bshe", c_kv, w["wv_b"])
    k_rope_b = k_rope.expand(*k_rope.shape[:2], q_nope.shape[2], m.rope_head_dim)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope_b], dim=-1)
    out = flash_attention(q_full, k_full, v, scale=_mla_scale(cfg))
    y = split_out(torch.einsum("bshe,hed->bsd", out, w["wo"]), rt, split)
    if rows is None:
        return y, (c_kv, k_rope)
    hr, pr, valid = cache_rows(h, positions, rows)
    c_kv, k_rope = _mla_kv(w, hr, pr, cfg)
    return y, (torch.where(valid[None, :, None], c_kv, 0.0).to(c_kv.dtype),
               torch.where(valid[None, :, None, None], k_rope, 0.0).to(k_rope.dtype))


def mla_decode(params: dict, x: torch.Tensor, ckv_cache: torch.Tensor,
               krope_cache: torch.Tensor, pos: int, cfg: ArchConfig, *, rt=None,
               seq_split: bool = False):
    """Absorbed-matrix MLA decode: scores straight against the latent cache.

    scores = (q_nope W_uk) . c_kv + q_rope . k_rope, so the per-head K is
    never formed; the value path contracts the latent first. Writes this
    token's c_kv and k_rope into the caches (B, S_max, r) and (B, S_max, 1,
    rope_hd) in place at pos. Scores and context in f32, the mask k_pos <=
    pos; p is cast to the cache's dtype, the context to x's. Returns (out,
    (ckv_cache, krope_cache)).

    On a mesh the absorbed queries (B, H, r) and the rotary queries of the
    heads split over 'model' are all-gathered for the one token; with
    seq_split the caches are this rank's window of the slots, written by
    the rank that holds pos, and the softmax and the latent context are
    combined over 'model' as `decode_attention` combines them."""
    b = x.shape[0]
    w, x, split = _mla_weights(params, x, cfg, rt)
    h = rmsnorm(x, w["ln"], cfg.norm_eps)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv(w, h, positions, cfg)
    srt = rt if seq_split else None
    cache_write(ckv_cache, pos, c_kv_new[:, 0], srt)
    cache_write(krope_cache, pos, k_rope_new[:, 0], srt)

    # absorb W_uk into q: (B, 1, H, nope) x (r, H, nope) -> (B, H, r)
    q_lat = torch.einsum("bshe,rhe->bhr", q_nope, w["wk_b"])
    if split:
        q_lat = comm.all_gather(q_lat, rt, (rt.tp_axis,), 1)
        q_rope = comm.all_gather(q_rope, rt, (rt.tp_axis,), 2)
    scores = (torch.einsum("bhr,btr->bht", _f32(q_lat), _f32(ckv_cache))
              + torch.einsum("bshe,bte->bht", _f32(q_rope), _f32(krope_cache[:, :, 0, :]))
              ) * _mla_scale(cfg)
    k_pos = _slot_positions(ckv_cache.shape[1], x.device, srt)
    scores = torch.where(k_pos[None, None, :] <= pos, scores, _NEG)
    p = torch.softmax(scores, dim=-1) if srt is None else _split_softmax(scores, srt)
    ctx_lat = torch.einsum("bht,btr->bhr", _f32(p.to(ckv_cache.dtype)), _f32(ckv_cache))
    if srt is not None:
        ctx_lat = comm.all_reduce(ctx_lat, rt, (rt.tp_axis,))
    if split:
        h_loc = w["wo"].shape[0]
        ctx_lat = ctx_lat[:, rt.tp_rank * h_loc:(rt.tp_rank + 1) * h_loc]
    out = torch.einsum("bhr,rhe->bhe", ctx_lat.to(x.dtype), w["wv_b"])
    out = torch.einsum("bhe,hed->bd", out, w["wo"])[:, None, :]
    return split_out(out, rt, split), (ckv_cache, krope_cache)
