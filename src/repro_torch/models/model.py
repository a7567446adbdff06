"""Model assembly: embedding -> block segments -> loss / prefill / decode
(plain PyTorch).

Counterpart of `repro.models.model`. The reference stacks each run of
identical layers (`params.layer_plan`) on a leading 'layers' axis and scans
it with `lax.scan`; here each segment's stacked leaves are sliced layer by
layer in a Python loop, so the parameter tree keeps the reference's shape
and carries across leaf for leaf (`repro_torch.convert`). With
`Runtime.remat`, each layer's body is recomputed in the backward
(`torch.utils.checkpoint`, the reference's `jax.checkpoint`).

Every block kind of the reference's dispatch runs: the sequence mixers
gqa, local_attn (the window), mla, rglru and ssd (which has no channel
mixer), and the channel mixers ffn and moe.

Cross-entropy is computed in sequence chunks of LOSS_CHUNK positions against
the head, so no more than one chunk's (B, C, V) logits exist at a time in
the forward.

On a mesh (`Runtime` with a DeviceMesh), every rank is given the global
batch and keeps its dp rows (`_rows`: split over the dp axes when the batch
divides, replicated otherwise, the reference's fallback); the outputs that
leave the model (prefill's last hidden states, decode's logits) are
all-gathered back over dp, and the loss is the global batch's: each rank's
token-loss sum over the global token count, summed over dp
(`comm.reduce_from`, so each rank's backward gives its own rows' share,
which the train step sums). Parameters may be DTensors: each block's
weights are gathered at use over every axis they are sharded on (ZeRO-3,
`dist.sharding.full`). Only the reference's explicit paths compute on local
shards: `dist.tp` under explicit_tp, and the MoE bodies
(`ffn._moe_mesh`, `ffn._moe_decode_gather`). GQA, local attention, MLA,
RG-LRU and SSD run replicated over 'model' in this slice (the reference
leaves their partition to GSPMD); head-parallel attention and a
vocab-parallel loss are ROADMAP work for a multi-card cell. Under
seq_shard, each block boundary keeps this 'model' rank's slice of the
sequence and the next block all-gathers it (`constrain`). Decode caches
are DTensors placed with batch over dp, and cache_seq and inner kept
replicated (`_place_cache`): the attention and recurrent mixers that read
them run replicated over 'model'.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import comm
from repro_torch.dist.sharding import (
    Runtime,
    constrain,
    full,
    is_dtensor,
    local,
    logical_to_spec,
    placements,
)
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import recurrent as rec
from repro_torch.models.params import ParamSpec, _map_specs, layer_plan

LOSS_CHUNK = 1024
MTP_WEIGHT = 0.3
SEQ_KEYS = ("k", "v", "ckv", "krope")   # cache entries with a sequence axis


def _layer(tree, r: int):
    """Layer r's slice of a tree of stacked (R, ...) leaves (views; a
    DTensor's as a DTensor over its local layer, no collective)."""
    if isinstance(tree, dict):
        return {k: _layer(v, r) for k, v in tree.items()}
    if is_dtensor(tree):
        from torch.distributed.tensor import DTensor, Shard

        pl = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p for p in tree.placements)
        return DTensor.from_local(tree.to_local()[r], tree.device_mesh, pl, run_check=False,
                                  shape=tree.shape[1:], stride=tree.stride()[1:])
    return tree[r]


def _full_tree(tree):
    """A block's leaves gathered whole (the mixers run replicated)."""
    if isinstance(tree, dict):
        return {k: _full_tree(v) for k, v in tree.items()}
    return full(tree)


def _rows(rt: Runtime, b: int) -> slice | None:
    """This rank's dp rows of a global batch of b, or None (off a mesh, or
    a batch the dp ranks do not divide: replicated)."""
    if not rt.distributed or b % rt.dp_size:
        return None
    n = b // rt.dp_size
    return slice(rt.dp_rank * n, (rt.dp_rank + 1) * n)


def _local_batch(batch: dict, rt: Runtime) -> dict:
    """This rank's rows (`_rows`) of each leaf of a global batch. A leaf
    may be a DTensor placed by the batch's specs (`launch.specs`): with
    its rows over exactly the dp axes it gives its local shard, which
    holds those rows; otherwise its whole, sliced alike."""
    b = next(iter(batch.values())).shape[0]
    rows = _rows(rt, b)
    out = {}
    for k, v in batch.items():
        if is_dtensor(v):
            if rows is not None and _rows_placed(v, rt):
                out[k] = v.to_local()
                continue
            v = full(v)
        out[k] = v if rows is None else v[rows]
    return out


def _rows_placed(v, rt: Runtime) -> bool:
    """Whether DTensor v shards dim 0 over rt's dp axes and nothing else."""
    from torch.distributed.tensor import Shard

    names = v.device_mesh.mesh_dim_names
    sharded = tuple((a, p.dim) for a, p in zip(names, v.placements) if isinstance(p, Shard))
    return sharded == tuple((a, 0) for a in rt.dp_axes)


def _gather_rows(x: torch.Tensor, rt: Runtime, b: int) -> torch.Tensor:
    """This rank's rows of an output back to the global batch of b."""
    return x if _rows(rt, b) is None else comm.all_gather(x, rt, rt.dp_axes, 0)


# ---------------------------------------------------------------------------
# embedding / frontends
# ---------------------------------------------------------------------------


def embed_input(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """tokens (B,S) int -> embeddings; or stub-frontend frames (B,S,fd),
    projected in the wider of the frames' and the projection's dtypes."""
    if "frames" in batch:
        frames, proj = batch["frames"], full(params["frontend_proj"])
        dt = torch.promote_types(frames.dtype, proj.dtype)
        return torch.einsum("bsf,fd->bsd", frames.to(dt), proj.to(dt))
    return full(params["embed"])[batch["tokens"].long()]


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _channel(kind: str, bp: dict, x, cfg: ArchConfig, rt: Runtime):
    channel = kind.partition("+")[2]   # none for ssd
    if channel == "ffn":
        return x + ffn_mod.ffn_forward(bp["channel"], x, cfg, rt)
    if channel == "moe":
        return x + ffn_mod.moe_forward(bp["channel"], x, cfg, rt)
    return x


def _window(mixer: str, cfg: ArchConfig) -> int | None:
    return cfg.local_window if mixer == "local_attn" else None


def _apply_block(kind: str, bp: dict, x, positions, cfg: ArchConfig, rt: Runtime):
    """One layer (sequence mixer + channel mixer), full-sequence mode.

    Returns (x, cache_entry) — the entry feeds the decode path when this
    runs as prefill (`_cache_entry` lays it out)."""
    mixer = kind.partition("+")[0]
    mp = _full_tree(bp["mixer"])
    if mixer in ("gqa", "local_attn"):
        y, (k, v) = attn.gqa_forward(mp, x, positions, cfg, window=_window(mixer, cfg))
        cache = {"k": k, "v": v}
    elif mixer == "mla":
        y, (ckv, krope) = attn.mla_forward(mp, x, positions, cfg)
        cache = {"ckv": ckv, "krope": krope}
    elif mixer in ("rglru", "ssd"):
        fwd = rec.rglru_forward if mixer == "rglru" else rec.ssd_forward
        y, (state, tail) = fwd(mp, x, cfg)
        cache = {"state": state, "tail": tail}
    else:
        raise ValueError(mixer)
    return _channel(kind, bp, x + y, cfg, rt), cache


def _apply_block_decode(kind: str, bp: dict, x, cache: dict, pos: int, cfg: ArchConfig,
                        rt: Runtime):
    """One layer, single-token decode mode; writes the cache entry in place
    (the attention caches at this token's slot, the recurrent states and
    conv tails whole). Returns (x, cache)."""
    mixer = kind.partition("+")[0]
    mp = _full_tree(bp["mixer"])
    if mixer in ("gqa", "local_attn"):
        y, _ = attn.gqa_decode(mp, x, cache["k"], cache["v"], pos, cfg,
                               window=_window(mixer, cfg))
    elif mixer == "mla":
        y, _ = attn.mla_decode(mp, x, cache["ckv"], cache["krope"], pos, cfg)
    elif mixer in ("rglru", "ssd"):
        dec = rec.rglru_decode if mixer == "rglru" else rec.ssd_decode
        y, (state, tail) = dec(mp, x, cache["state"], cache["tail"], cfg)
        cache["state"].copy_(state)
        cache["tail"].copy_(tail)
    else:
        raise ValueError(mixer)
    return _channel(kind, bp, x + y, cfg, rt), cache


def _cache_entry(kind: str, entry: dict, s_max: int | None, cfg: ArchConfig) -> dict:
    """One layer's prefill outputs in the decode cache's layout. Sequence
    entries (k, v, ckv, krope: (B, S, ...)) are right-padded with zeros to
    max(S, s_max); a local-attention layer's k and v instead fill a ring of
    L = min(max(S, s_max), window) slots with the last min(S, L) positions,
    each at slot position % L (`attention.gqa_decode`). Recurrent states
    come in f32; conv tails as they are."""
    out = {}
    for key, t in entry.items():
        if key in SEQ_KEYS:
            s = t.shape[1]
            length = max(s, s_max or 0)
            if kind.startswith("local_attn+"):
                length = min(length, cfg.local_window)
                keep = torch.arange(max(s - length, 0), s, device=t.device)
                ring = t.new_zeros((t.shape[0], length, *t.shape[2:]))
                ring[:, keep % length] = t[:, keep]
                t = ring
            elif length > s:
                t = torch.cat([t, t.new_zeros((t.shape[0], length - s, *t.shape[2:]))], dim=1)
        elif key == "state":
            t = t.float()
        out[key] = t
    return out


# ---------------------------------------------------------------------------
# backbone
# ---------------------------------------------------------------------------


def _backbone(params: dict, x, positions, cfg: ArchConfig, rt: Runtime,
              collect_cache: bool = False, s_max: int | None = None):
    """Runs the segment stack. Returns (hidden, cache segments | None).

    With collect_cache, each segment's entries come stacked (R, B, ...) in
    the decode cache's layout (`_cache_entry`). With rt.remat (and no cache
    to collect), each layer's unit of blocks runs under `checkpoint`: its
    activations are recomputed in the backward."""
    caches = []
    for (unit, repeats), seg in zip(layer_plan(cfg), params["segments"]):
        entries: list[dict | None] = [None] * len(unit)

        def unit_body(h, r, unit=unit, seg=seg):
            h = constrain(h, rt, ("batch", "seq_act", "embed_act"))
            out = []
            for kind, bp in zip(unit, seg["blocks"]):
                h, entry = _apply_block(kind, _layer(bp, r), h, positions, cfg, rt)
                out.append(entry)
            return h, out

        for r in range(repeats):
            if rt.remat and not collect_cache:
                # bind this segment's body: the recompute runs after the loop
                x = checkpoint(lambda h, r=r, body=unit_body: body(h, r)[0], x,
                               use_reentrant=False)
                continue
            x, unit_entries = unit_body(x, r)
            if not collect_cache:
                continue
            for u, entry in enumerate(unit_entries):
                entry = _cache_entry(unit[u], entry, s_max, cfg)
                if entries[u] is None:
                    entries[u] = {key: t.new_zeros((repeats, *t.shape))
                                  for key, t in entry.items()}
                for key, t in entry.items():
                    entries[u][key][r] = t
        caches.append(entries)
    return x, caches if collect_cache else None


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, s = x.shape[:2]
    return torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)


def forward_train(params: dict, batch: dict, cfg: ArchConfig, rt: Runtime) -> torch.Tensor:
    """Full-sequence forward -> final hidden states (B, S, d) (on a mesh
    computed on each rank's dp rows and gathered back)."""
    b = next(iter(batch.values())).shape[0]
    return _gather_rows(_forward_local(params, _local_batch(batch, rt), cfg, rt), rt, b)


def _forward_local(params: dict, batch: dict, cfg: ArchConfig, rt: Runtime) -> torch.Tensor:
    x = embed_input(params, batch, cfg)
    x, _ = _backbone(params, x, _positions(x), cfg, rt)
    return attn.rmsnorm(x, full(params["final_norm"]), cfg.norm_eps)


def _head_matrix(params: dict, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings or "lm_head" not in params:
        return full(params["embed"]).T
    return full(params["lm_head"])


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def _chunked_xent(hidden: torch.Tensor, labels: torch.Tensor, head: torch.Tensor,
                  cfg: ArchConfig, rt: Runtime | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy in f32, LOSS_CHUNK positions at a time.

    Logits of padded vocabulary entries (head columns past cfg.vocab_size)
    are -1e30, out of the partition function; labels < 0 are padding and
    count neither in the sum nor in the mean's count. On a mesh, hidden
    and labels are this rank's rows: the mean is over the global batch's
    tokens (the count summed over dp), and this rank's share is summed
    over dp (`comm.reduce_from`: the backward keeps this rank's share)."""
    tot, cnt = _xent_sums(hidden, labels, head, cfg)
    if rt is None or not rt.distributed:
        return tot / torch.clamp_min(cnt, 1.0)
    cnt = comm.all_reduce(cnt, rt, rt.dp_axes)
    return comm.reduce_from(tot / torch.clamp_min(cnt, 1.0), rt, rt.dp_axes)


def _xent_sums(hidden: torch.Tensor, labels: torch.Tensor, head: torch.Tensor,
               cfg: ArchConfig):
    """(token-loss sum, token count) of `_chunked_xent`, in f32."""
    b, s, d = hidden.shape
    v_real = cfg.vocab_size
    chunk = min(LOSS_CHUNK, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} does not divide by the loss chunk {chunk}")
    tot = hidden.new_zeros((), dtype=torch.float32)
    cnt = hidden.new_zeros((), dtype=torch.float32)
    for c in range(s // chunk):
        h, y = hidden[:, c * chunk:(c + 1) * chunk], labels[:, c * chunk:(c + 1) * chunk]
        logits = torch.einsum("bcd,dv->bcv", h, head).float()
        v_pad = logits.shape[-1]
        if v_pad > v_real:
            pad_mask = torch.arange(v_pad, device=logits.device) >= v_real
            logits = torch.where(pad_mask, -1e30, logits)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, y.clamp_min(0).long()[..., None])[..., 0]
        valid = (y >= 0).float()
        tot = tot + ((lse - gold) * valid).sum()
        cnt = cnt + valid.sum()
    return tot, cnt


def loss_fn(params: dict, batch: dict, cfg: ArchConfig, rt: Runtime):
    """Next-token LM loss (+ the multi-token-prediction auxiliary when
    cfg.mtp_heads is set). Returns (loss, metrics) as 0-d f32 tensors.

    batch: {"tokens" | "frames", "labels" (B, S) with -1 padding}, the
    global batch; the labels come shifted by the pipeline (labels[t] =
    tokens[t + 1]). On a mesh the loss is the global batch's on every rank
    (`_chunked_xent`)."""
    batch = _local_batch(batch, rt)
    hidden = _forward_local(params, batch, cfg, rt)
    labels = batch["labels"]
    loss = _chunked_xent(hidden, labels, _head_matrix(params, cfg), cfg, rt)
    metrics = {"lm_loss": loss}
    if cfg.mtp_heads:
        # multi-token prediction: the labels shifted one step further
        mtp_labels = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], -1)], dim=1)
        mtp_loss = _chunked_xent(hidden, mtp_labels, full(params["mtp_head"]), cfg, rt)
        metrics["mtp_loss"] = mtp_loss
        loss = loss + MTP_WEIGHT * mtp_loss
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# serving: cache specs, prefill, decode
# ---------------------------------------------------------------------------


def cache_specs(cfg: ArchConfig, batch: int, s_max: int) -> list:
    """ParamSpec tree for the decode cache, aligned with params['segments']:
    sequence caches of s_max slots (a local-attention ring of min(s_max,
    window)), recurrent states in f32 and conv tails."""
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    bf16, f32 = torch.bfloat16, torch.float32
    segs = []
    for unit, repeats in layer_plan(cfg):
        entries = []
        for kind in unit:
            if kind == "ssd":
                s = cfg.ssm
                d_in = s.expand * d
                nh = d_in // s.head_dim
                gn = s.n_groups * s.state_dim
                entries.append({
                    "state": ParamSpec((repeats, batch, nh, s.state_dim, s.head_dim),
                                       ("layers", "batch", "inner", None, None), f32),
                    "tail": ParamSpec((repeats, batch, s.conv_width - 1, d_in + 2 * gn),
                                      ("layers", "batch", None, "inner"), bf16),
                })
                continue
            mixer, _ = kind.split("+")
            if mixer in ("gqa", "local_attn"):
                # local attention caches a ring buffer of `window` slots
                s_len = min(s_max, cfg.local_window) if mixer == "local_attn" else s_max
                kv = ParamSpec((repeats, batch, s_len, cfg.n_kv_heads, hd),
                               ("layers", "batch", "cache_seq", "kv", "head"), bf16)
                entries.append({"k": kv, "v": kv})
            elif mixer == "mla":
                m = cfg.mla
                entries.append({
                    "ckv": ParamSpec((repeats, batch, s_max, m.kv_lora_rank),
                                     ("layers", "batch", "cache_seq", None), bf16),
                    "krope": ParamSpec((repeats, batch, s_max, 1, m.rope_head_dim),
                                       ("layers", "batch", "cache_seq", None, None), bf16),
                })
            elif mixer == "rglru":
                w = cfg.ssm.conv_width if cfg.ssm else 4
                entries.append({
                    "state": ParamSpec((repeats, batch, d), ("layers", "batch", "inner"), f32),
                    "tail": ParamSpec((repeats, batch, w - 1, d),
                                      ("layers", "batch", None, "inner"), bf16),
                })
        segs.append(entries)
    return segs


def _place_cache(t: torch.Tensor, rt: Runtime, b: int):
    """A cache leaf (R, B_loc, ...) of this rank's rows as a DTensor of the
    global batch b. Under the cache specs only 'batch' is placed (over dp,
    when the rows were split): cache_seq and inner stay replicated, since
    the attention and recurrent mixers that read them run replicated over
    'model'."""
    from torch.distributed.tensor import DTensor

    shape = (t.shape[0], b, *t.shape[2:])
    logical = ("layers", "batch") + (None,) * (t.dim() - 2)
    pl = placements(logical_to_spec(logical, shape, rt), rt.mesh)
    return DTensor.from_local(t, rt.mesh, pl, run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def init_cache(cfg: ArchConfig, batch: int, s_max: int, rt: Runtime, device="cuda") -> list:
    """Zeroed decode caches of `cache_specs`' shapes and dtypes; on a mesh
    DTensors of this rank's rows (`_place_cache`)."""
    rows = _rows(rt, batch)

    def mk(s: ParamSpec):
        if not rt.distributed:
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        shape = list(s.shape)
        if rows is not None:
            shape[1] = rows.stop - rows.start
        return _place_cache(torch.zeros(shape, dtype=s.dtype, device=device), rt, batch)

    return _map_specs(mk, cache_specs(cfg, batch, s_max))


def prefill(params: dict, batch: dict, cfg: ArchConfig, rt: Runtime, s_max: int | None = None):
    """Full-sequence forward that also materializes the decode cache.

    Returns (last_hidden (B, 1, d), cache). Attention caches come out
    (R, B, S, ...), right-padded with zeros to s_max when s_max > S; a
    local-attention layer's as its ring (`_cache_entry`)."""
    b = next(iter(batch.values())).shape[0]
    x = embed_input(params, _local_batch(batch, rt), cfg)
    x, caches = _backbone(params, x, _positions(x), cfg, rt, collect_cache=True, s_max=s_max)
    hidden = attn.rmsnorm(x, full(params["final_norm"]), cfg.norm_eps)
    if rt.distributed:
        caches = [[{k: _place_cache(t, rt, b) for k, t in entry.items()} for entry in seg]
                  for seg in caches]
    return _gather_rows(hidden[:, -1:, :], rt, b), caches


def decode_step(params: dict, tokens: torch.Tensor, cache: list, pos, cfg: ArchConfig,
                rt: Runtime):
    """One decode step. tokens: (B, 1) int; pos: the number of tokens
    already in the cache (an int). The cache is updated in place (the
    reference donates it). Returns (logits (B, 1, V) in the params'
    dtype, cache)."""
    pos = int(pos)
    b = tokens.shape[0]
    x = embed_input(params, _local_batch({"tokens": tokens}, rt), cfg)
    for (unit, repeats), seg, seg_cache in zip(layer_plan(cfg), params["segments"], cache):
        seg_cache = [{k: local(t) for k, t in entry.items()} for entry in seg_cache]
        for r in range(repeats):
            for kind, bp, entry in zip(unit, seg["blocks"], seg_cache):
                x, _ = _apply_block_decode(kind, _layer(bp, r), x, _layer(entry, r), pos, cfg,
                                           rt)
    hidden = attn.rmsnorm(x, full(params["final_norm"]), cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", hidden, _head_matrix(params, cfg))
    return _gather_rows(logits, rt, b), cache


def init_params(cfg: ArchConfig, generator: torch.Generator, dtype=torch.bfloat16,
                device="cuda") -> dict:
    from repro_torch.models.params import init_params as _init

    return _init(cfg, generator, dtype, device)
