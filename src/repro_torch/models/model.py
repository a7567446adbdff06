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
(`comm.reduce_from`, so each rank's backward gives its own rows' share).

The layouts over 'model' are the reference's specs (`_TP_AXES`: heads, ff,
vocab, inner and cache_seq), computed where GSPMD partitions them. Each
weight is taken at its use inside the layer that reads it
(`dist.sharding.at_use`): gathered over the dp axes it is sharded on, and
over 'model' kept as this rank's shard wherever the body splits there, by
the Megatron pattern (the replicated residual enters through
`comm.copy_to`, the output projection's partial sums leave through
`comm.reduce_from`):
  * GQA and local attention: this rank's query heads (wq, wo) against the
    KV heads they use, wk and wv whole; MLA: wq_b, wk_b, wv_b and wo by
    heads, the latent whole;
  * RG-LRU: its channels (w_x, w_gate, conv, the gates), w_out by rows;
    SSD: its heads, the packed in_proj and conv gathered and sliced;
  * the dense FFN and the shared experts: f columns and rows
    (`dist.tp`'s products); the MoE: its experts (`ffn._moe_mesh`);
  * the embedding, the head and the loss: vocabulary columns
    (`embed_input`, `_head`, `_xent_sums`: the log-sum-exp and the gold
    logit combined over 'model'; decode's logits all-gathered).
A body whose heads (channels, columns) the 'model' ranks do not divide
runs replicated on its weights gathered whole, the reference's fallback.
Each gather's backward returns this rank's shard of the gradient, so the
train step's gradients never exist whole. Under seq_shard, each block
boundary keeps this 'model' rank's slice of the sequence and the next
block all-gathers it (`constrain`).

Decode caches are DTensors placed by `cache_specs`' logical axes
(`_place_cache`: batch over dp, cache_seq and inner over 'model', as the
reference's `init_cache` places them). Prefill computes each rank's window
of the sequence at the positions its slots hold (`_cache_windows`), and
the decode is sequence-split: the rank that holds slot pos writes it, each
rank scores the token's query heads (gathered over 'model') against its
slots, and the partial softmax is combined by an all-reduce of the max,
then of the sums and the outputs (`attention.decode_attention`). The
recurrent states and tails hold this rank's channels or heads.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import comm
from repro_torch.dist.sharding import (
    Runtime,
    _model_axis,
    at_use,
    constrain,
    full,
    is_dtensor,
    local,
    logical_to_spec,
    placements,
    spec_axes,
    tp_split,
    window,
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


def embed_input(params: dict, batch: dict, cfg: ArchConfig, rt: Runtime | None = None
                ) -> torch.Tensor:
    """tokens (B,S) int -> embeddings; or stub-frontend frames (B,S,fd),
    projected in the wider of the frames' and the projection's dtypes.

    On a mesh whose 'model' ranks divide the (padded) vocabulary, each rank
    looks up the ids in its window of the embedding's rows (zero for the
    others) and the lookups are summed over 'model' (`comm.reduce_from`):
    exactly one rank holds each row."""
    if "frames" in batch:
        frames, proj = batch["frames"], at_use(params["frontend_proj"], rt)
        dt = torch.promote_types(frames.dtype, proj.dtype)
        return torch.einsum("bsf,fd->bsd", frames.to(dt), proj.to(dt))
    emb = params["embed"]
    if not tp_split(rt, emb.shape[0]):
        return at_use(emb, rt)[batch["tokens"].long()]
    rows = at_use(emb, rt, keep=0, split=True)
    n = rows.shape[0]
    ids = batch["tokens"].long() - rt.tp_rank * n
    inside = (ids >= 0) & (ids < n)
    x = torch.where(inside[..., None], rows[ids.clamp(0, n - 1)], 0.0).to(rows.dtype)
    return comm.reduce_from(x, rt, (rt.tp_axis,))


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


def _apply_block(kind: str, bp: dict, x, positions, cfg: ArchConfig, rt: Runtime,
                 win: dict | None = None):
    """One layer (sequence mixer + channel mixer), full-sequence mode.

    Returns (x, cache_entry) — the entry feeds the decode path when this
    runs as prefill (`_cache_entry` lays it out). win (prefill on a mesh,
    `_cache_windows`): the rows of a sequence-split cache's window
    ("rows") and the SSD tail's packed columns ("tail_cols"), whose
    entries the mixers compute as this rank's window. The mixers take
    their weights at use (`dist.sharding.at_use`): split over 'model' by
    heads or channels where those divide."""
    win = win or {}
    mixer = kind.partition("+")[0]
    mp = bp["mixer"]
    if mixer in ("gqa", "local_attn"):
        y, (k, v) = attn.gqa_forward(mp, x, positions, cfg, window=_window(mixer, cfg), rt=rt,
                                     rows=win.get("rows"))
        cache = {"k": k, "v": v}
    elif mixer == "mla":
        y, (ckv, krope) = attn.mla_forward(mp, x, positions, cfg, rt=rt, rows=win.get("rows"))
        cache = {"ckv": ckv, "krope": krope}
    elif mixer == "rglru":
        y, (state, tail) = rec.rglru_forward(mp, x, cfg, rt=rt)
        cache = {"state": state, "tail": tail}
    elif mixer == "ssd":
        y, (state, tail) = rec.ssd_forward(mp, x, cfg, rt=rt, tail_cols=win.get("tail_cols"))
        cache = {"state": state, "tail": tail}
    else:
        raise ValueError(mixer)
    return _channel(kind, bp, x + y, cfg, rt), cache


def _apply_block_decode(kind: str, bp: dict, x, cache: dict, pos: int, cfg: ArchConfig,
                        rt: Runtime, split: dict | None = None):
    """One layer, single-token decode mode; writes the cache entry in place
    (the attention caches at this token's slot, the recurrent states and
    conv tails whole, or this rank's window of them). split: the cache
    keys whose sequence ("seq") or SSD tail ("tail") this 'model' rank
    holds a window of. Returns (x, cache)."""
    split = split or {}
    mixer = kind.partition("+")[0]
    mp = bp["mixer"]
    if mixer in ("gqa", "local_attn"):
        y, _ = attn.gqa_decode(mp, x, cache["k"], cache["v"], pos, cfg,
                               window=_window(mixer, cfg), rt=rt, seq_split=split.get("seq"))
    elif mixer == "mla":
        y, _ = attn.mla_decode(mp, x, cache["ckv"], cache["krope"], pos, cfg, rt=rt,
                               seq_split=split.get("seq"))
    elif mixer in ("rglru", "ssd"):
        dec = rec.rglru_decode if mixer == "rglru" else rec.ssd_decode
        tail = cache["tail"]
        # the SSD's packed tail is gathered whole (a rank's window of it is
        # not its heads'); RG-LRU's channels are the rank's own
        whole = mixer == "ssd" and split.get("tail")
        if whole:
            tail = comm.all_gather(tail, rt, (rt.tp_axis,), tail.dim() - 1)
        y, (state, tail) = dec(mp, x, cache["state"], tail, cfg, rt)
        if whole:
            n = cache["tail"].shape[-1]
            tail = tail.narrow(-1, rt.tp_rank * n, n)
        cache["state"].copy_(state)
        cache["tail"].copy_(tail)
    else:
        raise ValueError(mixer)
    return _channel(kind, bp, x + y, cfg, rt), cache


def _cache_entry(kind: str, entry: dict, s_max: int | None, cfg: ArchConfig,
                 win: dict | None = None) -> dict:
    """One layer's prefill outputs in the decode cache's layout. Sequence
    entries (k, v, ckv, krope: (B, S, ...)) are right-padded with zeros to
    max(S, s_max); a local-attention layer's k and v instead fill a ring of
    L = min(max(S, s_max), window) slots with the last min(S, L) positions,
    each at slot position % L (`attention.gqa_decode`). Recurrent states
    come in f32; conv tails as they are. With win (a mesh,
    `_cache_windows`), each entry is cut to this rank's window of the
    dims its spec shards over 'model' (a sequence entry computed at the
    window's rows already is)."""
    windowed = win is not None and win.get("rows") is not None
    out = {}
    for key, t in entry.items():
        if key in SEQ_KEYS and not windowed:
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
        if key == "state":
            t = t.float()
        if win:
            t = _fit(t, win["dims"][key], win["rt"])
        out[key] = t
    return out


def _fit(t: torch.Tensor, dims: dict, rt: Runtime) -> torch.Tensor:
    """t cut to this 'model' rank's window of each dim in dims ({dim:
    global size}) that it holds whole."""
    for d, n in dims.items():
        if t.shape[d] == n:
            t = t.narrow(d, rt.tp_rank * (n // rt.tp_size), n // rt.tp_size)
    return t


def _cache_windows(cfg: ArchConfig, b: int, s: int, length: int, rt: Runtime, device):
    """Per segment and unit block, what a prefill of s tokens on this rank
    computes of its cache window (None off a split): the rows of a
    sequence-split cache's slots (the position each holds, -1 for none:
    padding past s, or a local-attention ring's slots that s has not
    reached; `attention.cache_rows`), the SSD tail's packed columns, and
    each key's dims sharded over 'model' ({dim: global size}, `_fit`)."""
    if _model_axis(rt) is None:
        return None
    out = []
    for (unit, _), seg in zip(layer_plan(cfg), cache_specs(cfg, b, length)):
        wins = []
        for kind, entry in zip(unit, seg):
            dims = {key: _model_dims(spec, rt) for key, spec in entry.items()}
            win = {"dims": dims, "rt": rt}
            seq = next((k for k in SEQ_KEYS if k in entry), None)
            if seq is not None and 1 in dims[seq]:
                ring = kind.startswith("local_attn+")
                win["rows"] = _window_rows(s, dims[seq][1], ring, rt, device)
            if kind == "ssd":
                full_cols = entry["tail"].shape[-1]
                n = full_cols // rt.tp_size if 2 in dims["tail"] else full_cols
                lo = rt.tp_rank * n if 2 in dims["tail"] else 0
                win["tail_cols"] = slice(lo, lo + n)
            wins.append(win)
        out.append(wins)
    return out


def _model_dims(spec: ParamSpec, rt: Runtime) -> dict:
    """{dim of one layer's entry: global size} of the dims that spec
    shards over 'model' (the stacked 'layers' dim dropped)."""
    ps = logical_to_spec(spec.logical, spec.shape, rt)
    return {d - 1: spec.shape[d] for d, e in enumerate(ps) if rt.tp_axis in spec_axes(e)}


def _window_rows(s: int, length: int, ring: bool, rt: Runtime, device) -> torch.Tensor:
    """The positions held by this 'model' rank's window of a cache of
    `length` slots after a prefill of s tokens, -1 for an empty slot:
    slot i holds position i (< s), or in a local-attention ring the
    latest position p < s with p % length == i."""
    n = length // rt.tp_size
    slots = rt.tp_rank * n + torch.arange(n, device=device)
    if ring:
        pos = slots + length * torch.div(s - 1 - slots, length, rounding_mode="floor")
    else:
        pos = torch.where(slots < s, slots, -1)
    return pos.clamp_min(-1)



# ---------------------------------------------------------------------------
# backbone
# ---------------------------------------------------------------------------


def _backbone(params: dict, x, positions, cfg: ArchConfig, rt: Runtime,
              collect_cache: bool = False, s_max: int | None = None,
              batch_size: int | None = None):
    """Runs the segment stack. Returns (hidden, cache segments | None).

    With collect_cache, each segment's entries come stacked (R, B, ...) in
    the decode cache's layout (`_cache_entry`; on a mesh, this rank's
    window of it, `_cache_windows`). With rt.remat (and no cache to
    collect), each layer's unit of blocks runs under `checkpoint`: its
    activations, and its weights' gathers, are recomputed in the
    backward."""
    caches = []
    wins_all = None
    if collect_cache:
        s = x.shape[1]
        wins_all = _cache_windows(cfg, batch_size or x.shape[0], s, max(s, s_max or 0), rt,
                                  x.device)
    for i, ((unit, repeats), seg) in enumerate(zip(layer_plan(cfg), params["segments"])):
        entries: list[dict | None] = [None] * len(unit)
        wins = wins_all[i] if wins_all is not None else [None] * len(unit)

        def unit_body(h, r, unit=unit, seg=seg, wins=wins):
            h = constrain(h, rt, ("batch", "seq_act", "embed_act"))
            out = []
            for kind, bp, win in zip(unit, seg["blocks"], wins):
                h, entry = _apply_block(kind, _layer(bp, r), h, positions, cfg, rt, win)
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
                entry = _cache_entry(unit[u], entry, s_max, cfg, wins[u])
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
    x = embed_input(params, batch, cfg, rt)
    x, _ = _backbone(params, x, _positions(x), cfg, rt)
    return attn.rmsnorm(x, at_use(params["final_norm"], rt), cfg.norm_eps)


def _head_matrix(params: dict, cfg: ArchConfig) -> torch.Tensor:
    """The whole head (d, V): the tied embedding's transpose or lm_head."""
    if cfg.tie_embeddings or "lm_head" not in params:
        return full(params["embed"]).T
    return full(params["lm_head"])


def _head(params: dict, cfg: ArchConfig, rt: Runtime | None, key: str | None = None):
    """(head columns (d, V or V_loc), the first one's global index or None).
    On a mesh whose 'model' ranks divide the padded vocabulary, this rank's
    window of the columns (the tied embedding's rows, transposed); else
    the whole head, gathered at use. key: a head other than the LM's
    (the MTP head)."""
    tied = key is None and (cfg.tie_embeddings or "lm_head" not in params)
    w = params["embed"] if tied else params[key or "lm_head"]
    vdim = 0 if tied else 1
    if not tp_split(rt, w.shape[vdim]):
        w = at_use(w, rt)
        return (w.T if tied else w), None
    w = at_use(w, rt, keep=vdim, split=True)
    return (w.T if tied else w), rt.tp_rank * w.shape[vdim]


def head_logits(params: dict, hidden: torch.Tensor, cfg: ArchConfig, rt: Runtime | None
                ) -> torch.Tensor:
    """hidden (B, S, d) -> logits (B, S, V) in the params' dtype; on a
    vocab-split mesh each rank's columns, all-gathered over 'model'."""
    head, off = _head(params, cfg, rt)
    logits = torch.einsum("bsd,dv->bsv", hidden, head)
    if off is not None:
        logits = comm.all_gather(logits, rt, (rt.tp_axis,), 2)
    return logits


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def _chunked_xent(hidden: torch.Tensor, labels: torch.Tensor, head: torch.Tensor,
                  cfg: ArchConfig, rt: Runtime | None = None,
                  offset: int | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy in f32, LOSS_CHUNK positions at a time.

    Logits of padded vocabulary entries (head columns past cfg.vocab_size)
    are -1e30, out of the partition function; labels < 0 are padding and
    count neither in the sum nor in the mean's count. On a mesh, hidden
    and labels are this rank's rows: the mean is over the global batch's
    tokens (the count summed over dp), and this rank's share is summed
    over dp (`comm.reduce_from`: the backward keeps this rank's share).
    With offset, head is this 'model' rank's vocabulary columns from that
    global index on (`_head`): hidden enters through `comm.copy_to`, and
    `_xent_sums` combines the ranks' log-sum-exp and gold logits."""
    vrt = None
    if offset is not None:
        vrt = rt
        hidden = comm.copy_to(hidden, rt, (rt.tp_axis,))
    tot, cnt = _xent_sums(hidden, labels, head, cfg, vrt, offset or 0)
    if rt is None or not rt.distributed:
        return tot / torch.clamp_min(cnt, 1.0)
    cnt = comm.all_reduce(cnt, rt, rt.dp_axes)
    return comm.reduce_from(tot / torch.clamp_min(cnt, 1.0), rt, rt.dp_axes)


def _xent_sums(hidden: torch.Tensor, labels: torch.Tensor, head: torch.Tensor,
               cfg: ArchConfig, vrt: Runtime | None = None, offset: int = 0):
    """(token-loss sum, token count) of `_chunked_xent`, in f32. With vrt,
    head holds the vocabulary columns [offset, offset + V_loc) of a split
    over 'model': the max is all-reduced (max) and the sum of exp and the
    gold logit (from the rank whose columns hold the label; padded
    columns masked by global index) are summed over 'model'."""
    b, s, d = hidden.shape
    v_real = cfg.vocab_size
    chunk = min(LOSS_CHUNK, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} does not divide by the loss chunk {chunk}")
    tot = hidden.new_zeros((), dtype=torch.float32)
    cnt = hidden.new_zeros((), dtype=torch.float32)
    tp = None if vrt is None else (vrt.tp_axis,)
    for c in range(s // chunk):
        h, y = hidden[:, c * chunk:(c + 1) * chunk], labels[:, c * chunk:(c + 1) * chunk]
        logits = torch.einsum("bcd,dv->bcv", h, head).float()
        v_loc = logits.shape[-1]
        if offset + v_loc > v_real:
            pad_mask = offset + torch.arange(v_loc, device=logits.device) >= v_real
            logits = torch.where(pad_mask, -1e30, logits)
        if vrt is None:
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, y.clamp_min(0).long()[..., None])[..., 0]
        else:
            m = comm.all_reduce(logits.detach().amax(dim=-1, keepdim=True), vrt, tp, op="max")
            lse = m[..., 0] + torch.log(comm.reduce_from(torch.exp(logits - m).sum(-1), vrt, tp))
            yl = y.long() - offset
            inside = (yl >= 0) & (yl < v_loc)
            g = torch.gather(logits, -1, yl.clamp(0, v_loc - 1)[..., None])[..., 0]
            gold = comm.reduce_from(torch.where(inside, g, 0.0), vrt, tp)
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
    head, off = _head(params, cfg, rt)
    loss = _chunked_xent(hidden, labels, head, cfg, rt, off)
    metrics = {"lm_loss": loss}
    if cfg.mtp_heads:
        # multi-token prediction: the labels shifted one step further
        mtp_labels = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], -1)], dim=1)
        head, off = _head(params, cfg, rt, "mtp_head")
        mtp_loss = _chunked_xent(hidden, mtp_labels, head, cfg, rt, off)
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


def _place_cache(t: torch.Tensor, spec: ParamSpec, rt: Runtime):
    """A cache leaf (R, B_loc, ...) holding this rank's window under its
    spec (`cache_specs`' logical axes through `logical_to_spec`: batch
    over dp, cache_seq and inner over 'model', as the reference's
    `init_cache` places them) as a DTensor of the spec's global shape."""
    from torch.distributed.tensor import DTensor

    pl = placements(logical_to_spec(spec.logical, spec.shape, rt), rt.mesh)
    # contiguous strides reckoned, not read off a tensor of the global
    # shape: made here, one would count as live in the dry-run's OpCost
    stride = tuple(math.prod(spec.shape[i + 1:]) for i in range(len(spec.shape)))
    return DTensor.from_local(t, rt.mesh, pl, run_check=False, shape=torch.Size(spec.shape),
                              stride=stride)


def init_cache(cfg: ArchConfig, batch: int, s_max: int, rt: Runtime, device="cuda") -> list:
    """Zeroed decode caches of `cache_specs`' shapes and dtypes; on a mesh
    DTensors of this rank's window (`_place_cache`)."""

    def mk(s: ParamSpec):
        if not rt.distributed:
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        win = window(s.shape, logical_to_spec(s.logical, s.shape, rt), rt)
        shape = [w.stop - w.start for w in win]
        return _place_cache(torch.zeros(shape, dtype=s.dtype, device=device), s, rt)

    return _map_specs(mk, cache_specs(cfg, batch, s_max))


def prefill(params: dict, batch: dict, cfg: ArchConfig, rt: Runtime, s_max: int | None = None):
    """Full-sequence forward that also materializes the decode cache.

    Returns (last_hidden (B, 1, d), cache). Attention caches come out
    (R, B, S, ...), right-padded with zeros to s_max when s_max > S; a
    local-attention layer's as its ring (`_cache_entry`). On a mesh each
    rank keeps its window of every leaf, placed as `init_cache` places
    it: its slots of the sequence (computed at the rows they hold), its
    channels or heads of the recurrent states and tails."""
    b = next(iter(batch.values())).shape[0]
    x = embed_input(params, _local_batch(batch, rt), cfg, rt)
    s = x.shape[1]
    x, caches = _backbone(params, x, _positions(x), cfg, rt, collect_cache=True, s_max=s_max,
                          batch_size=b)
    hidden = attn.rmsnorm(x, at_use(params["final_norm"], rt), cfg.norm_eps)
    if rt.distributed:
        specs = cache_specs(cfg, b, max(s, s_max or 0))
        caches = [[{k: _place_cache(t, spec[k], rt) for k, t in entry.items()}
                   for entry, spec in zip(seg, seg_specs)]
                  for seg, seg_specs in zip(caches, specs)]
    return _gather_rows(hidden[:, -1:, :], rt, b), caches


def _split_keys(entry: dict, rt: Runtime) -> dict:
    """Which of a layer's cache leaves (DTensors (R, B, ...)) this 'model'
    rank holds a window of: the sequence ("seq", dim 2) and the SSD's conv
    tail ("tail", dim 3)."""
    from torch.distributed.tensor import Shard

    tp = _model_axis(rt)
    out = {}
    if tp is None:
        return out
    for key, t in entry.items():
        if not is_dtensor(t):
            continue
        pl = dict(zip(t.device_mesh.mesh_dim_names, t.placements))[tp]
        if key in SEQ_KEYS and pl == Shard(2):
            out["seq"] = True
        if key == "tail" and pl == Shard(3):
            out["tail"] = True
    return out


def decode_step(params: dict, tokens: torch.Tensor, cache: list, pos, cfg: ArchConfig,
                rt: Runtime):
    """One decode step. tokens: (B, 1) int; pos: the number of tokens
    already in the cache (an int). The cache is updated in place (the
    reference donates it). Returns (logits (B, 1, V) in the params'
    dtype, cache).

    On a mesh the decode is sequence-split wherever the cache's spec
    splits cache_seq over 'model' (`attention.gqa_decode`,
    `mla_decode`), the recurrent mixers run on their channels or heads,
    and the vocab-split logits are all-gathered over 'model' at the end
    (`head_logits`), so the caller sees them whole."""
    pos = int(pos)
    b = tokens.shape[0]
    x = embed_input(params, _local_batch({"tokens": tokens}, rt), cfg, rt)
    for (unit, repeats), seg, seg_cache in zip(layer_plan(cfg), params["segments"], cache):
        splits = [_split_keys(entry, rt) for entry in seg_cache]
        seg_cache = [{k: local(t) for k, t in entry.items()} for entry in seg_cache]
        for r in range(repeats):
            for kind, bp, entry, split in zip(unit, seg["blocks"], seg_cache, splits):
                x, _ = _apply_block_decode(kind, _layer(bp, r), x, _layer(entry, r), pos, cfg,
                                           rt, split)
    hidden = attn.rmsnorm(x, at_use(params["final_norm"], rt), cfg.norm_eps)
    return _gather_rows(head_logits(params, hidden, cfg, rt), rt, b), cache


def init_params(cfg: ArchConfig, generator: torch.Generator, dtype=torch.bfloat16,
                device="cuda") -> dict:
    from repro_torch.models.params import init_params as _init

    return _init(cfg, generator, dtype, device)
