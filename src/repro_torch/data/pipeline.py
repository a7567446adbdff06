"""Deterministic synthetic data pipeline.

Counterpart of `repro.data.pipeline`: the same numpy stream, so a batch's
tokens, labels and frames equal the reference's bit for bit; only the
container differs (torch tensors on a chosen device). A Markov-ish token
stream (not uniform noise: a learnable LM target) with

  * deterministic content as a function of (seed, step, host_shard);
  * host sharding: each process materializes only its slice of the global
    batch (host_index / host_count);
  * stub frontends: frame/patch embeddings for the audio/vlm architectures.

`make_batch_iterator` yields (step, batch) from a start step, this
process's shard of each global batch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.sharding import process_count, process_index


@dataclass
class SyntheticTokenPipeline:
    cfg: ArchConfig
    global_batch: int
    seq_len: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1
    device: str | torch.device = "cuda"

    def __post_init__(self):
        v = self.cfg.vocab_size
        rng = np.random.default_rng(self.seed)
        # fixed random transition table: next-token logits depend on current
        # token bucket -> learnable structure
        self.n_buckets = min(64, v)
        self.trans = rng.dirichlet(np.full(min(v, 512), 0.1), size=self.n_buckets).astype(
            np.float32)
        self.top_ids = rng.integers(0, v, size=(self.n_buckets, min(v, 512)))

    def _host_batch(self) -> int:
        if self.global_batch % self.host_count:
            raise ValueError(f"global batch {self.global_batch} does not divide over "
                             f"{self.host_count} hosts")
        return self.global_batch // self.host_count

    def batch(self, step: int) -> dict:
        """Batch for `step` (host-local slice of the global batch):
        {"labels" (B, S) int32, and "tokens" (B, S) int32 or, for a
        frontend arch, "frames" (B, S, frontend_dim) bf16}, on `device`."""
        b, s, v = self._host_batch(), self.seq_len, self.cfg.vocab_size
        rng = np.random.default_rng((self.seed * 1_000_003 + step) * 97 + self.host_index)
        tokens = np.empty((b, s + 1), dtype=np.int32)
        tokens[:, 0] = rng.integers(0, v, size=b)
        bucket = tokens[:, 0] % self.n_buckets
        for t in range(s):
            choice_idx = np.array([
                rng.choice(self.trans.shape[1], p=self.trans[bk]) for bk in bucket
            ])
            tokens[:, t + 1] = self.top_ids[bucket, choice_idx]
            bucket = tokens[:, t + 1] % self.n_buckets
        batch = {"labels": torch.from_numpy(tokens[:, 1:].copy()).to(self.device)}
        if self.cfg.frontend:
            # stub frontend: deterministic embeddings derived from token ids
            proj = np.sin(
                tokens[:, :-1, None] * np.linspace(0.01, 1, self.cfg.frontend_dim)
            ).astype(np.float32)
            batch["frames"] = torch.from_numpy(proj).to(self.device, torch.bfloat16)
        else:
            batch["tokens"] = torch.from_numpy(tokens[:, :-1].copy()).to(self.device)
        return batch


def make_batch_iterator(cfg, global_batch, seq_len, seed=0, start_step=0, device="cuda"):
    """(step, batch) from start_step on, without end: this process's slice
    of each global batch (host index and count from torch.distributed when
    it is initialised, else 0 and 1)."""
    pipe = SyntheticTokenPipeline(cfg, global_batch, seq_len, seed, host_index=process_index(),
                                  host_count=process_count(), device=device)
    step = start_step
    while True:
        yield step, pipe.batch(step)
        step += 1
