"""kNN-LM over a U-HNSW datastore: retrieval-augmented decoding where the
retrieval metric p is a *per-request* knob.

Counterpart of `repro.retrieval.knn_lm`. Standard kNN-LM (Khandelwal et al.
2020) interpolates the LM's next-token distribution with a nearest-neighbor
distribution over (hidden-state -> next-token) pairs:
p(y) = (1-lam) p_LM(y) + lam p_kNN(y), where p_kNN weights neighbors by
exp(-d(h, h_i) / T), normalised over the k neighbours.

The U-HNSW index makes d an *arbitrary Lp* distance chosen at query time.
The datastore search is `UHNSW.search` (the `gather_lp` and
`gather_lp_abandon` kernels on the card); the weights and the vocabulary
scatter run on the index's device in float64, as the reference's numpy
code does. The weights take no max out before the exp, as the reference's
do: once a query's nearest distance exceeds about 69 T, every weight
underflows the 1e-30 floor of the normaliser, so T must be set at the
scale of the distances, which grow with d and shrink with p.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.uhnsw import UHNSW


@dataclass
class KnnLM:
    index: UHNSW
    values: torch.Tensor        # (n,) int64 next-token id per datastore entry
    vocab_size: int
    lam: float = 0.25
    temperature: float = 1.0
    k: int = 8

    @staticmethod
    def build_from_hidden(hidden, next_tokens, vocab_size: int, m: int = 16, seed: int = 0,
                          device=None, **kw) -> "KnnLM":
        """Datastore of (hidden (n, d), next token (n,)) pairs: G1 under L1
        at `seed` and G2 under L2 at `seed + 1` from the host bulk builder,
        as the reference builds them. device: where the index lives (None:
        the tensor's own device, or "cuda" for a numpy array)."""
        from repro_torch.core.build import build_hnsw_bulk

        g1 = build_hnsw_bulk(hidden, 1.0, m=m, seed=seed, device=device)
        g2 = build_hnsw_bulk(g1.data, 2.0, m=m, seed=seed + 1)
        values = torch.as_tensor(np.asarray(next_tokens.cpu() if torch.is_tensor(next_tokens)
                                            else next_tokens), dtype=torch.int64,
                                 device=g1.data.device)
        return KnnLM(UHNSW(g1, g2), values, vocab_size, **kw)

    @property
    def device(self) -> torch.device:
        return self.index.X.device

    def knn_logprobs(self, h, p: float) -> torch.Tensor:
        """log p_kNN over the vocab (B, V) float64 for query hidden states h
        (B, d), metric Lp, on the index's device."""
        ids, dists, _ = self.index.search(h, p, self.k)
        return self.neighbour_logprobs(ids, dists)

    def neighbour_logprobs(self, ids: torch.Tensor, dists: torch.Tensor) -> torch.Tensor:
        """log p_kNN (B, V) float64 from each query's k neighbours (ids into
        the datastore, rooted distances), as `knn_logprobs` weighs them."""
        w = torch.exp(-dists.double() / self.temperature)
        w = w / torch.clamp_min(w.sum(dim=1, keepdim=True), 1e-30)
        out = torch.zeros((ids.shape[0], self.vocab_size), dtype=torch.float64,
                          device=self.device)
        out.scatter_add_(1, self.values[ids.long()], w)
        return torch.log(torch.clamp_min(out, 1e-30))

    def mix(self, lm_logprobs, h, p: float) -> torch.Tensor:
        """(1-lam) p_LM + lam p_kNN in probability space; returns log-probs
        (B, V) float64 on the index's device."""
        return self.mix_logprobs(lm_logprobs, self.knn_logprobs(h, p))

    def mix_logprobs(self, lm_logprobs, knn_logprobs: torch.Tensor) -> torch.Tensor:
        """`mix` given log p_kNN already computed (`knn_logprobs` or
        `neighbour_logprobs`)."""
        lm = torch.as_tensor(lm_logprobs, dtype=torch.float64, device=self.device)
        mixed = (1 - self.lam) * torch.exp(lm) + self.lam * torch.exp(knn_logprobs)
        return torch.log(torch.clamp_min(mixed, 1e-30))
