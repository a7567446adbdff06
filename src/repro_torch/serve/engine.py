"""Batched serving engine: prefill + decode steps over one KV cache.

Counterpart of `repro.serve.engine`. Requests are served in fixed-size
batches; greedy and temperature sampling. The steps run eagerly on the
params' device: the reference jit-compiles them and donates the cache, and
here the decode step writes its cache in place. Capturing the decode step
in a CUDA graph, or compiling it, is later performance work.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.sharding import Runtime
from repro_torch.models.model import decode_step, head_logits, prefill


@dataclass
class ServeEngine:
    cfg: ArchConfig
    rt: Runtime
    params: dict
    max_seq: int = 512

    def generate(self, prompts: np.ndarray, steps: int, temperature: float = 0.0,
                 seed: int = 0) -> np.ndarray:
        """Generates `steps` tokens for each prompt (greedy if temperature
        is 0) -> (B, steps) int32.

        prompts: (B, S0) int token ids. The first token comes from the
        prefill's last hidden state, then steps - 1 decode steps follow.
        Temperature sampling draws Gumbel noise from a torch.Generator
        seeded with `seed`, so it is repeatable, but its draws cannot equal
        `jax.random.categorical`'s: only greedy tokens match the
        reference's.
        """
        b, s0 = prompts.shape
        if s0 + steps > self.max_seq:
            raise ValueError(f"prompt {s0} + steps {steps} exceeds max_seq {self.max_seq}")
        dev = self.params["embed"].device
        gen = torch.Generator(device=dev).manual_seed(seed)
        with torch.no_grad():
            tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int32, device=dev)
            last_hidden, cache = prefill(self.params, {"tokens": tokens}, self.cfg, self.rt,
                                         s_max=self.max_seq)
            logits = head_logits(self.params, last_hidden, self.cfg, self.rt)
            tok = self._sample(logits[:, -1, :], temperature, gen)
            out = [tok]
            for pos in range(s0, s0 + steps - 1):
                logits, cache = decode_step(self.params, tok[:, None], cache, pos, self.cfg,
                                            self.rt)
                tok = self._sample(logits[:, -1, :], temperature, gen)
                out.append(tok)
            return torch.stack(out, dim=1).cpu().numpy()

    def _sample(self, logits: torch.Tensor, temperature: float,
                gen: torch.Generator) -> torch.Tensor:
        """The vocabulary's logits (padding sliced off) in f32; greedy takes
        the first of equal maxima, as jnp.argmax does."""
        logits = logits[..., : self.cfg.vocab_size].float()
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        u = torch.rand(logits.shape, generator=gen, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
        return torch.argmax(logits / temperature + gumbel, dim=-1).to(torch.int32)
