"""LM model zoo: composable blocks in plain PyTorch, for training and serving.

Counterpart of `repro.models`. Block taxonomy (each layer = sequence mixer +
channel mixer):
  sequence mixers : gqa | local_attn | mla | rglru | ssd
  channel mixers  : ffn (swiglu / squared_relu / gelu) | moe | none

Layers stack in run-length-encoded segments of identical layer kinds, with
the reference's parameter tree (params.layer_plan); a Python loop takes the
place of `lax.scan`. `loss_fn` gives the training loss (chunked
cross-entropy, the MTP auxiliary), and attention carries the flash
backward. Every kind runs, for all ten configs.
"""

from repro_torch.models.model import (  # noqa: F401
    decode_step,
    forward_train,
    init_cache,
    init_params,
    loss_fn,
    prefill,
)
from repro_torch.models.params import count_params, param_specs  # noqa: F401
