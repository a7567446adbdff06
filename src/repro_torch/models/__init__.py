"""LM model zoo, serving half: composable blocks in plain PyTorch.

Counterpart of `repro.models`. Block taxonomy (each layer = sequence mixer +
channel mixer):
  sequence mixers : gqa (ported) | local_gqa | mla | rglru | ssd
  channel mixers  : ffn (swiglu / squared_relu / gelu; ported) | moe | none

Layers stack in run-length-encoded segments of identical layer kinds, with
the reference's parameter tree (params.layer_plan); a Python loop takes the
place of `lax.scan`. Only `gqa+ffn` runs so far: the other kinds and the
loss wait for ROADMAP queue 1 items 11(b) and 11(a).
"""

from repro_torch.models.model import (  # noqa: F401
    decode_step,
    forward_train,
    init_cache,
    init_params,
    prefill,
)
from repro_torch.models.params import count_params, param_specs  # noqa: F401
