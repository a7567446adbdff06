"""Gradient compression: int8 quantization with error feedback.

Counterpart of `repro.train.compression`. Each gradient leaf, plus its
carried error, is quantized to int8 with one per-leaf scale
(max(max |g|, 1e-12) / 127; round half to even, as `jnp.round` and
`torch.round` both do; clipped to +-127), dequantized, and the
quantization error is carried into the next step (error feedback). On one
card there is no all-reduce for the int8 form to shrink; the semantic
contract (the int8 values and the error feedback) is what the port keeps.
"""

from __future__ import annotations

import torch

from repro_torch.tree import leaves, unflatten


def compression_init(params):
    """Error-feedback buffers, f32 zeros shaped like each parameter leaf."""
    return unflatten(params, [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                              for p in leaves(params)])


def _quantize_leaf(g: torch.Tensor):
    """(int8 values, f32 0-d scale) of an f32 leaf."""
    scale = torch.clamp_min(torch.max(torch.abs(g)), 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compress_decompress_grads(grads, error_buf):
    """Returns (dequantized grads in each gradient's dtype, new f32 error
    buffers): new_error = (g + e) - dequant(quant(g + e))."""
    def one(g, e):
        g32 = g.float() + e
        q, scale = _quantize_leaf(g32)
        deq = q.float() * scale
        return deq.to(g.dtype), g32 - deq

    out = [one(g, e) for g, e in zip(leaves(grads), leaves(error_buf))]
    return unflatten(grads, [o[0] for o in out]), unflatten(grads, [o[1] for o in out])
