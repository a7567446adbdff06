"""Wrapper of the hand-written fused Lp + top-k kernel.

`lp_topk` takes the place of the Pallas kernel `pallas_lp_topk` of
`repro.kernels.lp_topk`: for each query, the k nearest of its own
candidate block (B, C, d) under one scalar p, with only (B, k) leaving the
kernel. For CUDA tensors it launches `csrc/lp_topk.cu` on the current
stream, or raises; for CPU tensors it runs `kernels.ref.lp_topk_ref`. Its
launch count is `lp_topk.launches`, which `lp_distance.launch_counts`
reads with the other kernels'.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core.lp_ops import is_static_p, lp_root
from repro_torch.kernels import _build
from repro_torch.kernels.lp_distance import _on_cpu, _packed, _raise_on, _stream
from repro_torch.kernels.ref import lp_topk_ref

# The kernel's shared-memory plan (csrc/lp_topk.cu): WARPS warps a block, each
# with a ring of STAGES candidate rows (rows of up to RING_MAX_D floats; wider
# rows are read from device memory), two lists of k entries and PENDING
# filtered candidates between merges.
WARPS = 8
STAGES = 3
RING_MAX_D = 1024
PENDING = 32
SMEM_OPTIN_BYTES = 232_448  # shared memory a block may opt into on an H100 (227 KB)


def smem_bytes(d: int, k: int) -> int:
    """Dynamic shared memory of one lp_topk block: the query row, the warps'
    rings, and each warp's two lists of k entries and its pending
    candidates (as csrc/lp_topk.cu lays them out)."""
    dpad = (d + 3) & ~3
    ring = WARPS * STAGES * dpad if d <= RING_MAX_D else 0
    return 4 * (dpad + ring) + 8 * WARPS * (2 * k + PENDING)


@functools.lru_cache(maxsize=None)
def _smem_limit(device_index: int) -> int:
    props = torch.cuda.get_device_properties(device_index)
    return getattr(props, "shared_memory_per_block_optin", SMEM_OPTIN_BYTES)


# The reference's plain version under its own name (repro.kernels.lp_topk.ref_lp_topk):
# rowwise distances, then the k smallest in ascending order.
ref_lp_topk = lp_topk_ref


def lp_topk(q: torch.Tensor, c: torch.Tensor, p: float, k: int, root: bool = True):
    """The k nearest candidates of each query -> (dists (B, k) f32, ids (B, k)
    int32), ascending; ids index into the query's block (0..C-1) and ties go
    to the lower index.

    q (B, d) f32, c (B, C, d) f32, p one scalar (as in the reference, which
    compiles one kernel per p), 1 <= k <= C. With root the dists are Lp
    distances, else root-free power sums. On the card each warp's running
    list lives in shared memory beside its ring of candidate rows; a k
    whose lists do not fit (k above 1,400 at d = 512) raises with the
    limit.
    """
    if not is_static_p(p):
        raise ValueError("lp_topk takes one scalar p for the whole batch")
    b, cc, d = c.shape
    if not 1 <= k <= cc:
        raise ValueError(f"k = {k} must lie in [1, C = {cc}]")
    p = float(p)
    if _on_cpu(q):
        return lp_topk_ref(q, c, p, k, root)
    di = q.get_device()
    limit = _smem_limit(di)
    if smem_bytes(d, k) > limit:
        raise ValueError(f"lp_topk: k = {k} at d = {d} needs {smem_bytes(d, k)} bytes of shared "
                         f"memory, more than the {limit} a block may have")
    if not q.is_contiguous():
        q = q.contiguous()
    if not c.is_contiguous():
        c = c.contiguous()
    if not (q.dtype == c.dtype == torch.float32 and c.get_device() == di
            and q.shape == (b, d)):
        raise ValueError(f"lp_topk: expected float32 q ({b}, {d}) and c ({b}, {cc}, {d}) on one "
                         f"device, got {q.dtype} {tuple(q.shape)} on {q.device} and {c.dtype} "
                         f"on {c.device}")
    out_d = q.new_empty((b, k))
    out_i = torch.empty((b, k), dtype=torch.int32, device=q.device)
    err = _build.launcher("lp_topk")(_packed(
        q.data_ptr(), c.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), b, cc, d, k, _stream(q)),
        p)
    lp_topk.launches += 1
    _raise_on(err, "lp_topk")
    return (lp_root(out_d, p) if root else out_d), out_i


lp_topk.launches = 0
