"""Wrappers of the hand-written CUDA Lp kernels.

`pairwise_lp`, `rowwise_lp`, `gather_lp`, `gather_lp_abandon` and
`gather_lp_screen` take the place of the Pallas kernels
`pairwise_lp_kernel_call`, `rowwise_lp_kernel_call`,
`gather_lp_kernel_call`, `gather_lp_abandon_kernel_call` and
`gather_lp_screen_kernel_call` of `repro.kernels.lp_distance` (the sixth,
`lp_topk`, has its own module, `kernels.lp_topk`); `gather_lp_multi` is
`gather_lp_kernel_call`'s function under two static p at once, for the
bulk build's shared scoring pass. For CUDA tensors each
launches its kernel (built at first use by `kernels._build`) on the
current stream, or raises; for CPU tensors each runs its plain version
from `kernels.ref`. Each keeps a count of its kernel launches in its
`launches` attribute, so that a run can show that a path went through the
kernel; `launch_counts` reads all seven.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.core.lp_ops import is_static_p
from repro_torch.kernels import _build
from repro_torch.kernels.ref import (
    gather_lp_abandon_ref,
    gather_lp_ref,
    gather_lp_screen_ref,
    pairwise_lp_ref,
    rowwise_lp_ref,
)

_WRAPPERS = ("pairwise_lp", "rowwise_lp", "gather_lp", "gather_lp_multi", "gather_lp_abandon",
             "gather_lp_screen")


def _wrappers() -> dict:
    """Every kernel wrapper by name, `kernels.lp_topk.lp_topk` included
    (imported here, since that module imports this one)."""
    from repro_torch.kernels import lp_topk

    return {**{name: globals()[name] for name in _WRAPPERS}, "lp_topk": lp_topk.lp_topk}


def reset_launch_counts() -> None:
    """Sets every kernel's launch count to 0."""
    for fn in _wrappers().values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in _wrappers().items()}


def _on_cpu(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return False
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}: the kernels run on CUDA")
    return False


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device:
        raise ValueError(f"{name}: expected {dtype} {shape} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _p_rows(p, b: int, device) -> torch.Tensor:
    """p as the kernels take it: a contiguous (B,) float32 tensor."""
    if is_static_p(p):
        return torch.full((b,), float(p), dtype=torch.float32, device=device)
    p = torch.as_tensor(p, dtype=torch.float32, device=device).reshape(-1)
    return p.expand(b).contiguous() if p.numel() == 1 else p.contiguous()


def _p_launch(p, b: int, q: torch.Tensor):
    """p as the launchers take it: (the (B,) tensor to keep alive or None,
    its address or 0, the scalar p or 0.0). A scalar goes in as the scalar;
    a float32 (B,) contiguous tensor on q's device goes in as it is."""
    if is_static_p(p):
        return None, 0, float(p)
    pv = p if (torch.is_tensor(p) and p.dtype == torch.float32
               and p.get_device() == q.get_device() and p.shape == (b,)
               and p.is_contiguous()) else _p_rows(p, b, q.device)
    return pv, pv.data_ptr(), 0.0


_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(t: torch.Tensor | None = None) -> int:
    """The current CUDA stream (of t's device) as a raw pointer, through the
    cheap private accessor where this torch has it."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(t.get_device() if t is not None else torch.cuda.current_device())
    return torch.cuda.current_stream().cuda_stream


_PACKED = threading.local()


def _packed(*args) -> int:
    """The address of this thread's int64 argument array, its first
    len(args) entries filled with args (ints, at most 24): one ctypes
    argument in place of many."""
    buf = getattr(_PACKED, "buf", None)
    if buf is None:
        buf = _PACKED.buf = (ctypes.c_int64 * 24)()
    buf[:len(args)] = args
    return ctypes.addressof(buf)


def _row_strided(t: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(t with unit column stride, its row stride): a column slice of a
    wider (B, C) tensor goes to a kernel as it is, read through its row
    stride; anything else is copied."""
    stride = t.stride()
    if stride[1] != 1:
        t = t.contiguous()
        stride = t.stride()
    return t, stride[0]


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {err}")


def pairwise_lp(q: torch.Tensor, x: torch.Tensor, p) -> torch.Tensor:
    """Root-free all-pairs sum_j |q[b, j] - x[i, j]|^p -> (B, N) float32.

    q (B, d) f32, x (N, d) f32, p a float or (B,) tensor. Rows under p = 2
    take the product identity |q|^2 + |x|^2 - 2 q.x, clamped at 0. A
    scalar p goes in as a kernel argument.
    """
    if _on_cpu(q):
        return pairwise_lp_ref(q, x, p)
    b, d = q.shape
    n = x.shape[0]
    if not q.is_contiguous():
        q = q.contiguous()
    if not x.is_contiguous():
        x = x.contiguous()
    if not (q.dtype == x.dtype == torch.float32 and x.device == q.device and x.shape[1] == d):
        _check("q", q, torch.float32, (b, d), x.device)
        _check("x", x, torch.float32, (n, d), q.device)
    if is_static_p(p):
        p_ptr, p_scalar = None, float(p)
    else:
        pv = _p_rows(p, b, q.device)
        p_ptr, p_scalar = pv.data_ptr(), 0.0
    out = torch.empty((b, n), dtype=torch.float32, device=q.device)
    err = _build.launcher("pairwise_lp")(
        q.data_ptr(), x.data_ptr(), p_ptr, p_scalar, out.data_ptr(), b, n, d, _stream(q))
    pairwise_lp.launches += 1
    _raise_on(err, "pairwise_lp")
    return out


def rowwise_lp(q: torch.Tensor, c: torch.Tensor, p) -> torch.Tensor:
    """Root-free sum_j |q[b, j] - c[b, i, j]|^p -> (B, C) float32.

    q (B, d) f32, c (B, C, d) f32 pre-gathered candidate rows, p a float or
    (B,) tensor. Rows under p = 2 sum the squared differences directly; the
    Pallas kernel takes the product identity |q|^2 + |c|^2 - 2 q.c there,
    which differs from it by the identity's cancellation error. Under a p
    outside {0.5, 1, 1.5, 2} the kernel takes a^p on the special function
    unit (csrc/rowwise_lp.cu), within about 2^-21 of the plain version's
    power per term. A scalar p goes in as a kernel argument.
    """
    if _on_cpu(q):
        return rowwise_lp_ref(q, c, p)
    b, d = q.shape
    cc = c.shape[1]
    if not q.is_contiguous():
        q = q.contiguous()
    if not c.is_contiguous():
        c = c.contiguous()
    if not (q.dtype == c.dtype == torch.float32 and c.get_device() == q.get_device()
            and c.shape == (b, cc, d)):
        _check("q", q, torch.float32, (b, d), c.device)
        _check("c", c, torch.float32, (b, cc, d), q.device)
    pv, p_ptr, p_scalar = _p_launch(p, b, q)
    out = q.new_empty(b, cc)
    err = _build.launcher("rowwise_lp")(_packed(
        q.data_ptr(), c.data_ptr(), p_ptr, out.data_ptr(), b, cc, d, _stream(q)), p_scalar)
    rowwise_lp.launches += 1
    _raise_on(err, "rowwise_lp")
    return out


def gather_lp(q: torch.Tensor, ids: torch.Tensor, x: torch.Tensor, p) -> torch.Tensor:
    """Root-free sum_j |q[b, j] - x[ids[b, c], j]|^p -> (B, C) float32.

    q (B, d) f32, ids (B, C) int, x (n, d) f32, p a float or (B,) tensor.
    Ids outside [0, n) are padding and score +inf. A scalar p goes in as a
    kernel argument; int32 ids go in without a copy.
    """
    if _on_cpu(q):
        return gather_lp_ref(q, ids, x, p)
    b, d = q.shape
    c = ids.shape[1]
    n = x.shape[0]
    if ids.dtype != torch.int32:
        ids = ids.to(torch.int32)
    if not ids.is_contiguous():
        ids = ids.contiguous()
    if not q.is_contiguous():
        q = q.contiguous()
    if not x.is_contiguous():
        x = x.contiguous()
    di = q.get_device()
    pv, p_ptr, p_scalar = _p_launch(p, b, q)
    if not (x.dtype == q.dtype == torch.float32 and x.get_device() == ids.get_device() == di
            and x.shape[1] == d and ids.shape[0] == b):
        _check("q", q, torch.float32, (b, d), x.device)
        _check("x", x, torch.float32, (n, d), q.device)
        _check("ids", ids, torch.int32, (b, c), q.device)
    out = q.new_empty(b, c)
    err = _build.launcher("gather_lp")(_packed(
        ids.data_ptr(), q.data_ptr(), x.data_ptr(), p_ptr, out.data_ptr(), b, c, n, d,
        _stream(q)), p_scalar)
    gather_lp.launches += 1
    _raise_on(err, "gather_lp")
    return out


# Corpus rows per slab of gather_lp_multi's grid: the rows that the blocks in
# flight at one moment read, sized to stay in the H100's 50 MB L2 (0: one slab).
SLAB_BYTES = 16 << 20


def gather_plan(ids: torch.Tensor, n: int, slab_rows: int):
    """The order gather_lp_multi's kernel walks a block of ids in ->
    (sids (B, C) int32: each row's ids sorted ascending; perm (B, C)
    int64: the slot each sorted position came from; off (B, S + 1) int32
    or None: each row's span of sorted positions in each slab of
    `slab_rows` corpus rows, the first span from 0 and the last to C, so
    the padding ids go with them; None for one slab).

    Plain torch: on the card it runs before the kernel, on the CPU the
    tests hold its bookkeeping against the plain version.
    """
    if ids.dtype != torch.int32:
        ids = ids.to(torch.int32)
    sids, perm = torch.sort(ids, dim=1, stable=True)
    b, c = ids.shape
    if slab_rows <= 0 or slab_rows >= n:
        return sids, perm, None
    slabs = -(-n // slab_rows)
    edges = torch.arange(slabs + 1, dtype=torch.int32, device=ids.device) * slab_rows
    off = torch.searchsorted(sids, edges.expand(b, slabs + 1).contiguous(), out_int32=True)
    off[:, 0] = 0
    off[:, slabs] = c
    return sids, perm, off


def gather_lp_multi(q: torch.Tensor, ids: torch.Tensor, x: torch.Tensor,
                    ps: tuple[float, ...]) -> torch.Tensor:
    """Root-free sums of one id block under several static p -> (P, B, C)
    float32: out[i] equals gather_lp(q, ids, x, ps[i]) bit for bit.

    q (B, d) f32, ids (B, C) int, x (n, d) f32, ps one or two floats. Ids
    outside [0, n) are padding and score +inf. The kernel reads each
    distinct row of a query's block once for every p (see
    csrc/gather_lp_multi.cu); the sort that finds the duplicates stays
    inside this call, which returns the caller's slot order.
    """
    ps = tuple(float(p) for p in ps)
    if not 1 <= len(ps) <= 2:
        raise ValueError(f"gather_lp_multi takes one or two p, got {len(ps)}")
    if _on_cpu(q):
        return torch.stack([gather_lp_ref(q, ids, x, p) for p in ps])
    b, d = q.shape
    c = ids.shape[1]
    n = x.shape[0]
    if not q.is_contiguous():
        q = q.contiguous()
    if not x.is_contiguous():
        x = x.contiguous()
    if not (x.dtype == q.dtype == torch.float32 and x.get_device() == ids.get_device()
            == q.get_device() and x.shape[1] == d and ids.shape[0] == b):
        _check("q", q, torch.float32, (b, d), x.device)
        _check("x", x, torch.float32, (n, d), q.device)
        _check("ids", ids, ids.dtype, (b, c), q.device)
    slab_rows = SLAB_BYTES // (4 * max(d, 1)) if SLAB_BYTES > 0 else 0
    sids, perm, off = gather_plan(ids, n, slab_rows)
    slabs = 1 if off is None else off.shape[1] - 1
    out = q.new_empty(len(ps), b, c)
    err = _build.launcher("gather_lp_multi")(_packed(
        sids.data_ptr(), perm.data_ptr(), 0 if off is None else off.data_ptr(), q.data_ptr(),
        x.data_ptr(), out.data_ptr(), b, c, n, d, slabs, len(ps), _stream(q)),
        ps[0], ps[-1])
    gather_lp_multi.launches += 1
    _raise_on(err, "gather_lp_multi")
    return out


def gather_lp_abandon(q: torch.Tensor, ids: torch.Tensor, x: torch.Tensor,
                      thresh: torch.Tensor, sb: torch.Tensor, p, base_p: float,
                      block_d: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Early-abandoning blocked scan -> (dists (B, C) f32, nd (B, C) int32).

    thresh (B,) f32 is each row's abandon bound in power-sum space (-inf
    freezes the row, +inf never abandons); sb (B, C) f32 the base-metric
    power sums (0 disables the bounds); base_p 1.0 or 2.0 names their
    metric; block_d must divide d. Dead and padding candidates score +inf.
    ids (int32) and sb may be column slices of wider tensors: the kernel
    reads them through their row strides, so the verification loop's
    slices go in without a copy; a scalar p goes in as a kernel argument.
    The verification loop calls this once per kappa batch, so the checks
    are kept to cheap attribute reads (the message is built on failure).
    """
    if _on_cpu(q):
        return gather_lp_abandon_ref(q, ids, x, thresh, sb, p, base_p, block_d)
    b, d = q.shape
    c = ids.shape[1]
    n = x.shape[0]
    if base_p not in (1.0, 2.0):
        raise ValueError(f"base_p must be 1.0 or 2.0, got {base_p}")
    if block_d <= 0 or d % block_d:
        raise ValueError(f"block_d={block_d} does not divide d={d}")
    if ids.dtype != torch.int32:
        ids = ids.to(torch.int32)
    ids, ids_stride = _row_strided(ids)
    sb, sb_stride = _row_strided(sb)
    if not q.is_contiguous():
        q = q.contiguous()
    if not x.is_contiguous():
        x = x.contiguous()
    if not thresh.is_contiguous():
        thresh = thresh.contiguous()
    di = q.get_device()
    pv, p_ptr, p_scalar = _p_launch(p, b, q)
    if not (x.dtype == q.dtype == sb.dtype == thresh.dtype == torch.float32
            and x.get_device() == ids.get_device() == sb.get_device() == thresh.get_device() == di
            and x.shape[1] == d and ids.shape[0] == b and sb.shape == (b, c)
            and thresh.shape == (b,)):
        _check("q", q, torch.float32, (b, d), x.device)
        _check("x", x, torch.float32, (n, d), q.device)
        _check("ids", ids, torch.int32, (b, c), q.device)
        _check("thresh", thresh, torch.float32, (b,), q.device)
        _check("sb", sb, torch.float32, (b, c), q.device)
    out = q.new_empty(b, c)
    nd = ids.new_empty(b, c)
    err = _build.launcher("gather_lp_abandon")(_packed(
        ids.data_ptr(), ids_stride, q.data_ptr(), thresh.data_ptr(), sb.data_ptr(),
        sb_stride, x.data_ptr(), p_ptr, out.data_ptr(), nd.data_ptr(), b, c, n, d,
        block_d, 1 if base_p == 1.0 else 0, _stream(q)), p_scalar)
    gather_lp_abandon.launches += 1
    _raise_on(err, "gather_lp_abandon")
    return out, nd


def gather_lp_screen(q: torch.Tensor, ids: torch.Tensor, codes: torch.Tensor,
                     scale: torch.Tensor, radius: torch.Tensor, thresh: torch.Tensor,
                     sb: torch.Tensor, p, base_p: float,
                     block_d: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Compressed-band screen -> (keep (B, C) bool, nd (B, C) int32).

    q (B, d) f32 in the band's coordinate order; codes (n, d) int8;
    scale, radius (d,) f32; thresh (B,) f32 (-inf freezes the row, +inf
    keeps every valid candidate); sb (B, C) f32 base-metric power sums (0
    disables the bounds) in the metric named by base_p (1.0 or 2.0);
    block_d must divide d. Padding never survives. ids (int32) and sb may
    be column slices of wider tensors: the kernel reads them through their
    row strides, so the verification loop's kappa-column slices go in
    without a copy; a scalar p goes in as a kernel argument. The loop calls
    this once per kappa batch, so the checks are kept to cheap attribute
    reads (the message is built on failure).
    """
    if _on_cpu(q):
        return gather_lp_screen_ref(q, ids, codes, scale, radius, thresh, sb, p, base_p,
                                    block_d)
    b, d = q.shape
    c = ids.shape[1]
    n = codes.shape[0]
    if base_p not in (1.0, 2.0):
        raise ValueError(f"base_p must be 1.0 or 2.0, got {base_p}")
    if block_d <= 0 or d % block_d:
        raise ValueError(f"block_d={block_d} does not divide d={d}")
    if ids.dtype != torch.int32:
        ids = ids.to(torch.int32)
    ids, ids_stride = _row_strided(ids)
    sb, sb_stride = _row_strided(sb)
    if not q.is_contiguous():
        q = q.contiguous()
    if not codes.is_contiguous():
        codes = codes.contiguous()
    if not thresh.is_contiguous():
        thresh = thresh.contiguous()
    di = q.get_device()
    pv, p_ptr, p_scalar = _p_launch(p, b, q)
    if not (q.dtype == sb.dtype == thresh.dtype == scale.dtype == radius.dtype == torch.float32
            and codes.dtype == torch.int8 and codes.get_device() == ids.get_device()
            == sb.get_device() == thresh.get_device() == scale.get_device()
            == radius.get_device() == di and codes.shape[1] == d and ids.shape[0] == b
            and sb.shape == (b, c) and thresh.shape == (b,) and scale.shape == (d,)
            and radius.shape == (d,) and scale.is_contiguous() and radius.is_contiguous()):
        _check("q", q, torch.float32, (b, d), codes.device)
        _check("codes", codes, torch.int8, (n, d), q.device)
        _check("ids", ids, torch.int32, (b, c), q.device)
        _check("scale", scale, torch.float32, (d,), q.device)
        _check("radius", radius, torch.float32, (d,), q.device)
        _check("thresh", thresh, torch.float32, (b,), q.device)
        _check("sb", sb, torch.float32, (b, c), q.device)
        raise ValueError("gather_lp_screen: scale and radius must be contiguous")
    keep = torch.empty((b, c), dtype=torch.bool, device=q.device)
    nd = ids.new_empty(b, c)
    err = _build.launcher("gather_lp_screen")(_packed(
        ids.data_ptr(), ids_stride, q.data_ptr(), thresh.data_ptr(), sb.data_ptr(),
        sb_stride, codes.data_ptr(), scale.data_ptr(), radius.data_ptr(), p_ptr,
        keep.data_ptr(), nd.data_ptr(), b, c, n, d, block_d, 1 if base_p == 1.0 else 0,
        _stream(q)), p_scalar)
    gather_lp_screen.launches += 1
    _raise_on(err, "gather_lp_screen")
    return keep, nd


for _name in _WRAPPERS:
    globals()[_name].launches = 0
