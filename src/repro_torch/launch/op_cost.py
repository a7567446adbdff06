"""Op-level cost model: flops, bytes, collectives and peak memory of one
eager call, counted as its aten ops dispatch.

Counterpart of `repro.launch.hlo_cost`, which parses a compiled program's
HLO. The port has no HLO: `OpCost` is a `TorchDispatchMode` that costs
every op as it runs, on real tensors or on the meta tensors of
`launch.dryrun`'s stand-ins, under the reference's accounting rules:

  * matrix products (mm, bmm, addmm, baddbmm, and what linear / einsum /
    matmul decompose to): 2 * M * N * K flops;
  * elementwise ops: 1 flop per output element;
  * reductions: 1 flop per input element;
  * the transcendental set (`TRANSCENDENTAL`, the reference's
    `_TRANSCENDENTAL` under aten's names) also counts its output elements
    in `transcendentals`;
  * views, aliases and allocations (`FREE_OPS`, and every op aten marks
    as a view) cost nothing;
  * gathers (index, index_select, embedding, gather) move 2 x their
    result's bytes and do no flops;
  * scatters, index_put_, index_add_, copies, sort and topk are heavy: they
    move their operands and result even under perfect fusion;
  * collectives count their result bytes per device and one call each,
    by the reference's five kinds (`COLLECTIVES`, `_COLLECTIVE_OPS`).

Where the port differs from the reference:

  * Loops. The reference scales a while-loop body by its trip count.
    Eager dispatch sees every layer and every chunk, so nothing is
    scaled; the remat recompute under `torch.utils.checkpoint` is
    counted as it runs, as the reference's HLO counts it.
  * Bytes. Eager torch does not fuse, so `bytes_accessed` is every
    non-free op's operands + result: what eager really moves. The
    reference's fused lower bound (only matrix products, reductions,
    gathers, heavy ops and collectives touch memory) is kept beside it
    as `bytes_min`.
  * Memory. `peak` is the most bytes of storages alive at once during
    the call: the arguments (`track`) from the start, then every storage
    an op creates until it is freed (`weakref.finalize` on its
    `untyped_storage()`). A storage is counted once, whatever views it.
    `argument_bytes`, `output_bytes` and `temp_bytes` (peak - arguments)
    are the reference's memory analysis; its `generated_code_bytes` and
    its unscaled XLA counts (`xla_flops_unscaled`, `xla_bytes_unscaled`)
    have no counterpart here and are left out.

All counts are per device: on a mesh each rank computes on its local
shards, and a DTensor argument counts its local shard.

Meta tensors. An op whose tensors are all on the meta device (the
dry-run's stand-ins: shapes, dtypes and strides, no storage behind them)
is answered from a cache of output metadata keyed by the op and its
arguments' metadata (`_Replay`): the first call runs the meta kernel,
and every later call with the same key builds its outputs
(`empty_strided`, or an `as_strided` view of the input they alias, or the
input itself for an in-place op) without it. Ops on real tensors always
run. A chunk loop repeats the
same few keys thousands of times, so this cuts the dry-run's trace time
about five-fold (`launch.dryrun`). The ops, and so the counts, are those
of the uncached run; tests/test_torch_dryrun.py holds them to a run on
real tensors.
"""

from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# c10d's process-group ops and the functional collectives, by kind
_COLLECTIVE_OPS = {
    "c10d::allgather_": "all-gather",
    "c10d::_allgather_base_": "all-gather",
    "c10d::allgather_coalesced_": "all-gather",
    "c10d::allgather_into_tensor_coalesced_": "all-gather",
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "c10d::allreduce_": "all-reduce",
    "c10d::allreduce_coalesced_": "all-reduce",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::alltoall_": "all-to-all",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "c10d::send": "collective-permute",
    "c10d::recv_": "collective-permute",
    "c10d::recv_any_source_": "collective-permute",
}

FREE_OPS = frozenset({
    "view", "_unsafe_view", "expand", "permute", "t", "transpose", "slice", "select",
    "unsqueeze", "squeeze", "as_strided", "detach", "alias", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "lift_fresh", "_reshape_alias",
    "split", "split_with_sizes", "unbind", "chunk", "narrow", "diagonal", "unfold",
    "view_as", "expand_as", "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel",
    "is_same_size", "_has_compatible_shallow_copy_type", "set_", "resize_",
    "wait_tensor", "barrier", "monitored_barrier_",
})

MATMUL_OPS = frozenset({"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot"})

REDUCTION_OPS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp", "norm",
    "linalg_vector_norm", "var", "std", "var_mean", "std_mean", "argmax", "argmin",
    "any", "all", "cumsum", "cumprod", "_softmax", "_log_softmax", "count_nonzero",
})

GATHER_OPS = frozenset({"index", "index_select", "embedding", "gather", "take"})

HEAVY_OPS = frozenset({
    "index_put", "index_put_", "_index_put_impl_", "scatter", "scatter_", "scatter_add",
    "scatter_add_", "scatter_reduce", "scatter_reduce_", "index_add", "index_add_",
    "index_copy", "index_copy_", "copy_", "clone", "sort", "topk", "_to_dense",
})

# the reference's _TRANSCENDENTAL, by aten name
TRANSCENDENTAL = frozenset({
    "exp", "exp_", "exp2", "log", "log_", "log2", "rsqrt", "rsqrt_", "sqrt", "sqrt_",
    "pow", "pow_", "tanh", "tanh_", "sigmoid", "sigmoid_", "sin", "cos", "expm1",
    "log1p", "atan2", "erf", "silu", "silu_", "gelu", "softplus", "_softmax",
    "_log_softmax", "logsumexp",
})


# ops that change their input's metadata in place: never answered from the cache
_NO_REPLAY = frozenset({
    "resize_", "resize_as_", "set_", "as_strided_", "t_", "transpose_", "squeeze_",
    "unsqueeze_", "swapdims_", "swapaxes_", "detach_", "_resize_output_",
})
_KEY_TYPES = (int, float, bool, str, type(None), torch.dtype, torch.device, torch.layout,
              torch.memory_format)


class _NoKey(Exception):
    """An argument the metadata cache cannot key (or a non-meta tensor)."""


def _key(x, tensors: list):
    """x's metadata as a hashable key; its tensors appended to `tensors`."""
    if isinstance(x, torch.Tensor):
        if type(x) is not torch.Tensor or not x.is_meta:
            raise _NoKey
        tensors.append(x)
        return (x.shape, x.stride(), x.storage_offset(), x.dtype)
    if isinstance(x, (list, tuple)):
        return (x.__class__, tuple(_key(y, tensors) for y in x))
    if isinstance(x, _KEY_TYPES):
        return (x.__class__, x)                  # True and 1 are different keys
    raise _NoKey


class _Replay:
    """Output metadata of ops on meta tensors, cached by op and argument
    metadata (see the module docstring)."""

    def __init__(self):
        self.cache: dict = {}

    def run(self, func, args, kwargs):
        tensors: list = []
        try:
            key = (func, _key(args, tensors),
                   tuple((k, _key(v, tensors)) for k, v in kwargs.items()))
        except _NoKey:
            return func(*args, **kwargs)
        hit = self.cache.get(key)
        if hit is not None:
            return self._build(hit, tensors)
        out = func(*args, **kwargs)
        if func._schema.name.partition("::")[2] not in _NO_REPLAY:
            try:
                self.cache[key] = self._record(out, tensors)
            except _NoKey:
                pass
        return out

    def _record(self, o, tensors: list):
        if isinstance(o, torch.Tensor):
            if type(o) is not torch.Tensor or not o.is_meta:
                raise _NoKey
            for i, a in enumerate(tensors):
                if a is o:
                    return ("self", i)
            st = o.untyped_storage()._cdata
            for i, a in enumerate(tensors):
                if a.untyped_storage()._cdata == st:
                    return ("view", i, tuple(o.shape), o.stride(), o.storage_offset())
            return ("new", tuple(o.shape), o.stride(), o.dtype)
        if isinstance(o, (list, tuple)):
            return ("seq", o.__class__, tuple(self._record(y, tensors) for y in o))
        if o is None or isinstance(o, (int, float, bool)):
            return ("const", o)
        raise _NoKey

    def _build(self, r, tensors: list):
        tag = r[0]
        if tag == "new":
            return torch.empty_strided(r[1], r[2], dtype=r[3], device="meta")
        if tag == "self":
            return tensors[r[1]]
        if tag == "view":
            return tensors[r[1]].as_strided(r[2], r[3], r[4])
        if tag == "seq":
            return r[1](self._build(y, tensors) for y in r[2])
        return r[1]


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; a plain tensor as it is."""
    inner = getattr(t, "_local_tensor", None)
    return t if inner is None else inner


def _nbytes(t: torch.Tensor) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


def _tensors(x, out: list | None = None) -> list:
    """The tensors in x, a tensor or nested lists / tuples / dicts of them."""
    out = [] if out is None else out
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def _classify(func) -> tuple[str, str]:
    """(kind, name) of an op: kind one of free / collective / matmul /
    reduction / gather / heavy / elementwise."""
    schema = func._schema.name                  # e.g. "aten::mm"
    if schema in _COLLECTIVE_OPS:
        return "collective", _COLLECTIVE_OPS[schema]
    ns, _, name = schema.partition("::")
    if ns in ("c10d", "_c10d_functional") or name in FREE_OPS or func.is_view:
        return "free", name
    if name.startswith("empty") or name.startswith("_empty"):
        return "free", name
    if name in MATMUL_OPS:
        return "matmul", name
    if name in REDUCTION_OPS:
        return "reduction", name
    if name in GATHER_OPS:
        return "gather", name
    if name in HEAVY_OPS:
        return "heavy", name
    return "elementwise", name


def _matmul_flops(name: str, args) -> float:
    """2 * M * N * K of a matrix-product op from its operands' shapes."""
    if name in ("addmm", "baddbmm", "addbmm", "addmv"):
        a, b = args[1], args[2]
    else:
        a, b = args[0], args[1]
    a, b = _local(a), _local(b)
    if name == "dot":
        return 2.0 * a.numel()
    if name in ("mv", "addmv"):
        return 2.0 * a.shape[0] * a.shape[1]
    if name in ("bmm", "baddbmm", "addbmm"):
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]


class OpCost(TorchDispatchMode):
    """Counts every op dispatched while it is active.

    Totals: flops, bytes (`bytes_accessed`), bytes_min, transcendentals,
    collective_bytes, collectives {kind: {count, bytes}}, and the memory
    figures (`track` the arguments first; `peak`, `live`). `report()`
    gives them as the reference's `per_device` keys."""

    def __init__(self):
        super().__init__()
        self._replay = _Replay()
        self.flops = 0.0
        self.matmul_flops = 0.0
        self.bytes = 0.0
        self.bytes_min = 0.0
        self.transcendentals = 0.0
        self.collective_bytes = 0.0
        self.collectives: dict = {}
        self.ops = 0
        self.live = 0
        self.peak = 0
        self.argument_bytes = 0
        self.output_bytes = 0
        self._storages: dict[int, int] = {}
        self._kinds: dict = {}

    # -- memory -------------------------------------------------------------

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def _hold(self, t: torch.Tensor) -> int:
        """Count t's storage as live until it is freed; 0 if already counted."""
        st = _local(t).untyped_storage()
        key = st._cdata
        if key in self._storages:
            return 0
        n = st.nbytes()
        self._storages[key] = n
        weakref.finalize(st, self._free, key)
        self.live += n
        self.peak = max(self.peak, self.live)
        return n

    def track(self, *trees) -> int:
        """Count the storages of the call's arguments (tensors or DTensors,
        in any nesting) as live from the start: `argument_bytes`."""
        n = sum(self._hold(t) for t in _tensors(trees))
        self.argument_bytes += n
        return n

    def outputs(self, tree) -> int:
        """The call's result: `output_bytes`, each storage counted once."""
        seen, n = set(), 0
        for t in _tensors(tree):
            st = _local(t).untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                n += st.nbytes()
        self.output_bytes = n
        return n

    # -- dispatch -----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace not in ("c10d", "_c10d_functional"):
            out = self._replay.run(func, args, kwargs)
        else:
            out = func(*args, **kwargs)
        kind = self._kinds.get(func)
        if kind is None:
            kind = self._kinds[func] = _classify(func)
        self.ops += 1
        for t in _tensors(out):
            self._hold(t)
        self._count(kind, func, args, kwargs, out)
        return out

    def _count(self, kind: tuple[str, str], func, args, kwargs, out) -> None:
        k, name = kind
        if k == "free":
            return
        if k == "collective":
            # a c10d op writes its first argument (in place for all-reduce,
            # send and recv, whose second argument is the group) from its
            # second; a functional collective returns its result
            if func.namespace == "_c10d_functional":
                res, ops = _tensors(out), _tensors(args[0])
            else:
                res = _tensors(args[0])
                ops = _tensors(args[1]) if len(args) > 1 else []
                ops = ops or res
            rb = float(sum(_nbytes(t) for t in res))
            ob = float(sum(_nbytes(t) for t in ops))
            self.collective_bytes += rb
            d = self.collectives.setdefault(name, {"count": 0, "bytes": 0.0})
            d["count"] += 1
            d["bytes"] += rb
            self.bytes += rb + ob
            self.bytes_min += rb + ob
            return
        outs = _tensors(out)
        out_elems = sum(_local(t).numel() for t in outs)
        out_bytes = sum(_nbytes(t) for t in outs)
        if k == "gather":
            self.bytes += 2.0 * out_bytes
            self.bytes_min += 2.0 * out_bytes
            return
        ins = _tensors((args, kwargs))
        if name == "copy_":                      # reads the source, writes the target
            moved = float(_nbytes(args[1]) + _nbytes(args[0]))
        else:
            moved = float(sum(_nbytes(t) for t in ins) + out_bytes)
        self.bytes += moved
        if k == "matmul":
            f = _matmul_flops(name, args)
            self.flops += f
            self.matmul_flops += f
            self.bytes_min += moved
        elif k == "reduction":
            self.flops += float(_local(ins[0]).numel()) if ins else 0.0
            self.bytes_min += moved
        elif k == "heavy":
            self.bytes_min += moved
        else:
            self.flops += float(out_elems)
        if name in TRANSCENDENTAL:
            self.transcendentals += float(out_elems)

    # -- results ------------------------------------------------------------

    def report(self) -> dict:
        """The reference's per-device figures (see the module docstring for
        the keys it has and this has not)."""
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes,
            "bytes_min": self.bytes_min,
            "collective_bytes": self.collective_bytes,
            "transcendentals": self.transcendentals,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.peak - self.argument_bytes,
            "peak_bytes": self.peak,
        }


def count(fn, *args, **kwargs):
    """(fn(*args, **kwargs), its OpCost): the arguments tracked, the call
    counted, its result's bytes read."""
    cost = OpCost()
    cost.track(args, kwargs)
    with cost:
        out = fn(*args, **kwargs)
    cost.outputs(out)
    return out, cost

