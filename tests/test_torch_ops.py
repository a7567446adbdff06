"""The port's Lp op table, metrics and candidate-scoring ops against `repro`.

Inputs come from numpy with a fixed seed and go through both packages; JAX
runs its default CPU dispatch (the jnp references), as repro's own tests do.
On CPU tensors the port's kernel wrappers run their plain versions, so these
tests hold the plain versions' semantics; `chip_smoke.py` holds the CUDA
kernels against the same plain versions on the card.

Tolerances: ids, `nd` and every integer counter are equal; float32 results
agree to rtol 1e-5, atol 1e-6, because the two frameworks sum in different
orders (and their exp/log may differ in the last ulp). The p = 2 all-pairs
form uses the product identity |q|^2 + |x|^2 - 2 q.x, whose cancellation
error scales with the squared norms, so there the power sums agree to an
atol of 1e-6 times the largest |q|^2 + |x|^2.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lp_ops as rlp
from repro.core import metrics as rmet
from repro.kernels import ops as rops
from repro_torch.core import lp_ops as tlp
from repro_torch.core import metrics as tmet
from repro_torch.kernels import _build, lp_distance
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import gather_lp_abandon_ref, gather_lp_ref, pairwise_lp_ref
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

P_GRID = [0.5, 0.8, 1.0, 1.25, 1.5, 2.0]
RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, err=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want), err_msg=err)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL, err_msg=err)


def _close_pairwise(got, want, q, x, p, root):
    """All-pairs results; rows under p = 2 are compared as power sums with
    the product identity's norm-scaled atol (see the module docstring)."""
    got = got.numpy()
    want = np.asarray(want)
    l2 = np.broadcast_to(np.asarray(p, np.float32).reshape(-1, 1) == 2.0, want.shape)
    _close(got[~l2], want[~l2])
    if root:
        got, want = got**2, want**2
    scale = float(((q * q).sum(1)[:, None] + (x * x).sum(1)[None, :]).max())
    np.testing.assert_allclose(got[l2], want[l2], rtol=RTOL, atol=ATOL * scale)


def _diffs(seed=0, shape=(6, 40)):
    """Random differences with exact zeros sprinkled in."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(shape) * 3).astype(np.float32)
    a[rng.random(shape) < 0.1] = 0.0
    return a


def _p_rows(b, seed=1):
    rng = np.random.default_rng(seed)
    return rng.choice(np.array(P_GRID, np.float32), size=b)


@pytest.mark.parametrize("p", P_GRID)
def test_pow_and_root_match_reference(p):
    a = _diffs()
    _close(tlp.abs_pow(torch.from_numpy(a), p), rlp.abs_pow(jnp.asarray(a), p))
    aa = np.abs(a)
    _close(tlp.pow_from_abs(torch.from_numpy(aa), p), rlp.pow_from_abs(jnp.asarray(aa), p))
    _close(tlp.lp_root(torch.from_numpy(aa), p), rlp.lp_root(jnp.asarray(aa), p))


def test_per_row_p_gives_the_scalar_bits():
    """The scalar-vs-vector contract: row i under p[i] equals the scalar
    call at p[i] bit for bit, and agrees with the reference's vector form."""
    a = np.abs(_diffs(2))
    pv = _p_rows(a.shape[0])
    at = torch.from_numpy(a)
    got_pow = tlp.pow_from_abs(at, torch.from_numpy(pv)[:, None])
    got_root = tlp.lp_root(at, torch.from_numpy(pv)[:, None])
    for i, p in enumerate(pv):
        np.testing.assert_array_equal(got_pow[i].numpy(), tlp.pow_from_abs(at[i], float(p)).numpy())
        np.testing.assert_array_equal(got_root[i].numpy(), tlp.lp_root(at[i], float(p)).numpy())
    _close(got_pow, rlp.pow_from_abs(jnp.asarray(a), jnp.asarray(pv)[:, None]))
    _close(got_root, rlp.lp_root(jnp.asarray(a), jnp.asarray(pv)[:, None]))


@pytest.mark.parametrize("base_p", [1.0, 2.0])
@pytest.mark.parametrize("p", P_GRID)
def test_entry_and_suffix_bounds_match_reference(base_p, p):
    rng = np.random.default_rng(3)
    sb = (rng.random((5, 7)) * 50).astype(np.float32)
    sb[0, :3] = [0.0, -1.0, 1e-35]
    for d in (512, 32.0, 1):
        _close(tlp.lp_entry_bound(torch.from_numpy(sb), base_p, p, d),
               rlp.lp_entry_bound(jnp.asarray(sb), base_p, p, d))
        _close(tlp.lp_suffix_bound(torch.from_numpy(sb), base_p, p, d),
               rlp.lp_suffix_bound(jnp.asarray(sb), base_p, p, d))
    pv = _p_rows(5, seed=4)
    _close(tlp.lp_entry_bound(torch.from_numpy(sb), base_p, torch.from_numpy(pv)[:, None], 96),
           rlp.lp_entry_bound(jnp.asarray(sb), base_p, jnp.asarray(pv)[:, None], 96))


@pytest.mark.parametrize("root", [False, True])
@pytest.mark.parametrize("p", P_GRID)
def test_metrics_match_reference(p, root):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((4, 24)).astype(np.float32)
    x = rng.standard_normal((9, 24)).astype(np.float32)
    x[0] = q[0]                                    # a zero difference row
    c = rng.standard_normal((4, 6, 24)).astype(np.float32)
    tq, tx, tc = map(torch.from_numpy, (q, x, c))
    _close(tmet.lp_distance(tq[:, None], tx[None], p, root),
           rmet.lp_distance(jnp.asarray(q)[:, None], jnp.asarray(x)[None], p, root))
    _close_pairwise(tmet.pairwise_lp(tq, tx, p, root),
                    rmet.pairwise_lp(jnp.asarray(q), jnp.asarray(x), p, root), q, x, p, root)
    _close(tmet.rowwise_lp(tq, tc, p, root),
           rmet.rowwise_lp(jnp.asarray(q), jnp.asarray(c), p, root))


def test_metrics_per_row_p_match_reference():
    rng = np.random.default_rng(6)
    q = rng.standard_normal((6, 16)).astype(np.float32)
    x = rng.standard_normal((7, 16)).astype(np.float32)
    c = rng.standard_normal((6, 5, 16)).astype(np.float32)
    pv = _p_rows(6, seed=7)
    tq, tx, tc, tp = map(torch.from_numpy, (q, x, c, pv))
    for root in (False, True):
        _close_pairwise(tmet.pairwise_lp(tq, tx, tp, root),
                        rmet.pairwise_lp(jnp.asarray(q), jnp.asarray(x), jnp.asarray(pv), root),
                        q, x, pv, root)
        _close(tmet.rowwise_lp(tq, tc, tp, root),
               rmet.rowwise_lp(jnp.asarray(q), jnp.asarray(c), jnp.asarray(pv), root))
        _close(tmet.lp_distance(tq, tc[:, 0], tp, root),
               rmet.lp_distance(jnp.asarray(q), jnp.asarray(c[:, 0]), jnp.asarray(pv), root))


def test_base_metric_rule_and_cost_model_match_reference():
    pv = np.array([0.5, 1.4, 1.41, 2.0], np.float32)
    np.testing.assert_array_equal(tmet.base_metric_for(pv), rmet.base_metric_for(pv))
    np.testing.assert_array_equal(tmet.base_metric_for(torch.from_numpy(pv)),
                                  rmet.base_metric_for(pv))
    for p in P_GRID:
        assert tmet.base_metric_for(p) == rmet.base_metric_for(p)
        assert tmet.lp_distance_cost_model(p, 96) == rmet.lp_distance_cost_model(p, 96)
    for bad in (0.4, 2.1, float("nan")):
        with pytest.raises(ValueError):
            tmet.base_metric_for(bad)
    q = np.ones((2, 3), np.float32)
    np.testing.assert_array_equal(tmet.numpy_lp(q, q + 1, 0.5), rmet.numpy_lp(q, q + 1, 0.5))


def _gather_case(seed=0, b=6, c=40, n=250, d=64):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, d)) * 2).astype(np.float32)
    x = (rng.standard_normal((n, d)) * 2).astype(np.float32)
    ids = rng.integers(-1, n + 2, size=(b, c)).astype(np.int32)   # -1, n, n+1 are padding
    return q, x, ids, rng


@pytest.mark.parametrize("p", P_GRID + ["rows"])
def test_lp_gather_distance_matches_reference(p):
    q, x, ids, _ = _gather_case()
    pt = torch.from_numpy(_p_rows(q.shape[0])) if p == "rows" else p
    pj = jnp.asarray(pt.numpy()) if p == "rows" else p
    for root in (False, True):
        got = tops.lp_gather_distance(torch.from_numpy(q), torch.from_numpy(ids),
                                      torch.from_numpy(x), pt, root=root)
        want = rops.lp_gather_distance(jnp.asarray(q), jnp.asarray(ids), jnp.asarray(x), pj,
                                       root=root)
        _close(got, want, f"p={p} root={root}")


@pytest.mark.parametrize("p", [0.8, 2.0, "rows"])
def test_lp_gather_distance_shared_ids_matches_reference(p):
    """1-D ids: every query scores the same rows (pairwise form)."""
    q, x, ids, _ = _gather_case(seed=1)
    row = ids[0]
    pt = torch.from_numpy(_p_rows(q.shape[0])) if p == "rows" else p
    pj = jnp.asarray(pt.numpy()) if p == "rows" else p
    got = tops.lp_gather_distance(torch.from_numpy(q), torch.from_numpy(row),
                                  torch.from_numpy(x), pt)
    want = rops.lp_gather_distance(jnp.asarray(q), jnp.asarray(row), jnp.asarray(x), pj)
    _close(got, want)


def _close_pairwise_norm(got, want, q, x, p):
    """All-pairs power sums: rtol 1e-5, and for rows under p = 2 (the
    product identity) an atol of 1e-5 * (|q|^2 + |x|^2) per entry."""
    got, want = np.asarray(got), np.asarray(want)
    l2 = np.broadcast_to(np.asarray(p, np.float32).reshape(-1, 1) == 2.0, want.shape)
    _close(got[~l2], want[~l2])
    norms = (q * q).sum(1)[:, None] + (x * x).sum(1)[None, :]
    np.testing.assert_array_less(np.abs(got - want)[l2], (RTOL * norms + ATOL)[l2])


@pytest.mark.parametrize("p", P_GRID + ["rows"])
def test_pairwise_lp_matches_reference(p):
    """The pairwise kernel's plain version and its dispatcher against the
    reference's dispatch, including zero differences and p = 2 rows."""
    rng = np.random.default_rng(9)
    q = (rng.standard_normal((7, 48)) * 3).astype(np.float32)
    x = (rng.standard_normal((33, 48)) * 3).astype(np.float32)
    x[4] = q[2]
    pt = torch.from_numpy(_p_rows(q.shape[0], seed=10)) if p == "rows" else p
    pj = jnp.asarray(pt.numpy()) if p == "rows" else p
    pv = pt.numpy() if p == "rows" else p
    want = rops.lp_pairwise_distance(jnp.asarray(q), jnp.asarray(x), pj)
    tq, tx = torch.from_numpy(q), torch.from_numpy(x)
    _close_pairwise_norm(pairwise_lp_ref(tq, tx, pt).numpy(), want, q, x, pv)
    _close_pairwise_norm(tops.lp_pairwise_distance(tq, tx, pt).numpy(), want, q, x, pv)
    _close_pairwise(tops.lp_pairwise_distance(tq, tx, pt, root=True),
                    rops.lp_pairwise_distance(jnp.asarray(q), jnp.asarray(x), pj, root=True),
                    q, x, pv, True)


def test_shared_ids_form_goes_through_the_pairwise_wrapper(monkeypatch):
    """The 1-D ids form of lp_gather_distance scores through the pairwise
    kernel's wrapper (on a CUDA tensor, the kernel), with padding at +inf."""
    q, x, ids, _ = _gather_case(seed=4)
    calls = []

    def spy(qq, xx, p):
        calls.append(tuple(xx.shape))
        return pairwise_lp_ref(qq, xx, p)

    monkeypatch.setattr(lp_distance, "pairwise_lp", spy)
    row = torch.from_numpy(ids[1])
    got = tops.lp_gather_distance(torch.from_numpy(q), row, torch.from_numpy(x), 0.5)
    assert calls == [(row.numel(), x.shape[1])]
    valid = ((row >= 0) & (row < x.shape[0])).numpy()
    assert bool(torch.isinf(got[:, ~valid]).all()) and bool(torch.isfinite(got[:, valid]).all())


def _thresholds(full, rng):
    """Per-row bounds around each row's 30th percentile, plus +-inf rows."""
    fin = np.where(np.isfinite(full), full, np.nan)
    thr = np.nanpercentile(fin, 30, axis=1).astype(np.float32)
    thr *= (1.0 + 1e-3 * rng.standard_normal(thr.shape)).astype(np.float32)
    thr[0] = np.inf
    thr[1] = -np.inf
    return thr


@pytest.mark.parametrize("base_p", [1.0, 2.0])
@pytest.mark.parametrize("p", [0.5, 0.8, 1.25, 1.5, 2.0, "rows"])
def test_lp_gather_abandon_matches_reference(p, base_p):
    q, x, ids, rng = _gather_case(seed=2, d=96)
    pt = torch.from_numpy(_p_rows(q.shape[0], seed=8)) if p == "rows" else p
    pj = jnp.asarray(pt.numpy()) if p == "rows" else p
    full = np.asarray(rops.lp_gather_distance(jnp.asarray(q), jnp.asarray(ids), jnp.asarray(x), pj))
    thr = _thresholds(full, rng)
    # true base sums of the candidates, or 0 (bounds off) for some rows
    base = np.asarray(rops.lp_gather_distance(jnp.asarray(q), jnp.asarray(ids), jnp.asarray(x),
                                              base_p))
    sb = np.where(np.isfinite(base), base, 0.0).astype(np.float32)
    sb[2] = 0.0
    got, nd = tops.lp_gather_abandon(torch.from_numpy(q), torch.from_numpy(ids),
                                     torch.from_numpy(x), torch.from_numpy(thr),
                                     torch.from_numpy(sb), pt, base_p=base_p)
    want, nd_ref = rops.lp_gather_abandon(jnp.asarray(q), jnp.asarray(ids), jnp.asarray(x),
                                          jnp.asarray(thr), jnp.asarray(sb), pj, base_p=base_p)
    np.testing.assert_array_equal(nd.numpy(), np.asarray(nd_ref))
    _close(got, want)
    assert nd.dtype == torch.int32
    assert int(nd[1].sum()) == 0                      # a frozen row scans nothing
    assert bool(torch.isinf(got[1]).all())


@pytest.mark.parametrize("d", [512, 96, 48, 40, 7])
def test_abandon_block_width_matches_reference(d):
    assert tops.pick_abandon_block_d(d) == rops.pick_abandon_block_d(d)


def test_wrappers_run_plain_versions_on_cpu_without_counting():
    q, x, ids, _ = _gather_case(seed=3)
    tq, tx, ti = map(torch.from_numpy, (q, x, ids))
    lp_distance.reset_launch_counts()
    np.testing.assert_array_equal(lp_distance.gather_lp(tq, ti, tx, 0.8).numpy(),
                                  gather_lp_ref(tq, ti, tx, 0.8).numpy())
    thr = torch.full((q.shape[0],), 1e9)
    sb = torch.zeros(ids.shape)
    got = lp_distance.gather_lp_abandon(tq, ti, tx, thr, sb, 0.8, 1.0, 32)
    want = gather_lp_abandon_ref(tq, ti, tx, thr, sb, 0.8, 1.0, 32)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(lp_distance.pairwise_lp(tq, tx, 1.25).numpy(),
                                  pairwise_lp_ref(tq, tx, 1.25).numpy())
    np.testing.assert_array_equal(lp_distance.gather_lp_multi(tq, ti, tx, (1.0, 2.0))[1].numpy(),
                                  gather_lp_ref(tq, ti, tx, 2.0).numpy())
    assert lp_distance.launch_counts() == {"pairwise_lp": 0, "rowwise_lp": 0, "gather_lp": 0,
                                           "gather_lp_multi": 0, "gather_lp_abandon": 0,
                                           "gather_lp_screen": 0, "lp_topk": 0}


def test_wrappers_refuse_other_devices():
    q = torch.zeros((2, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        lp_distance.gather_lp(q, torch.zeros((2, 3), dtype=torch.int32, device="meta"),
                              torch.zeros((5, 4), device="meta"), 1.0)


def test_kernel_sources_match_their_ctypes_signatures():
    """Each library's C launcher exists in its source with as many
    parameters as the ctypes binding declares (no nvcc here to check it)."""
    for name, (symbol, argtypes) in _build.LAUNCHERS.items():
        src = (_build.CSRC / f"{name}.cu").read_text()
        m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", src)
        assert m, f"{symbol} missing from {name}.cu"
        assert len(m.group(1).split(",")) == len(argtypes), symbol
        assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


@pytest.mark.parametrize("cols", [slice(10, 15), slice(0, 1), slice(0, 40)])
def test_row_strided_keeps_column_slices_and_copies_the_rest(cols):
    """A column slice of a wider (B, C) tensor goes to the gather kernels
    as it is, with its row stride; a tensor whose columns are not adjacent
    is copied."""
    wide = torch.arange(6 * 40, dtype=torch.int32).reshape(6, 40)
    view = wide[:, cols]
    got, stride = lp_distance._row_strided(view)
    assert got.data_ptr() == view.data_ptr() and stride == 40
    np.testing.assert_array_equal(got.numpy(), view.numpy())
    every_other = wide[:, ::2]
    got, stride = lp_distance._row_strided(every_other)
    assert got.is_contiguous() and stride == 20
    np.testing.assert_array_equal(got.numpy(), every_other.numpy())


def test_packed_launch_arguments_round_trip():
    """The gather_lp_abandon launcher takes its arguments as one int64 array
    (csrc/gather_lp_abandon.cu): pointers, strides and sizes come back as
    given, and each thread fills its own array."""
    import ctypes
    import threading

    args = [2**47 + 16, 300, 2**40, 3, 7, 1, 2**33, 0, 5, 6, 256, 5, 78_306, 512, 32, 1, 99]
    addr = lp_distance._packed(*args)
    got = list((ctypes.c_int64 * 17).from_address(addr))
    assert got == args
    other = []
    t = threading.Thread(target=lambda: other.append(lp_distance._packed(*range(17))))
    t.start()
    t.join()
    assert other[0] != addr
    assert list((ctypes.c_int64 * 17).from_address(addr)) == got


# ---------------------------------------------------------------------------
# the multi-p gather of the bulk build's shared pass (csrc/gather_lp_multi.cu)
# ---------------------------------------------------------------------------


def _multi_case(seed=4, b=7, c=70, n=120, d=24):
    """ids with many repeats (a small corpus), -1 and n padding, and an
    all-padding row."""
    q, x, _, rng = _gather_case(seed=seed, b=b, c=c, n=n, d=d)
    ids = rng.integers(0, n, size=(b, c)).astype(np.int32)
    ids[:, ::9] = -1
    ids[:, 4::11] = n
    ids[2, :] = ids[2, 0]              # one id in every slot
    ids[5, :] = np.where(np.arange(c) % 2 == 0, -1, n)
    return q, x, ids


@pytest.mark.parametrize("ps", [(1.0, 2.0), (2.0, 1.0), (0.5, 1.25), (1.5,), (0.8, 0.8)])
def test_gather_lp_multi_equals_per_p_plain_versions(ps):
    """Each plane equals gather_lp's plain version at its p, bit for bit,
    and the reference's gather within the module's tolerance."""
    q, x, ids = _multi_case()
    tq, tx, ti = map(torch.from_numpy, (q, x, ids))
    got = lp_distance.gather_lp_multi(tq, ti, tx, ps)
    assert got.shape == (len(ps), *ids.shape) and got.dtype == torch.float32
    for i, p in enumerate(ps):
        np.testing.assert_array_equal(got[i].numpy(), gather_lp_ref(tq, ti, tx, p).numpy())
        want = rops.lp_gather_distance(jnp.asarray(q), jnp.asarray(ids), jnp.asarray(x), p)
        _close(got[i], want, f"p={p}")
    assert np.isinf(got[:, 5].numpy()).all()


def test_gather_lp_multi_refuses_more_than_two_p():
    q, x, ids = _multi_case()
    with pytest.raises(ValueError, match="one or two p"):
        lp_distance.gather_lp_multi(*map(torch.from_numpy, (q, ids, x)), (1.0, 2.0, 0.5))


def _kernel_walk(q, ids, x, ps, slab_rows):
    """gather_lp_multi's kernel in plain torch, from the wrapper's plan: per
    row and slab, its span of sorted positions 32 at a time; a position
    heads a run when it starts the 32 or its id differs from the one
    before; each head is scored once and its value written to every slot
    of its run through perm. Returns (out (P, B, C), rows scored)."""
    n = x.shape[0]
    b, c = ids.shape
    sids, perm, off = lp_distance.gather_plan(ids, n, slab_rows)
    if off is None:
        off = torch.tensor([[0, c]] * b, dtype=torch.int32)
    slabs = off.shape[1] - 1
    out = torch.full((len(ps), b, c), torch.nan)
    scored = 0
    for r in range(b):
        for s in range(slabs):
            lo, hi = int(off[r, s]), int(off[r, s + 1])
            span = sids[r, lo:hi]
            valid = (span >= 0) & (span < n)
            if slabs > 1:       # each slab's span holds its own rows (padding at the ends)
                assert bool(((span[valid] >= s * slab_rows)
                             & (span[valid] < (s + 1) * slab_rows)).all())
                assert bool((span[~valid] < 0).all()) if s == 0 else True
                assert bool((span[~valid] >= n).all()) if s == slabs - 1 else True
                assert bool(valid.all()) if 0 < s < slabs - 1 else True
            for base in range(lo, hi, 32):
                pos = torch.arange(base, min(base + 32, hi))
                idv = sids[r, pos]
                head = torch.ones(len(pos), dtype=torch.bool)
                head[1:] = idv[1:] != idv[:-1]
                run = torch.cumsum(head.long(), 0) - 1
                hid = idv[head]
                vals = torch.stack([gather_lp_ref(q[r:r + 1], hid[None], x, p)[0] for p in ps])
                scored += int(((hid >= 0) & (hid < n)).sum())
                out[:, r, perm[r, pos]] = vals[:, run]
    return out, scored


@pytest.mark.parametrize("slab_rows", [0, 7, 40, 119, 500])
def test_gather_plan_returns_every_slot_in_the_callers_order(slab_rows):
    """The wrapper's sort and the kernel's walk, in plain torch: every slot
    gets its own id's value, in the caller's slot order, bit for bit; the
    slabs' spans cover each row; no distinct row is scored twice but where
    a run crosses a 32-position boundary."""
    q, x, ids = _multi_case(c=150)
    tq, tx, ti = map(torch.from_numpy, (q, x, ids))
    ps = (1.0, 2.0)
    got, scored = _kernel_walk(tq, ti, tx, ps, slab_rows)
    assert not bool(got.isnan().any())
    for i, p in enumerate(ps):
        np.testing.assert_array_equal(got[i].numpy(), gather_lp_ref(tq, ti, tx, p).numpy())
    n = x.shape[0]
    distinct = sum(len({int(v) for v in row if 0 <= v < n}) for row in ids)
    batches = sum(-(-int((row.size)) // 32) for row in ids) * (-(-n // slab_rows)
                                                                  if 0 < slab_rows < n else 1)
    assert distinct <= scored <= distinct + batches
    sids, perm, off = lp_distance.gather_plan(ti, n, slab_rows)
    assert sids.dtype == torch.int32 and perm.dtype == torch.int64
    np.testing.assert_array_equal(np.take_along_axis(ids, perm.numpy(), 1), sids.numpy())
    if off is not None:
        assert off.dtype == torch.int32 and bool((off[:, 0] == 0).all())
        assert bool((off[:, -1] == ids.shape[1]).all()) and bool((off.diff(1) >= 0).all())


def test_gather_lp_takes_int32_ids_and_per_row_p_on_cpu():
    """The query path's call: int32 or int64 ids, scalar or (B,) p, equal
    to the plain version either way."""
    q, x, ids, _ = _gather_case(seed=6)
    tq, tx = torch.from_numpy(q), torch.from_numpy(x)
    pv = torch.from_numpy(_p_rows(q.shape[0]))
    for ti in (torch.from_numpy(ids), torch.from_numpy(ids).long()):
        for p in (0.8, pv):
            np.testing.assert_array_equal(lp_distance.gather_lp(tq, ti, tx, p).numpy(),
                                          gather_lp_ref(tq, ti, tx, p).numpy())
