"""The port's rowwise and fused top-k kernels' wrappers against `repro`.

`lp_rowwise_distance` (kernel `csrc/rowwise_lp.cu`) is held against
`repro.kernels.pallas_rowwise_lp`, and `lp_topk` (`csrc/lp_topk.cu`)
against `repro.kernels.lp_topk.pallas_lp_topk`, both Pallas kernels in
interpret mode on the CPU, on the reference tests' shapes and p grids. On
CPU tensors the wrappers run their plain versions (`kernels.ref`); the
kernels themselves run only on the card (`chip_smoke.py`).

Tolerances: relative 3e-5, as the reference's own kernel tests allow. At
p = 2 the Pallas rowwise kernel takes the product identity |q|^2 + |c|^2 -
2 q.c while the port sums the squared differences, so there the bound
covers the identity's cancellation error too. Top-k ids are equal except
where two candidates tie at the k-th distance (within 1e-5): sums taken in
another order may order such a pair either way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import pallas_rowwise_lp
from repro.kernels.lp_topk import pallas_lp_topk, ref_lp_topk
from repro_torch.kernels import lp_distance
from repro_torch.kernels import lp_topk as lp_topk_mod
from repro_torch.kernels.lp_topk import lp_topk
from repro_torch.kernels.ops import lp_rowwise_distance
from repro_torch.kernels.ref import lp_topk_ref, rowwise_lp_ref
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

P_GRID = [0.5, 0.8, 1.0, 1.3, 1.5, 2.0]
SHAPES_RW = [(1, 1, 8), (5, 33, 64), (16, 300, 128), (8, 257, 960)]
TOPK_CASES = [(1, 64, 16, 5), (4, 300, 128, 50), (3, 257, 96, 10), (2, 1000, 64, 25)]
REL = 3e-5


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / (np.abs(want) + 1e-5)))


def _rowwise_case(b, c, d, seed):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, d)) * 3).astype(np.float32)
    cands = (rng.standard_normal((b, c, d)) * 3).astype(np.float32)
    return q, cands


@pytest.mark.parametrize("p", P_GRID)
@pytest.mark.parametrize("shape", SHAPES_RW)
def test_rowwise_matches_pallas_rowwise(p, shape):
    q, cands = _rowwise_case(*shape, seed=shape[0] * 17 + shape[1])
    want = np.asarray(pallas_rowwise_lp(jnp.asarray(q), jnp.asarray(cands), p, interpret=True))
    got = lp_rowwise_distance(torch.from_numpy(q), torch.from_numpy(cands), p)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel_err(got.numpy(), want) < REL


@pytest.mark.parametrize("root", [True, False])
@pytest.mark.parametrize("shape", [(8, 33, 64), (6, 257, 96)])
def test_rowwise_per_row_p_matches_pallas_and_scalar_rows(shape, root):
    q, cands = _rowwise_case(*shape, seed=shape[1])
    pv = np.resize(np.array(P_GRID, np.float32), shape[0])
    want = np.asarray(pallas_rowwise_lp(jnp.asarray(q), jnp.asarray(cands), jnp.asarray(pv),
                                        root=root, interpret=True))
    got = lp_rowwise_distance(torch.from_numpy(q), torch.from_numpy(cands),
                              torch.from_numpy(pv), root=root)
    assert _rel_err(got.numpy(), want) < REL
    # each row equals the scalar call at its p, bit for bit; (1,) broadcasts
    for p in np.unique(pv):
        rows = np.flatnonzero(pv == p)
        scalar = lp_rowwise_distance(torch.from_numpy(q), torch.from_numpy(cands), float(p),
                                     root=root)
        np.testing.assert_array_equal(got[rows].numpy(), scalar[rows].numpy())
    one = lp_rowwise_distance(torch.from_numpy(q), torch.from_numpy(cands),
                              torch.tensor([1.3]), root=root)
    np.testing.assert_array_equal(one.numpy(), lp_rowwise_distance(
        torch.from_numpy(q), torch.from_numpy(cands), 1.3, root=root).numpy())


@pytest.mark.parametrize("p", [0.5, 0.8, 1.0, 1.25, 1.5, 2.0])
def test_rowwise_wrapper_rows_equal_under_scalar_and_row_p(p):
    """The wrapper scores a (B,) p of one value as the scalar p: the kernel
    takes the scalar as an argument and the vector through a pointer, and
    picks each row's p family from its own p."""
    q, cands = _rowwise_case(5, 17, 48, seed=9)
    tq, tc = torch.from_numpy(q), torch.from_numpy(cands)
    scalar = lp_distance.rowwise_lp(tq, tc, p)
    rows = lp_distance.rowwise_lp(tq, tc, torch.full((5,), p))
    assert scalar.dtype == torch.float32 and scalar.shape == (5, 17)
    np.testing.assert_array_equal(scalar.numpy(), rows.numpy())


def _assert_topk_matches(got_d, got_i, want_d, want_i, all_d, k):
    """dists within REL; ids equal, or a tie at the k-th distance."""
    got_d, got_i = np.asarray(got_d), np.asarray(got_i)
    np.testing.assert_allclose(got_d, np.asarray(want_d), rtol=REL, atol=1e-5)
    for row in range(got_i.shape[0]):
        if set(got_i[row]) != set(np.asarray(want_i)[row]):
            kth = np.sort(all_d[row])[k - 1]
            assert np.isclose(kth, got_d[row, -1], rtol=1e-5), f"row {row}"


@pytest.mark.parametrize("p", [0.5, 1.0, 1.3, 2.0])
@pytest.mark.parametrize("case", TOPK_CASES)
def test_lp_topk_matches_pallas_lp_topk(p, case):
    b, c, d, k = case
    kq, kc = jax.random.split(jax.random.PRNGKey(b * 7 + c))
    q = np.array(jax.random.normal(kq, (b, d), dtype=jnp.float32))
    cands = np.array(jax.random.normal(kc, (b, c, d), dtype=jnp.float32))
    want_d, want_i = pallas_lp_topk(jnp.asarray(q), jnp.asarray(cands), p, k)
    got_d, got_i = lp_topk(torch.from_numpy(q), torch.from_numpy(cands), p, k)
    assert got_d.shape == (b, k) and got_i.dtype == torch.int32
    all_d = lp_rowwise_distance(torch.from_numpy(q), torch.from_numpy(cands), p).numpy()
    _assert_topk_matches(got_d, got_i, want_d, want_i, all_d, k)


def test_lp_topk_sorted_valid_and_root_free():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((5, 32)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((5, 200, 32)).astype(np.float32))
    d, i = lp_topk(q, c, 1.3, 20)
    assert (np.diff(d.numpy(), axis=1) >= 0).all()
    assert ((i >= 0) & (i < 200)).all()
    d_r, i_r = lp_topk(q[:2, :24], c[:2, :100, :24].contiguous(), 0.7, 8, root=True)
    d_n, i_n = lp_topk(q[:2, :24], c[:2, :100, :24].contiguous(), 0.7, 8, root=False)
    np.testing.assert_array_equal(i_r.numpy(), i_n.numpy())
    np.testing.assert_allclose(d_r.numpy(), d_n.numpy() ** (1 / 0.7), rtol=1e-4)
    want_d, want_i = pallas_lp_topk(jnp.asarray(q[:2, :24].numpy()),
                                    jnp.asarray(c[:2, :100, :24].numpy()), 0.7, 8, root=False)
    np.testing.assert_allclose(d_n.numpy(), np.asarray(want_d), rtol=REL)
    np.testing.assert_array_equal(i_n.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("p", [0.5, 1.3, 2.0])
def test_lp_topk_ties_go_to_the_lower_index(p):
    """Every candidate row appears twice, the copy at a later index: each
    returned id must be the lower of its pair, as the reference's stable
    sort gives, and the copy follows the original where both are kept."""
    rng = np.random.default_rng(3)
    b, half, d, k = 4, 60, 48, 31
    base = rng.standard_normal((b, half, d)).astype(np.float32)
    perm = rng.permutation(2 * half)
    cands = np.concatenate([base, base], axis=1)[:, perm]       # copies at scattered indices
    q = rng.standard_normal((b, d)).astype(np.float32)
    got_d, got_i = lp_topk(torch.from_numpy(q), torch.from_numpy(cands), p, k)
    want_d, want_i = pallas_lp_topk(jnp.asarray(q), jnp.asarray(cands), p, k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=REL)
    twin = {int(j): int(np.flatnonzero(perm % half == perm[j] % half).min())
            for j in range(2 * half)}
    gi = got_i.numpy()
    for row in range(b):
        for slot in range(0, k - 1, 2):       # pairs come adjacent: original, copy
            assert gi[row, slot] == twin[gi[row, slot]], (row, slot)
            assert twin[gi[row, slot + 1]] == gi[row, slot]


def test_lp_topk_limits_and_plain_version_without_counting():
    q = torch.zeros((2, 8))
    c = torch.zeros((2, 100, 8))
    with pytest.raises(ValueError, match="C = 100"):
        lp_topk(q, c, 1.0, 101)
    with pytest.raises(ValueError, match="C = 100"):
        lp_topk(q, c, 1.0, 0)
    with pytest.raises(ValueError, match="C = 3"):
        lp_topk(q, c[:, :3], 1.0, 4)
    with pytest.raises(ValueError, match="one scalar p"):
        lp_topk(q, c, torch.tensor([1.0, 2.0]), 4)
    lp_distance.reset_launch_counts()
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((3, 16)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((3, 70, 16)).astype(np.float32))
    for got, want in zip(lp_topk(q, c, 0.8, 7), lp_topk_ref(q, c, 0.8, 7)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(lp_distance.rowwise_lp(q, c, 0.8).numpy(),
                                  rowwise_lp_ref(q, c, 0.8).numpy())
    counts = lp_distance.launch_counts()
    assert counts["lp_topk"] == 0 and counts["rowwise_lp"] == 0


@pytest.mark.parametrize("p", [0.5, 1.3, 2.0])
@pytest.mark.parametrize("k", [65, 100, 300])
def test_lp_topk_takes_any_k_up_to_c(k, p):
    """k above the 64 that the port once capped, up to k = C = 300: ids and
    dists against the reference's plain `ref_lp_topk` and its Pallas kernel
    in interpret mode; the port's own `ref_lp_topk` is its plain version."""
    rng = np.random.default_rng(k)
    b, c, d = 3, 300, 64
    q = rng.standard_normal((b, d)).astype(np.float32)
    cands = rng.standard_normal((b, c, d)).astype(np.float32)
    got_d, got_i = lp_topk(torch.from_numpy(q), torch.from_numpy(cands), p, k)
    assert got_d.shape == (b, k) and got_i.shape == (b, k)
    all_d = lp_rowwise_distance(torch.from_numpy(q), torch.from_numpy(cands), p).numpy()
    for want_d, want_i in (ref_lp_topk(jnp.asarray(q), jnp.asarray(cands), p, k),
                           pallas_lp_topk(jnp.asarray(q), jnp.asarray(cands), p, k,
                                          interpret=True)):
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=REL, atol=1e-5)
    np.testing.assert_array_equal(np.sort(got_i.numpy()[:, :k], 1),
                                  np.sort(np.argsort(all_d, 1, kind="stable")[:, :k], 1))
    port_d, port_i = lp_topk_mod.ref_lp_topk(torch.from_numpy(q), torch.from_numpy(cands), p, k)
    np.testing.assert_array_equal(port_i.numpy(), got_i.numpy())
    np.testing.assert_array_equal(port_d.numpy(), got_d.numpy())


def test_lp_topk_shared_memory_grows_with_k():
    """The kernel's running list is sized by k: at C = 300 every k fits in a
    block's shared memory beside the ring of candidate rows, two blocks to
    an SM (228 KB, 1 KB of it reserved per block), and the wrapper's limit
    is the H100's opt-in."""
    assert 2 * (lp_topk_mod.smem_bytes(512, 300) + 1024) <= 228 * 1024
    assert lp_topk_mod.smem_bytes(512, 65) > lp_topk_mod.smem_bytes(512, 64)
    assert lp_topk_mod.smem_bytes(512, 20_000) > lp_topk_mod.SMEM_OPTIN_BYTES


# ---------------------------------------------------------------------------
# the kernel's plan (csrc/lp_topk.cu), as a plain model: one block a query,
# its warp w takes the candidates w, w + W, ...; a warp filters each scored
# row against its own running k-th entry into a pending buffer, merges the
# buffer when it is full and after its last row; then every warp list of the
# block is placed among all the others by binary searches (global positions
# throughout)
# ---------------------------------------------------------------------------


def _plan_key(d: float, pos: int, c: int):
    """The kernel's strict order: empty slots (position >= C) last, NaN after
    every number, then distance, then position."""
    empty, nan = pos >= c, bool(np.isnan(d))
    return (empty, nan, 0.0 if nan else d, pos)


def _count_before(lst, e, c):
    """The kernel's binary search: entries of the sorted list before e."""
    lo, hi = 0, len(lst)
    while lo < hi:
        mid = (lo + hi) // 2
        if _plan_key(*lst[mid], c) < _plan_key(*e, c):
            lo = mid + 1
        else:
            hi = mid
    return lo


def _merge_pending(lst, pend, c):
    """The kernel's merge: running entry i goes to i + the pending entries
    before it; a pending entry to the running entries before it (binary
    search) + the pending entries before it; places below k are kept."""
    k = len(lst)
    places = {}
    for i, e in enumerate(lst):
        places[i + sum(_plan_key(*f, c) < _plan_key(*e, c) for f in pend)] = e
    for e in pend:
        place = _count_before(lst, e, c) + sum(_plan_key(*f, c) < _plan_key(*e, c) for f in pend)
        assert place not in places          # a strict order: the places are a permutation
        places[place] = e
    assert sorted(places) == list(range(k + len(pend)))
    return [places[i] for i in range(k)]


def _topk_plan_model(dist: np.ndarray, k: int, warps: int, pending: int):
    """One query's top-k as the kernel computes it from its root-free
    distances: (dists (k,), ids (k,)), and the number of merges."""
    c = dist.shape[0]
    lists, merges = [], 0
    for w in range(warps):
        lst = [(np.inf, c + w * k + i) for i in range(k)]
        pend = []
        mine = list(range(w, c, warps))
        for t, pos in enumerate(mine):
            e = (float(dist[pos]), pos)
            if _plan_key(*e, c) < _plan_key(*lst[k - 1], c):
                pend.append(e)
            if len(pend) == pending or (pend and t == len(mine) - 1):
                lst = _merge_pending(lst, pend, c)
                pend, merges = [], merges + 1
        lists.append(lst)
    out = [None] * k
    for li, lst in enumerate(lists):
        for i, e in enumerate(lst):
            place = i + sum(_count_before(other, e, c)
                            for lj, other in enumerate(lists) if lj != li)
            if place < k:
                assert out[place] is None and e[1] < c
                out[place] = e
    assert all(e is not None for e in out)
    return (np.array([e[0] for e in out], np.float32), np.array([e[1] for e in out], np.int32),
            merges)


def _plan_case(name: str):
    """(q, c, p, k) with ties, NaN and +inf among the candidates where asked."""
    rng = np.random.default_rng(len(name))
    b, c, d = 3, 75, 16
    q = rng.standard_normal((b, d)).astype(np.float32)
    cands = rng.standard_normal((b, c, d)).astype(np.float32)
    k = 10
    if name == "ties":
        cands[:, 40:] = cands[:, 5:40]             # copies at later positions
    elif name == "nan_inf":
        cands[0, [3, 17, 50]] = np.nan             # NaN rows sort last
        cands[1, [0, 60]] = np.inf                 # +inf distances, before NaN
        cands[2, ::7] = np.nan
        k = 74                                     # deep enough to reach them
    elif name == "k_eq_c":
        k = c
    elif name == "ragged":
        cands = cands[:, :37]                      # C not a multiple of the warps
    return q, cands, 1.3 if name != "ties" else 1.0, k


@pytest.mark.parametrize("warps", [1, 2, 3, 4])
@pytest.mark.parametrize("case", ["plain", "ties", "nan_inf", "k_eq_c", "ragged"])
def test_lp_topk_plan_model_equals_plain_version(case, warps):
    """The plan of the streaming kernel gives the plain version's ids and
    distances bit for bit, for 1 to 4 warp lists merged at the end, with a
    small pending buffer so that every rule runs (several merges, the
    filter against a full list, lists that stay partly empty)."""
    q, cands, p, k = _plan_case(case)
    tq, tc = torch.from_numpy(q), torch.from_numpy(cands)
    dist = rowwise_lp_ref(tq, tc, p).numpy()
    want_d, want_i = lp_topk_ref(tq, tc, p, k, root=False)
    merges = 0
    for row in range(q.shape[0]):
        got_d, got_i, m = _topk_plan_model(dist[row], k, warps, pending=3)
        merges += m
        np.testing.assert_array_equal(got_i, want_i[row].numpy())
        np.testing.assert_array_equal(got_d, want_d[row].numpy())
    assert merges >= q.shape[0] * warps


def test_lp_topk_plan_at_the_kernels_sizes():
    """The kernel's own sizes at d = 512: 8 warps a block, 32 pending a
    warp, C = 300 over the block's warps, at k = 10 and k = C; and the
    shared memory the wrapper checks against, rings included up to d =
    1,024 only."""
    rng = np.random.default_rng(7)
    dist = rng.standard_normal(300).astype(np.float32) ** 2
    dist[100:110] = dist[0]                        # ties across the warps' rows
    for k in (10, 300):
        order = np.argsort(dist, kind="stable")[:k]
        got_d, got_i, _ = _topk_plan_model(dist, k, lp_topk_mod.WARPS, lp_topk_mod.PENDING)
        np.testing.assert_array_equal(got_i, order)
        np.testing.assert_array_equal(got_d, dist[order])
    w, st = lp_topk_mod.WARPS, lp_topk_mod.STAGES
    assert lp_topk_mod.smem_bytes(512, 10) == 4 * 512 * (1 + w * st) + 8 * w * (20 + 32)
    assert lp_topk_mod.smem_bytes(2048, 10) == 4 * 2048 + 8 * w * (20 + 32)
