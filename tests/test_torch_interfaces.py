"""The port's public interfaces against `repro`'s: fields, parameter lists
and the names that callers of the reference import.

A positional call must mean the same call in both packages. The reference
takes `interpret` (its Pallas dispatch override) at fixed places; the port
takes it there too and ignores it, since its wrappers dispatch on the
tensor's device. Parameters the port adds (`device`) are keyword-only and
come last. The cost model and the band's footprint must give the
reference's numbers exactly. Inputs are made with numpy from a seed;
tensors stay on the CPU, where the kernels' plain versions run.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

from repro.core import bulk_build as rbulk
from repro.core import metrics as rmetrics
from repro.core import uhnsw as ruhnsw
from repro.index.compressed import build_band as r_build_band
from repro.index.delta import DeltaBuffer as RDeltaBuffer
from repro.kernels import ops as rops
from repro_torch.core import bulk_build as tbulk
from repro_torch.core import metrics as tmetrics
from repro_torch.core import uhnsw as tuhnsw
from repro_torch.index.compressed import build_band as t_build_band
from repro_torch.index.delta import DeltaBuffer
from repro_torch.kernels import ops as tops
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

P_GRID = [0.5, 0.8, 1.0, 1.25, 1.5, 2.0]

# (label, reference function, port function)
SIGNATURES = [
    ("DeltaBuffer.search", RDeltaBuffer.search, DeltaBuffer.search),
    ("verify_candidates", ruhnsw.verify_candidates, tuhnsw.verify_candidates),
    ("lp_gather_distance", rops.lp_gather_distance, tops.lp_gather_distance),
    ("lp_gather_abandon", rops.lp_gather_abandon, tops.lp_gather_abandon),
    ("lp_gather_screen", rops.lp_gather_screen, tops.lp_gather_screen),
    ("lp_pairwise_distance", rops.lp_pairwise_distance, tops.lp_pairwise_distance),
    ("nn_descent_pools", rbulk.nn_descent_pools, tbulk.nn_descent_pools),
    ("lp_op_cost_per_element", rmetrics.lp_op_cost_per_element,
     tmetrics.lp_op_cost_per_element),
    ("lp_distance_cost_model", rmetrics.lp_distance_cost_model,
     tmetrics.lp_distance_cost_model),
    ("transcendental_op_count", rmetrics.transcendental_op_count,
     tmetrics.transcendental_op_count),
]


def _params(fn):
    return [(p.name, p.kind) for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("label,ref_fn,port_fn", SIGNATURES, ids=[s[0] for s in SIGNATURES])
def test_parameter_lists_match_reference(label, ref_fn, port_fn):
    """The reference's parameters, in its order and of its kinds, open the
    port's list; what the port adds is keyword-only."""
    want, got = _params(ref_fn), _params(port_fn)
    assert got[:len(want)] == want, label
    assert all(kind == inspect.Parameter.KEYWORD_ONLY for _, kind in got[len(want):]), label


def test_uhnsw_params_fields_match_reference():
    want = [(f.name, f.default) for f in dataclasses.fields(ruhnsw.UHNSWParams)]
    got = [(f.name, f.default) for f in dataclasses.fields(tuhnsw.UHNSWParams)]
    assert got == want
    # the 8th positional field is interpret: abandon keeps its default
    args = (300, 0.92, None, 1.4, None, 1000, 1, None)
    assert ruhnsw.UHNSWParams(*args).abandon is True
    assert tuhnsw.UHNSWParams(*args).abandon is True
    assert tuhnsw.UHNSWParams(interpret=False).interpret is False


def _delta_case(seed: int = 0, n: int = 40, b: int = 6, d: int = 32):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((b, d)).astype(np.float32)
    return vecs, Q


@pytest.mark.parametrize("p", [0.5, 1.25])
def test_delta_search_positional_interpret(p):
    """search(Q, p, None, thr) is the keyword call search(Q, p, thresh=thr),
    and both give the reference's ids, scanned dims and distances."""
    vecs, Q = _delta_case()
    port, ref = DeltaBuffer(Q.shape[1], 64), RDeltaBuffer(Q.shape[1], 64)
    for i, v in enumerate(vecs):
        port.add(v, 1000 + i)
        ref.add(v, 1000 + i)
    full = port.search(torch.from_numpy(Q), p)[1]
    thr = torch.sort(full, dim=1).values[:, 4].contiguous()
    pos = port.search(torch.from_numpy(Q), p, None, thr)
    kw = port.search(torch.from_numpy(Q), p, thresh=thr)
    want = ref.search(Q, p, None, thr.numpy())
    for a, b in zip(pos, kw):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(pos[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(pos[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(pos[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-6)
    assert np.isinf(pos[1].numpy()).any() and np.isfinite(pos[1].numpy()).any()


def test_ops_dispatchers_positional_interpret():
    """Each dispatcher called with the reference's positional list (interpret
    and the tile sizes as None) equals the keyword call."""
    rng = np.random.default_rng(1)
    b, c, n, d = 5, 7, 50, 32
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(-1, n + 1, (b, c)).astype(np.int32))
    sb = torch.zeros((b, c))
    thr = tops.lp_gather_distance(q, ids.clamp(0, n - 1), x, 0.8).median(1).values
    np.testing.assert_array_equal(
        tops.lp_gather_distance(q, ids, x, 0.8, True, None, None, None).numpy(),
        tops.lp_gather_distance(q, ids, x, 0.8, root=True).numpy())
    np.testing.assert_array_equal(
        tops.lp_pairwise_distance(q, x, 1.5, False, None).numpy(),
        tops.lp_pairwise_distance(q, x, 1.5).numpy())
    pos = tops.lp_gather_abandon(q, ids, x, thr, sb, 0.8, 1.0, False, None, None, None, 8)
    kw = tops.lp_gather_abandon(q, ids, x, thr, sb, 0.8, base_p=1.0, block_d=8)
    for a, w in zip(pos, kw):
        np.testing.assert_array_equal(a.numpy(), w.numpy())
    assert {int(v) for v in kw[1].unique()} - {0, d}, "block_d = 8 must scan partial rows"
    band = t_build_band(x.numpy(), device="cpu")
    qp = q[:, band.perm].contiguous()
    pos = tops.lp_gather_screen(qp, ids, band.codes, band.scale, band.radius, thr * 0.5, sb, 0.8,
                                1.0, None, None, None, 8)
    kw = tops.lp_gather_screen(qp, ids, band.codes, band.scale, band.radius, thr * 0.5, sb, 0.8,
                               base_p=1.0, block_d=8)
    for a, w in zip(pos, kw):
        np.testing.assert_array_equal(a.numpy(), w.numpy())


def test_verify_candidates_positional_interpret():
    rng = np.random.default_rng(2)
    b, t, n, d, k = 4, 40, 200, 32, 6
    Q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    X = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    ids = torch.from_numpy(np.stack([rng.permutation(n)[:t] for _ in range(b)]).astype(np.int32))
    pos = tuhnsw.verify_candidates(Q, ids, X, 0.8, k, 3, 0.92, None)
    kw = tuhnsw.verify_candidates(Q, ids, X, 0.8, k, 3, 0.92)
    for a, w in zip(pos, kw):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(w))


def test_nn_descent_pools_positional_and_trajectory():
    """interpret and trajectory at the reference's places: the trajectory is
    one snapshot after the seed and one per round, the last the pools'
    ids, as the reference returns it; the final pools agree with the
    reference's as tests/test_torch_bulk_build.py holds them."""
    x = np.random.default_rng(3).standard_normal((300, 16)).astype(np.float32)
    got, snaps = tbulk.nn_descent_pools(x, (1.0, 2.0), 16, 2, 8, None, 5, None, True, 100,
                                        device="cpu")
    want, want_snaps = rbulk.nn_descent_pools(x, (1.0, 2.0), 16, 2, 8, None, 5, None, True, 100)
    assert len(snaps) == len(want_snaps) == 3
    for p in (1.0, 2.0):
        np.testing.assert_array_equal(snaps[-1][p].numpy(), got[p][0].numpy())
        assert float(np.mean(got[p][0].numpy() == want[p][0])) >= 0.99
    plain = tbulk.nn_descent_pools(x, (1.0, 2.0), 16, 2, 8, None, 5, exact_seed_threshold=100,
                                   device="cpu")
    for p in (1.0, 2.0):
        np.testing.assert_array_equal(plain[p][0].numpy(), got[p][0].numpy())
    exact, exact_snaps = tbulk.nn_descent_pools(x, (1.0,), 8, trajectory=True, device="cpu")
    assert len(exact_snaps) == 1
    np.testing.assert_array_equal(exact_snaps[0][1.0].numpy(), exact[1.0][0].numpy())


def test_band_nbytes_matches_reference():
    x = np.random.default_rng(4).standard_normal((123, 40)).astype(np.float32)
    assert t_build_band(x, device="cpu").nbytes() == r_build_band(x).nbytes() == 123 * 40 + 12 * 40


@pytest.mark.parametrize("p", P_GRID + [0.7, 1.9])
def test_cost_model_matches_reference(p):
    assert tmetrics.BASIC_PS == rmetrics.BASIC_PS
    assert tmetrics.SQRT_PS == rmetrics.SQRT_PS
    for d in (1, 96, 512):
        assert tmetrics.transcendental_op_count(p, d) == rmetrics.transcendental_op_count(p, d)
        for use_mxu in (True, False):
            assert (tmetrics.lp_op_cost_per_element(p, use_mxu)
                    == rmetrics.lp_op_cost_per_element(p, use_mxu))
            assert (tmetrics.lp_distance_cost_model(p, d, use_mxu=use_mxu)
                    == rmetrics.lp_distance_cost_model(p, d, use_mxu=use_mxu))
        assert tmetrics.lp_distance_cost_model(p, d) == rmetrics.lp_distance_cost_model(p, d)
