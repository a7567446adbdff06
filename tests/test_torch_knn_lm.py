"""The port's kNN-LM against `repro.retrieval.knn_lm`.

The datastore index comes from the reference's builder and is carried
across with `repro_torch.convert.graph_from_reference`, so the comparison
does not depend on build parity. Tolerances: the neighbour ids are equal;
given the same neighbours and distances the float64 weights, the
vocabulary scatter and the mix agree within 1e-9; end to end the f32
distances agree within rtol 1e-5 (the two frameworks sum in other orders),
so the log-probs within 1e-5 * d_max / T. The last two tests mirror
`tests/test_retrieval.py:44-75` on the port's own build.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.retrieval.knn_lm import KnnLM as RKnnLM
from repro_torch.convert import graph_from_reference
from repro_torch.core.uhnsw import UHNSW
from repro_torch.retrieval.knn_lm import KnnLM
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

N, D, V = 1200, 24, 50
P_VALUES = (0.6, 1.0, 1.6, 2.0)


def to_port(g):
    return graph_from_reference(g.adjacency, g.level_nodes, g.local_index, g.entry_point,
                                g.max_level, g.levels, g.data, g.metric_p, g.m, g.m0,
                                device="cpu")


@pytest.fixture(scope="module")
def stores():
    rng = np.random.default_rng(11)
    hidden = rng.standard_normal((N, D)).astype(np.float32) * 2
    next_tokens = rng.integers(0, V, size=N).astype(np.int32)
    ref = RKnnLM.build_from_hidden(hidden, next_tokens, vocab_size=V, m=8, k=4,
                                   temperature=10.0, lam=0.4)
    port = KnnLM(UHNSW(to_port(ref.index.g1), to_port(ref.index.g2)),
                 torch.from_numpy(next_tokens).long(), V, lam=0.4, temperature=10.0, k=4)
    q = hidden[:32] + 0.05 * rng.standard_normal((32, D)).astype(np.float32)
    return ref, port, q, rng


@pytest.mark.parametrize("p", P_VALUES)
def test_knn_logprobs_and_mix_match_reference(stores, p):
    ref, port, q, _ = stores
    r_ids, r_d, _ = ref.index.search(jnp.asarray(q), p, ref.k)
    ids, dists, _ = port.index.search(torch.from_numpy(q), p, port.k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(r_ids))
    np.testing.assert_allclose(dists.numpy(), np.asarray(r_d), rtol=1e-5, atol=1e-6)
    tol = 1e-5 * float(np.asarray(r_d).max()) / ref.temperature + 1e-9
    got = port.knn_logprobs(torch.from_numpy(q), p)
    assert got.dtype == torch.float64 and got.shape == (len(q), V)
    np.testing.assert_allclose(got.numpy(), ref.knn_logprobs(q, p), rtol=0, atol=tol)
    lm = np.log(np.random.default_rng(1).dirichlet(np.ones(V), size=len(q)))
    np.testing.assert_allclose(port.mix(lm, torch.from_numpy(q), p).numpy(), ref.mix(lm, q, p),
                               rtol=0, atol=tol)


def test_weights_and_scatter_match_reference_on_the_same_neighbours(stores):
    """Same ids and dists into both packages' weighting: within 1e-9,
    duplicate next tokens summed, underflowed weights at the 1e-30 floor."""
    ref, port, q, rng = stores
    ids = rng.integers(0, N, size=(len(q), ref.k))
    dists = rng.uniform(0.0, 400.0, size=(len(q), ref.k)).astype(np.float32)
    dists[:4] += 900.0        # exp(-d / T) underflows the normaliser's floor
    fixed = SimpleNamespace(search=lambda h, p, k: (ids, dists, None))
    r = RKnnLM(fixed, ref.values, V, lam=0.4, temperature=10.0, k=ref.k)
    fixed_t = SimpleNamespace(
        search=lambda h, p, k: (torch.from_numpy(ids), torch.from_numpy(dists), None),
        X=torch.zeros(1))
    t = KnnLM(fixed_t, port.values, V, lam=0.4, temperature=10.0, k=port.k)
    np.testing.assert_allclose(t.knn_logprobs(q, 1.0).numpy(), r.knn_logprobs(q, 1.0),
                               rtol=0, atol=1e-9)
    lm = np.full((len(q), V), -np.log(V))
    np.testing.assert_allclose(t.mix(lm, q, 1.0).numpy(), r.mix(lm, q, 1.0), rtol=0, atol=1e-9)


def test_knn_lm_recalls_memorized_continuations():
    """Querying with a stored hidden state puts the most probability on the
    memorized token, for any p."""
    rng = np.random.default_rng(0)
    n, d, v = 1200, 24, 50
    hidden = rng.standard_normal((n, d)).astype(np.float32) * 2
    next_tokens = rng.integers(0, v, size=n).astype(np.int32)
    knn = KnnLM.build_from_hidden(hidden, next_tokens, vocab_size=v, m=8, device="cpu",
                                  k=4, temperature=10.0)
    q = hidden[:16] + 0.01 * rng.standard_normal((16, d)).astype(np.float32)
    for p in (0.6, 1.0, 1.6):
        pred = knn.knn_logprobs(q, p).argmax(dim=1).numpy()
        acc = (pred == next_tokens[:16]).mean()
        assert acc > 0.85, f"p={p}: acc {acc}"


def test_knn_lm_mixing_lowers_nll():
    rng = np.random.default_rng(0)
    n, d, v = 800, 16, 32
    hidden = rng.standard_normal((n, d)).astype(np.float32)
    next_tokens = rng.integers(0, v, size=n).astype(np.int32)
    knn = KnnLM.build_from_hidden(hidden, next_tokens, vocab_size=v, m=8, device="cpu",
                                  k=4, lam=0.5, temperature=10.0)
    gold = torch.from_numpy(next_tokens[:32]).long()
    lm_logprobs = np.full((32, v), -np.log(v))   # a deliberately uninformative LM
    mixed = knn.mix(lm_logprobs, hidden[:32], p=0.8)
    nll_lm = -lm_logprobs[np.arange(32), gold.numpy()].mean()
    nll_mixed = -mixed[torch.arange(32), gold].mean().item()
    assert nll_mixed < nll_lm - 0.5
