"""The port's synthetic token pipeline against `repro.data.pipeline`.

Both packages draw the same numpy stream, so tokens, labels and the stub
frontends' frames must be equal bit for bit (frames compared as bf16 bit
patterns); the rest mirrors `tests/test_data_pipeline.py` on the port.
"""

import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as r_get_arch
from repro.data.pipeline import SyntheticTokenPipeline as RPipeline
from repro.data.pipeline import make_batch_iterator as r_make_batch_iterator
from repro_torch.configs.base import get_arch
from repro_torch.data.pipeline import SyntheticTokenPipeline, make_batch_iterator
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def pipe(cfg, *args, **kw):
    return SyntheticTokenPipeline(cfg, *args, device="cpu", **kw)


@pytest.fixture(scope="module")
def cfg():
    return get_arch("tinyllama_1_1b", smoke=True)


def bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("arch,batch,seq,seed,step,host", [
    ("tinyllama_1_1b", 4, 32, 3, 7, (0, 1)),
    ("tinyllama_1_1b", 8, 16, 0, 0, (1, 2)),
    ("musicgen_large", 2, 16, 0, 1, (0, 1)),
    ("llava_next_34b", 4, 8, 5, 2, (1, 2)),
])
def test_batches_equal_reference_bit_for_bit(arch, batch, seq, seed, step, host):
    ours = pipe(get_arch(arch, smoke=True), batch, seq, seed, host_index=host[0],
                host_count=host[1]).batch(step)
    theirs = RPipeline(r_get_arch(arch, smoke=True), batch, seq, seed, host_index=host[0],
                       host_count=host[1]).batch(step)
    assert ours.keys() == theirs.keys()
    for key in ours:
        assert ours[key].device.type == "cpu"
        assert str(ours[key].dtype).replace("torch.", "") == str(theirs[key].dtype)
        np.testing.assert_array_equal(bits(ours[key]), bits(theirs[key]))


@pytest.mark.parametrize("start_step", [0, 3])
def test_batch_iterator_equals_reference(start_step):
    """make_batch_iterator from start_step: the same steps and batches as the
    reference's (one process: host 0 of 1 on both sides)."""
    ours = make_batch_iterator(get_arch("tinyllama_1_1b", smoke=True), 4, 16, seed=2,
                               start_step=start_step, device="cpu")
    theirs = r_make_batch_iterator(r_get_arch("tinyllama_1_1b", smoke=True), 4, 16, seed=2,
                                   start_step=start_step)
    for _ in range(3):
        (step, batch), (r_step, r_batch) = next(ours), next(theirs)
        assert step == r_step
        assert batch.keys() == r_batch.keys()
        for key in batch:
            assert batch[key].device.type == "cpu"
            np.testing.assert_array_equal(bits(batch[key]), bits(r_batch[key]))
    assert step == start_step + 2


def test_deterministic_per_step(cfg):
    a = pipe(cfg, 4, 32, seed=3).batch(7)
    b = pipe(cfg, 4, 32, seed=3).batch(7)
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["labels"], b["labels"])


def test_steps_differ(cfg):
    p = pipe(cfg, 4, 32, seed=3)
    assert not torch.equal(p.batch(0)["tokens"], p.batch(1)["tokens"])


def test_host_shards_differ_and_split(cfg):
    h0 = pipe(cfg, 8, 16, seed=0, host_index=0, host_count=2).batch(0)
    h1 = pipe(cfg, 8, 16, seed=0, host_index=1, host_count=2).batch(0)
    assert h0["tokens"].shape == (4, 16)
    assert not torch.equal(h0["tokens"], h1["tokens"])
    assert pipe(cfg, 8, 16, seed=0).batch(0)["tokens"].shape == (8, 16)
    with pytest.raises(ValueError):
        pipe(cfg, 7, 16, host_count=2).batch(0)


def test_labels_are_next_tokens(cfg):
    b = pipe(cfg, 2, 24, seed=1).batch(0)
    assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert b["tokens"].dtype == b["labels"].dtype == torch.int32


def test_learnable_structure(cfg):
    """The next token's entropy given the current token's bucket is far
    below the unigram entropy (the structure an LM learns)."""
    p = pipe(cfg, 16, 256, seed=0)
    batches = [p.batch(i) for i in range(3)]
    toks = torch.cat([x["tokens"].ravel() for x in batches]).numpy()
    nxt = torch.cat([x["labels"].ravel() for x in batches]).numpy()

    def entropy(a):
        _, c = np.unique(a, return_counts=True)
        q = c / c.sum()
        return -(q * np.log(q)).sum()

    buckets = toks % p.n_buckets
    h_cond = sum((buckets == bk).mean() * entropy(nxt[buckets == bk])
                 for bk in np.unique(buckets))
    assert h_cond < 0.8 * entropy(nxt)


def test_frontend_frames():
    cfg = get_arch("musicgen_large", smoke=True)
    b = pipe(cfg, 2, 16, seed=0).batch(0)
    assert "frames" in b and "tokens" not in b
    assert b["frames"].shape == (2, 16, cfg.frontend_dim)
    assert b["frames"].dtype == torch.bfloat16
