"""The port's synthetic data pipeline (``data/pipeline.py``, numpy only)
against the JAX package's: a seed gives the same arrays, bit for bit."""
import numpy as np
import pytest

from repro.configs.registry import reduced_config as ref_reduced
from repro.data import pipeline as RP
from repro_torch.configs.registry import reduced_config
from repro_torch.data import pipeline as P


def assert_same(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("arch", ("gemma2_2b", "llava_next_34b",
                                  "whisper_tiny"))
@pytest.mark.parametrize("seed", (0, 1, 42))
def test_lm_batches_bit_equal(arch, seed):
    got = P.lm_batches(reduced_config(arch), 3, 48, seed=seed)
    want = RP.lm_batches(ref_reduced(arch), 3, 48, seed=seed)
    for _ in range(3):
        assert_same(next(got), next(want))


def test_shard_batch():
    b = next(P.lm_batches(reduced_config("gemma2_2b"), 8, 32, seed=42))
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["targets"][:, :-1])
    parts = [P.shard_batch(b, n_hosts=4, host_id=i) for i in range(4)]
    assert all(p["tokens"].shape == (2, 32) for p in parts)
    np.testing.assert_array_equal(
        np.concatenate([p["tokens"] for p in parts]), b["tokens"])
    assert_same(parts[1], RP.shard_batch(b, n_hosts=4, host_id=1))


@pytest.mark.parametrize("seed", (0, 3))
def test_needle_prompt_bit_equal(seed):
    got = P.needle_prompt(vocab=1024, seq=2048, n_needles=4, seed=seed)
    assert_same(got, RP.needle_prompt(vocab=1024, seq=2048, n_needles=4,
                                      seed=seed))
    toks, pos = got
    for i, p in enumerate(pos):
        assert (toks[p:p + 8] == 1024 - 1 - i).all()


@pytest.mark.parametrize("seed", (0, 5))
def test_clustered_keys_bit_equal(seed):
    assert_same(P.clustered_keys(1024, 64, n_hot=3, seed=seed),
                RP.clustered_keys(1024, 64, n_hot=3, seed=seed))


@pytest.mark.parametrize("seq", (None, 40))
def test_assoc_recall_batch_bit_equal(seq):
    got = P.assoc_recall_batch(np.random.default_rng(7), 4, 8, 64, seq=seq)
    want = RP.assoc_recall_batch(np.random.default_rng(7), 4, 8, 64,
                                 seq=seq)
    assert_same(got, want)
