"""The port's Bloom summary (stateright_tpu_torch/store/summary.py) against
the JAX package's `stateright_tpu/store/summary.py`: the hash pair, the
probe (numpy and torch forms) and the host bit insert, word for word and
lane for lane (tolerance 0: everything here is an integer or a bit)."""

import numpy as np
import pytest
import torch

from stateright_tpu.store import summary as js
from stateright_tpu_torch.store import summary as ps


def _keys(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, 2**32, n, dtype=np.uint32),
            rng.integers(0, 2**32, n, dtype=np.uint32))


def _lanes(a):
    return torch.from_numpy(a.astype(np.int64))


def test_hash_pair_equals_jax():
    lo, hi = _keys(1, 5000)
    # Corner values: the mask and shift edges of uint32.
    lo = np.concatenate([lo, np.array([1, 2**31, 2**32 - 1], np.uint32)])
    hi = np.concatenate([hi, np.array([0, 2**31, 2**32 - 1], np.uint32)])
    h1, h2 = ps._h1h2(_lanes(lo), _lanes(hi))
    j1, j2 = js._h1h2(lo, hi)
    np.testing.assert_array_equal(h1.numpy(), j1.astype(np.int64))
    np.testing.assert_array_equal(h2.numpy(), j2.astype(np.int64))


@pytest.mark.parametrize("slog2,hashes", [(10, 4), (14, 4), (16, 3), (20, 1)])
def test_host_insert_sets_the_same_words(slog2, hashes):
    lo, hi = _keys(2, 3000)
    want = np.zeros(js.summary_words(slog2), np.uint32)
    got = np.zeros(ps.summary_words(slog2), np.uint32)
    js.host_insert(want, lo, hi, slog2, hashes)
    ps.host_insert(got, lo, hi, slog2, hashes)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("slog2", [12, 16])
def test_maybe_contains_equals_jax_numpy_and_torch(slog2):
    lo, hi = _keys(3, 4000)
    words = np.zeros(js.summary_words(slog2), np.uint32)
    js.host_insert(words, lo[:2000], hi[:2000], slog2)
    want = np.asarray(js.maybe_contains(words, lo, hi, slog2))
    np.testing.assert_array_equal(ps.maybe_contains(words, lo, hi, slog2), want)
    dev_words = torch.from_numpy(words.view(np.int32))
    got = ps.maybe_contains(dev_words, _lanes(lo), _lanes(hi), slog2)
    np.testing.assert_array_equal(got.numpy(), want)
    # No false negatives: every inserted key is a possible member.
    assert want[:2000].all()
    # And the others mostly are not (2000 keys in 2^12 bits is a dense
    # summary; 2^16 bits is ~33 bits a key).
    assert want[2000:].mean() < (0.9 if slog2 == 12 else 0.01)


def test_summary_words_bounds():
    assert ps.summary_words(5) == 1 and ps.summary_words(28) == 1 << 23
    with pytest.raises(ValueError):
        ps.summary_words(4)


def test_torch_insert_sets_the_same_words():
    # The torch form the tiered store runs on the table's device, in two
    # batches that share words: bits are OR-ed in, never overwritten.
    lo, hi = _keys(4, 3000)
    want = np.zeros(js.summary_words(16), np.uint32)
    js.host_insert(want, lo, hi, 16, 4)
    got = torch.zeros(ps.summary_words(16), dtype=torch.int32)
    keys = (_lanes(hi) << 32) | _lanes(lo)
    ps.insert(got, keys[:1500], 16)
    ps.insert(got, keys[1500:], 16)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
