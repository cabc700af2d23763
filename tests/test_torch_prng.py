"""The port's threefry streams (stateright_tpu_torch/tensor/prng.py) against
`jax.random` with its default partitionable threefry, the streams the JAX
package's device simulation draws from: key, split, fold_in, bits and int32
randint, on many seeds, data values and spans, batched over keys. Every
comparison is exact (bits)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu_torch.tensor import prng

SEEDS = [0, 1, 5, 9, 0x5EED, 123456, 2**31 - 1, 2**32 - 1]


def words(k) -> np.ndarray:
    """A JAX key (or keys) as its uint32 words, int64[..., 2]."""
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def port_words(k) -> np.ndarray:
    return torch.stack(torch.broadcast_tensors(*k), -1).numpy()


def test_partitionable_threefry_is_the_default():
    # The twin reproduces the partitionable streams; the engine's parity
    # rests on JAX's default staying so.
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_and_fold_in(seed):
    jk, pk = jax.random.key(seed), prng.key(seed)
    assert (words(jk) == port_words(pk)).all()
    assert (words(jax.random.split(jk, 8)) == port_words(prng.split(pk, 8))).all()
    for d in (0, 3, 77, 0x5EED, 2**31 - 1):
        assert (words(jax.random.fold_in(jk, d)) == port_words(prng.fold_in(pk, d))).all()


def test_fold_in_batched_over_keys_and_data():
    keys_j = jax.random.split(jax.random.key(42), 64)
    keys_p = prng.split(prng.key(42), 64)
    data = np.random.default_rng(0).integers(0, 2**31 - 1, 64)
    jf = jax.vmap(jax.random.fold_in)(keys_j, jnp.asarray(data, jnp.int32))
    assert (words(jf) == port_words(prng.fold_in(keys_p, torch.from_numpy(data)))).all()
    # Two levels, as the simulation folds a restart count, then a step.
    jf2 = jax.vmap(lambda k: jax.random.fold_in(k, 0x5EED))(jf)
    pf2 = prng.fold_in(prng.fold_in(keys_p, torch.from_numpy(data)), 0x5EED)
    assert (words(jf2) == port_words(pf2)).all()


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_bits32(seed):
    keys_j = jax.random.split(jax.random.key(seed), 32)
    keys_p = prng.split(prng.key(seed), 32)
    jb = jax.vmap(lambda k: jax.random.bits(k, (), jnp.uint32))(keys_j)
    assert (np.asarray(jb).astype(np.int64) == prng.bits32(keys_p).numpy()).all()


@pytest.mark.parametrize("span", [1, 2, 3, 7, 13, 72, 288, 65536, 65537, 2**31 - 1])
def test_randint_fixed_span(span):
    keys_j = jax.random.split(jax.random.key(span), 256)
    keys_p = prng.split(prng.key(span), 256)
    jr = jax.vmap(lambda k: jax.random.randint(k, (), 0, span))(keys_j)
    assert (np.asarray(jr).astype(np.int64) == prng.randint(keys_p, 0, span).numpy()).all()


def test_randint_per_key_spans_and_empty_range():
    # The simulation's draw: randint(k, (), 0, max(vcount, 1)) with a span
    # per lane; hi <= lo gives lo (span 1).
    rng = np.random.default_rng(1)
    spans = rng.integers(0, 300, 512).astype(np.int32)
    spans[:8] = [0, 1, 1, 2, 0, 65537, 2**31 - 1, 5]
    keys_j = jax.random.split(jax.random.key(3), 512)
    keys_p = prng.split(prng.key(3), 512)
    jr = jax.vmap(lambda k, n: jax.random.randint(k, (), 0, jnp.maximum(n, 1)))(
        keys_j, jnp.asarray(spans))
    pr = prng.randint(keys_p, 0, torch.from_numpy(spans.astype(np.int64)).clamp(min=1))
    assert (np.asarray(jr).astype(np.int64) == pr.numpy()).all()
    jz = jax.vmap(lambda k: jax.random.randint(k, (), 4, 4))(keys_j)
    assert (np.asarray(jz) == 4).all()
    assert (prng.randint(keys_p, 4, 4).numpy() == 4).all()


def test_threefry_known_answer():
    # The Random123 known-answer vector for Threefry-2x32-20 with all-ones
    # words (jax.random's threefry2x32 is the same function).
    m = 0xFFFFFFFF
    x = prng.threefry2x32(torch.tensor(m), torch.tensor(m), torch.tensor(m), torch.tensor(m))
    assert (int(x[0]), int(x[1])) == (0x1CB996FC, 0xBB002BE7)
