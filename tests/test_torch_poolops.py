"""The port's sorted-pool operations (stateright_tpu_torch/tensor/poolops.py)
against the JAX package's, on random sorted pools with EMPTY tails,
duplicates and emissions that overflow — integers, so exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.tensor import poolops as jp
from stateright_tpu_torch.tensor import poolops as tp
from test_torch_models import one_torch_thread  # noqa: F401 (autouse)

EMPTY = np.uint32(0xFFFFFFFF)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _same(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def _random_pool(rng, B, M, vocab):
    pool = np.full((B, M), EMPTY, dtype=np.uint32)
    for b in range(B):
        n = rng.integers(0, M + 1)
        pool[b, :n] = np.sort(rng.integers(0, vocab, n, dtype=np.uint32))
    return pool


def _sort_based(pool, d, ems):
    """Reference semantics: drop one slot, append, sort, truncate."""
    B, M = pool.shape
    dropped = pool.copy()
    dropped[np.arange(B), d] = EMPTY
    cat = np.concatenate([dropped, ems], axis=1)
    cat.sort(axis=1)
    return cat[:, :M], (cat[:, M:] != EMPTY).any(axis=1)


@pytest.mark.parametrize("vocab", [6, 2**31])  # heavy duplication, spread-out ids
@pytest.mark.parametrize("K,keep", [(17, 14), (17, 17), (5, 1)])
def test_rank_sort_equals_jax(K, keep, vocab):
    rng = np.random.default_rng(K + keep)
    vals = np.where(
        rng.random((256, K)) < 0.7, rng.integers(0, vocab, (256, K), dtype=np.uint32), EMPTY
    ).astype(np.uint32)
    vals[0] = EMPTY  # an all-EMPTY row
    got, ovf = tp.rank_sort([_t(vals[:, i]) for i in range(K)], keep)
    want, want_ovf = jp.rank_sort([jnp.asarray(vals[:, i]) for i in range(K)], keep)
    _same(got, want)
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(want_ovf))
    np.testing.assert_array_equal(got.numpy(), np.sort(vals, axis=1)[:, :keep])


@pytest.mark.parametrize("keep", [0, 4])
def test_rank_sort_rejects_a_keep_out_of_range(keep):
    with pytest.raises(ValueError, match="keep"):
        tp.rank_sort([_t(np.zeros(4, np.uint32))] * 3, keep)


def test_rank_sort_pool_equals_jax():
    rng = np.random.default_rng(8)
    B, P, n, k = 128, 10, 6, 3
    pool = _random_pool(rng, B, P, 12)
    emits = np.where(
        rng.random((B, n, k)) < 0.5, rng.integers(0, 12, (B, n, k), dtype=np.uint32), EMPTY
    ).astype(np.uint32)
    got, ovf = tp.rank_sort_pool(_t(pool), _t(emits), n)
    want, want_ovf = jp.rank_sort_pool(jnp.asarray(pool), jnp.asarray(emits), n)
    _same(got, want)
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(want_ovf))
    assert ovf.any() and not ovf.all()


@pytest.mark.parametrize("vocab", [6, 2**31])
def test_drop_then_merge_equals_jax_and_the_sort_rebuild(vocab):
    rng = np.random.default_rng(11)
    B, M, k = 512, 14, 3
    pool = _random_pool(rng, B, M, vocab)
    d = rng.integers(0, M, B)
    ems = np.where(
        rng.random((B, k)) < 0.6, rng.integers(0, vocab, (B, k), dtype=np.uint32), EMPTY
    ).astype(np.uint32)
    q = tp.drop_slot(_t(pool), torch.from_numpy(d))
    jq = jp.drop_slot(jnp.asarray(pool), jnp.asarray(d, dtype=jnp.int32))
    _same(q, jq)
    got, ovf = tp.merge_insert_sorted(q, _t(ems))
    want, want_ovf = jp.merge_insert_sorted(jq, jnp.asarray(ems))
    _same(got, want)
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(want_ovf))
    ref, ref_ovf = _sort_based(pool, d, ems)
    _same(got, ref)
    np.testing.assert_array_equal(ovf.numpy(), ref_ovf)


def test_merge_overflow_flags_real_spill_only():
    # A full pool plus one real emission overflows; plus EMPTY does not.
    pool = _t(np.arange(1, 9, dtype=np.uint32)[None, :])
    _, ovf = tp.merge_insert_sorted(pool, _t([[5, EMPTY]]))
    assert bool(ovf[0])
    out, ovf = tp.merge_insert_sorted(pool, _t([[EMPTY, EMPTY]]))
    assert not bool(ovf[0])
    np.testing.assert_array_equal(out.numpy()[0], np.arange(1, 9))
