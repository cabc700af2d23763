"""The port's device fingerprint (stateright_tpu_torch/tensor/fingerprint.py)
against the JAX package's: bit-identical (lo, hi) on random uint32 rows,
the lo == 0 -> 1 remap, and the pack/unpack round trips."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.tensor import fingerprint as jfp
from stateright_tpu_torch.tensor import fingerprint as tfp


@pytest.mark.parametrize("lanes", [2, 6, 13])
def test_device_fingerprint_bit_identical(lanes):
    rng = np.random.default_rng(lanes)
    rows = rng.integers(0, 2**32, (4096, lanes), dtype=np.uint32)
    rows[0] = 0
    rows[1] = 0xFFFFFFFF
    j_lo, j_hi = (np.asarray(x) for x in jfp.device_fingerprint(jnp.asarray(rows)))
    t_lo, t_hi = tfp.device_fingerprint(torch.from_numpy(rows.astype(np.int64)))
    np.testing.assert_array_equal(t_lo.numpy(), j_lo.astype(np.int64))
    np.testing.assert_array_equal(t_hi.numpy(), j_hi.astype(np.int64))
    # pack: the int64 key is the bit pattern of the JAX package's uint64.
    key = tfp.pack_fp(t_lo, t_hi)
    np.testing.assert_array_equal(tfp.to_host_fp(key), jfp.pack_fp(j_lo, j_hi))
    lo2, hi2 = tfp.unpack_fp(key)
    assert torch.equal(lo2, t_lo) and torch.equal(hi2, t_hi)
    for fp in jfp.pack_fp(j_lo[:64], j_hi[:64]).tolist():
        assert int(tfp.to_host_fp(torch.tensor([tfp.from_host_fp(fp)]))[0]) == fp
        assert jfp.unpack_fp(fp) == tuple(
            int(x) for x in tfp.unpack_fp(torch.tensor(tfp.from_host_fp(fp)))
        )


def test_lo_zero_remaps_to_one_in_both():
    # The single-lane row whose lo fold is exactly 0 (fmix32 is a bijection
    # fixing 0, so the fold input must be 0): lane = 0x6C078965.
    x = (0x6C078965 - 0x9E3779B9) & 0xFFFFFFFF
    rows = np.array([[x], [x + 1]], dtype=np.uint32)
    j_lo, j_hi = (np.asarray(v) for v in jfp.device_fingerprint(jnp.asarray(rows)))
    t_lo, t_hi = tfp.device_fingerprint(torch.from_numpy(rows.astype(np.int64)))
    assert int(j_lo[0]) == 1 and int(t_lo[0]) == 1
    np.testing.assert_array_equal(t_lo.numpy(), j_lo.astype(np.int64))
    np.testing.assert_array_equal(t_hi.numpy(), j_hi.astype(np.int64))


def test_mix32_bit_identical():
    rng = np.random.default_rng(3)
    h = rng.integers(0, 2**32, 8192, dtype=np.uint32)
    h[:3] = [0, 1, 0xFFFFFFFF]
    want = np.asarray(jfp._mix32(jnp.asarray(h))).astype(np.int64)
    got = tfp._mix32(torch.from_numpy(h.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)
