"""The XLA insert designs, the "dus" append and `donate_chunks` on the
port's sharded search, on gloo ranks on the CPU (tests/sharded_ranks.py),
held against the JAX `ShardedSearch` on a virtual CPU mesh of the same
size: 2pc-4 through each design with "dus" at 2 and 8 ranks, and the JAX
package's tests/test_donate_chunks.py sharded cases (the donated golden at
8 ranks, the overflow that leaves no carry). Per run: the counts, the
steps, the depth, `per_chip_unique`, the discoveries and every shard's
table slot for slot. The tiered store and checkpoints are in
tests/test_torch_variants_sharded.py. Every comparison is exact."""

import numpy as np
import pytest

import sharded_ranks
from stateright_tpu.parallel import ShardedSearch as JaxSharded
from stateright_tpu.parallel import make_mesh
from stateright_tpu.tensor import models as jm
from stateright_tpu_torch.parallel import run_world

DESIGNS = ["sort", "phased", "capped", "capped-phased"]
DEVICE = dict(batch_size=128, table_log2=11)
GOLD_2PC4 = (8258, 1568)


@pytest.fixture(scope="module")
def world8():
    return run_world(sharded_ranks.designs_and_donated, 8, DESIGNS, "dus", device="cpu",
                     timeout=300)


@pytest.fixture(scope="module")
def world2():
    return run_world(sharded_ranks.designs_2pc4, 2, DESIGNS, "dus", device="cpu", timeout=300)


def _jax(n, variant, **kw):
    ss = JaxSharded(jm.TensorTwoPhaseSys(4), mesh=make_mesh(n), insert_variant=variant, **kw)
    return ss, ss.run()


def _assert_world(ranks, variant, n, append="dus", **kw):
    ss, r = _jax(n, variant, append=append, **kw)
    got = ranks[0][variant]
    assert got["counts"] == GOLD_2PC4 and got["complete"]
    assert got == {**got, **sharded_ranks.summary(r)}
    for i, rank in enumerate(ranks):
        assert rank[variant]["counts"] == got["counts"]  # every rank agrees
        for ours, theirs in zip(rank[variant]["table"], ss._last_tables):
            np.testing.assert_array_equal(np.asarray(ours, np.uint32),
                                          np.asarray(theirs)[i])
    return ss, r


@pytest.mark.parametrize("variant", DESIGNS)
def test_designs_with_dus_on_8_ranks_equal_jax(world8, variant):
    _assert_world(world8, variant, 8, **DEVICE)


@pytest.mark.parametrize("variant", DESIGNS)
def test_designs_with_dus_on_2_ranks_equal_jax(world2, variant):
    _assert_world(world2, variant, 2, **DEVICE)


def test_sharded_donated_chunked_run_matches_goldens(world8):
    got = world8[0]["donated"]["golden"]
    ss = JaxSharded(jm.TensorTwoPhaseSys(4), mesh=make_mesh(8), batch_size=128, table_log2=11,
                    donate_chunks=True, append="dus")
    r = ss.run(budget=4)
    assert got["counts"] == GOLD_2PC4 and got["complete"]
    assert sum(got["per_chip"]) == 1568
    assert got == {**got, **sharded_ranks.summary(r)}


def test_sharded_donated_overflow_has_no_recovery_carry(world8):
    for rank in world8:
        d = rank["donated"]
        assert "donate_chunks=True sacrificed the recovery carry" in d["overflow"]
        assert d["carry"]
        assert "no table snapshot" in d["path"]
        assert "nothing to checkpoint" in d["checkpoint"]
