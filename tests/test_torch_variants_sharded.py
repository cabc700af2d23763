"""The XLA insert designs on the port's sharded search with rank-local
tiered stores, and a design's sharded checkpoint, on gloo ranks on the CPU
(tests/sharded_ranks.py), held against the JAX `ShardedSearch` on a virtual
CPU mesh of the same size: 2pc-4 through two designs on two tiered ranks
(each shard's store counters, sweep hand and spill tier, and its table
slot for slot), and a "sort" checkpoint crossing both ways, loaded slot for
slot and regrown through "sort". Every comparison is exact."""

import numpy as np
import pytest

import sharded_ranks
from stateright_tpu.parallel import ShardedSearch as JaxSharded
from stateright_tpu.parallel import make_mesh
from stateright_tpu.tensor import models as jm
from stateright_tpu_torch.parallel import run_world
from tests.test_torch_variants_engines import DEVICE, GOLD_2PC4, _assert_world, _jax

TIERED = dict(batch_size=4, table_log2=9, dest_capacity=32, store="tiered", high_water=0.3,
              summary_log2=12)


@pytest.fixture(scope="module")
def tiered2():
    return run_world(sharded_ranks.designs_2pc4, 2, ["sort", "phased"], "scatter", "tiered",
                     device="cpu", timeout=300)


@pytest.mark.parametrize("variant", ["sort", "phased"])
def test_tiered_designs_on_2_ranks_equal_jax(tiered2, variant):
    ss, _ = _assert_world(tiered2, variant, 2, append="scatter", **TIERED)
    stats = tiered2[0][variant]["stats"]
    assert stats["spill_events"] >= 1 and stats["partition_spills"] == 0
    jstats = ss.store_stats()
    for k in ("spilled_states", "spill_events", "suspects_checked", "suspects_dup",
              "per_shard_spilled"):
        assert stats[k] == jstats[k], k
    for i, rank in enumerate(tiered2):
        mine = rank[variant]
        js = ss._stores[i]
        assert mine["sweep"] == js.sweep
        fps, parents = js.store.to_arrays()
        assert mine["spill"] == [fps.tolist(), parents.tolist()]


@pytest.fixture(scope="module")
def crossed(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_sort")
    jax_file, port_file = str(d / "jax.npz"), str(d / "port.npz")
    ss = JaxSharded(jm.TensorTwoPhaseSys(4), mesh=make_mesh(2), insert_variant="sort",
                    append="scatter", **DEVICE)
    ss.run(max_steps=4, budget=4)
    ss.checkpoint(jax_file)
    out = run_world(sharded_ranks.design_checkpoint, 2, port_file, jax_file, device="cpu",
                    timeout=300)
    return out, jax_file, port_file


def test_sort_checkpoint_crosses_both_ways_slot_for_slot(crossed):
    out, jax_file, port_file = crossed
    data = np.load(jax_file)
    _, full = _jax(2, "sort", append="scatter", **DEVICE)
    for i, rank in enumerate(out):
        assert rank["variant"] == "sort"
        for k, ours in zip(("t_lo", "t_hi", "p_lo", "p_hi"), rank["table"]):
            np.testing.assert_array_equal(np.asarray(ours, np.uint32), data[k][i])
        got = rank["resumed"]
        assert got["counts"] == GOLD_2PC4 and got["complete"]
        assert got["per_chip"] == full.detail["per_chip_unique"]
        assert got["discoveries"] == full.discoveries
    j = JaxSharded.load_checkpoint(jm.TensorTwoPhaseSys(4), port_file, mesh=make_mesh(2))
    assert j.insert_variant == "sort"
    r = j.run()
    assert (r.state_count, r.unique_state_count) == GOLD_2PC4 and r.complete
    assert r.discoveries == out[0]["resumed"]["discoveries"]


def test_sort_checkpoint_regrows_through_sort_like_jax(crossed):
    out, jax_file, _ = crossed
    grown = JaxSharded.load_checkpoint(jm.TensorTwoPhaseSys(4), jax_file, mesh=make_mesh(2),
                                       table_log2=12)
    tables = [np.asarray(getattr(grown._carry, k)).reshape(2, -1)
              for k in ("t_lo", "t_hi", "p_lo", "p_hi")]
    r = grown.run()
    for i, rank in enumerate(out):
        for ours, theirs in zip(rank["grown_table"], tables):
            np.testing.assert_array_equal(np.asarray(ours, np.uint32), theirs[i])
        assert rank["grown"]["counts"] == (r.state_count, r.unique_state_count) == GOLD_2PC4
        assert rank["grown"]["per_chip"] == r.detail["per_chip_unique"]
