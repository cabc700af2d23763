"""The port's sharded search with rank-local tiered stores, on gloo ranks
on the CPU, against the JAX tiered `ShardedSearch` at the same shard count:
2pc-4 through eight spill tiers at the settings of the JAX package's
tests/test_tiered_store.py:258-275 (batch 4, table 2^9, dest_capacity 32,
high water 0.3, summary 2^12) — the counts, the steps, the depth,
`per_chip_unique`, `per_shard_spilled`, the discoveries and the witness,
reconstructed across the shards' tables and spill tiers; and on two ranks
a tiered checkpoint taken after a spill, resumed and regrown, each leg
equal to the same leg of the JAX engine, and the port's file resumed by
the JAX engine. Counts are integers: the tolerance is 0."""

import pytest

import sharded_ranks
from stateright_tpu.parallel import ShardedSearch as JaxSharded
from stateright_tpu.parallel import make_mesh
from stateright_tpu.tensor import models as jm
from stateright_tpu_torch.obs import validate_detail
from stateright_tpu_torch.parallel import run_world

TIERED = dict(batch_size=4, table_log2=9, dest_capacity=32, store="tiered", high_water=0.3,
              summary_log2=12)


@pytest.fixture(scope="module")
def tiered8():
    out = run_world(sharded_ranks.tiered_2pc4, 8, device="cpu", timeout=300)
    return out


@pytest.fixture(scope="module")
def tiered_ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiered") / "t.npz")
    return run_world(sharded_ranks.tiered_checkpoint, 2, path, device="cpu", timeout=300)


@pytest.fixture(scope="module")
def jax8():
    ss = JaxSharded(jm.TensorTwoPhaseSys(4), mesh=make_mesh(8), **TIERED)
    return ss, ss.run()


def test_tiered_2pc4_on_8_ranks_reaches_the_jax_counts(tiered8, jax8):
    _, j = jax8
    got = tiered8[0]
    assert got["counts"] == (j.state_count, j.unique_state_count) == (8258, 1568)
    assert got["complete"] and sum(got["per_chip"]) == 1568
    # The steps, per_chip_unique and the discoveries too: the service runs
    # at the same steps as the JAX engine's.
    assert {k: got[k] for k in sharded_ranks.summary(j)} == sharded_ranks.summary(j)
    d = got["detail"]
    assert d["spill_events"] >= 1 and d["spilled_states"] > 0
    assert len(d["per_shard_spilled"]) == 8 and sum(d["per_shard_spilled"]) == d["spilled_states"]
    assert d["per_shard_spilled"] == j.detail["per_shard_spilled"]
    assert validate_detail(d) == []
    assert d["telemetry"]["generated_total"] == 8258 - 1  # the seed is not a step's
    assert 1.0 <= d["telemetry"]["shard_imbalance"] < 2.0


def test_tiered_witness_reconstructs_across_shards(tiered8, jax8):
    ss, j = jax8
    got = tiered8[0]
    path = got["path"]
    assert path[-1][0] is not None and len(path) - 1 == 3 * 4 + 1
    assert path == ss.reconstruct_path(j.discoveries["commit agreement"]).into_pairs()
    # Every rank got the same path, counts and store counters.
    for other in tiered8[1:]:
        assert (other["path"], other["counts"], other["stats"]) == (
            path, got["counts"], got["stats"])


def test_tiered_checkpoint_resumes_and_regrows(tiered_ckpt, tmp_path):
    """Each leg against the same leg of the JAX tiered engine on a mesh of
    2: the full run, the run stopped at half its steps, the resumed run and
    the run resumed with the table regrown from 2^9 to 2^12."""
    out = tiered_ckpt[0]
    assert all(o == out for o in tiered_ckpt[1:])
    model = jm.TensorTwoPhaseSys
    full = JaxSharded(model(4), mesh=make_mesh(2), **TIERED).run()
    ss = JaxSharded(model(4), mesh=make_mesh(2), **TIERED)
    partial = ss.run(max_steps=full.steps // 2)
    spilled = ss.store_stats()["spilled_states"]
    file = str(tmp_path / "j.npz")
    ss.checkpoint(file)
    resumed = JaxSharded.load_checkpoint(model(4), file, mesh=make_mesh(2)).run()
    grown = JaxSharded.load_checkpoint(model(4), file, mesh=make_mesh(2), table_log2=12).run()
    want = {k: sharded_ranks.summary(r) for k, r in
            dict(full=full, partial=partial, resumed=resumed, grown=grown).items()}
    assert out["full"]["counts"] == (8258, 1568)
    assert out["spilled"] == spilled > 0 and not out["partial"]["complete"]
    for key, w in want.items():
        assert out[key] == w, key
    for key in ("resumed", "grown"):
        assert out[key]["counts"] == out["full"]["counts"] and out[key]["complete"], key
    # The port's file (written by rank 0) resumes in the JAX engine, regrown
    # to 2^12 slots (its pallas variant needs a table of 2^10 or more).
    port = JaxSharded.load_checkpoint(model(4), out["file"], mesh=make_mesh(2),
                                      table_log2=12).run()
    assert sharded_ranks.summary(port) == want["grown"]
