"""The port's sharded search (parallel/sharded.py) on gloo ranks on the CPU
against the JAX package's `ShardedSearch` on the virtual CPU mesh at the
same shard count: the generated and unique totals, the steps, the depth,
`detail["per_chip_unique"]` shard for shard, the discovery fingerprints and
the witness paths, equal on every rank. Counts and fingerprints are
integers: the tolerance is 0.

Each world (8, 4, 2 and 1 ranks) is launched once for the module through
`run_world(..., device="cpu")` and runs several scenarios
(tests/sharded_ranks.py, which imports only the port)."""

import pytest

import sharded_ranks
from stateright_tpu.core.discovery import HasDiscoveries as JaxHD
from stateright_tpu.parallel import ShardedSearch as JaxSharded
from stateright_tpu.parallel import make_mesh
from stateright_tpu.tensor import models as jm
from stateright_tpu.tensor.paxos import TensorPaxos as JaxPaxos
from stateright_tpu_torch.parallel import run_world


def _world(fn, n):
    """Every rank's return value of fn in a CPU world of n ranks; all ranks
    must agree."""
    out = run_world(fn, n, device="cpu", timeout=300)
    assert all(o == out[0] for o in out[1:]), "the ranks disagree"
    return out[0]


@pytest.fixture(scope="module")
def world8():
    return _world(sharded_ranks.world_of_8, 8)


@pytest.fixture(scope="module")
def world4():
    return _world(sharded_ranks.world_of_4, 4)


@pytest.fixture(scope="module")
def world2():
    return _world(sharded_ranks.world_of_2, 2)


@pytest.fixture(scope="module")
def world1():
    return _world(sharded_ranks.world_of_1, 1)


def _jax(model, n, run_kw=None, **kw):
    ss = JaxSharded(model, mesh=make_mesh(n), **kw)
    return ss, ss.run(**(run_kw or {}))


def _jax_summary(r) -> dict:
    return sharded_ranks.summary(r)


def test_2pc3_on_8_ranks_equals_jax(world8):
    _, j = _jax(jm.TensorTwoPhaseSys(3), 8, batch_size=64, table_log2=12)
    got = world8["2pc3"]
    assert got["counts"] == (1146, 288) and got["complete"]
    assert got == _jax_summary(j)
    assert set(got["discoveries"]) == {"abort agreement", "commit agreement"}


def test_paxos1_on_8_ranks_equals_jax(world8):
    _, j = _jax(JaxPaxos(client_count=1), 8, batch_size=128, table_log2=10)
    assert world8["paxos1"]["counts"] == (482, 265)
    assert world8["paxos1"] == _jax_summary(j)


def test_path_across_shards_equals_jax(world8):
    ss, j = _jax(jm.TensorLinearEquation(2, 10, 14), 8, batch_size=128, table_log2=14)
    assert world8["lineq"] == _jax_summary(j)
    path = world8["lineq_path"]
    assert path == ss.reconstruct_path(j.discoveries["solvable"]).into_pairs()
    assert sorted(a for _, a in path if a is not None) == ["IncreaseX", "IncreaseX", "IncreaseY"]
    assert path[-1][0] == (2, 1)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_2pc4_per_shard_counts_equal_jax(n, world1, world2, world4):
    got = {1: world1, 2: world2, 4: world4}[n]["2pc4"]
    _, j = _jax(jm.TensorTwoPhaseSys(4), n, batch_size=128, table_log2=13)
    assert got["counts"] == (8258, 1568)
    assert len(got["per_chip"]) == n and sum(got["per_chip"]) == 1568
    assert got == _jax_summary(j)


def test_early_exits_equal_jax(world4):
    _, j = _jax(jm.TensorTwoPhaseSys(3), 4, run_kw=dict(finish_when=JaxHD.ANY),
                batch_size=64, table_log2=12)
    assert world4["any"] == _jax_summary(j)
    assert world4["any"]["discoveries"] and world4["any"]["counts"][1] < 288
    _, j = _jax(jm.TensorLinearEquation(2, 4, 7), 4, run_kw=dict(target_state_count=500),
                batch_size=64, table_log2=16)
    assert world4["target"] == _jax_summary(j)
    assert world4["target"]["counts"][0] >= 500 and not world4["target"]["complete"]


def test_suspend_and_resume_reach_the_full_run(world4):
    full = world4["2pc4"]
    assert not world4["partial"]["complete"] and world4["partial"]["steps"] == 2
    assert world4["partial"]["counts"][0] < full["counts"][0]
    assert world4["resumed"] == full
    assert world4["progress"] and world4["progress"][-1] == full["counts"][0]


def test_overflows_raise(world2, world4):
    assert "overflow" in world2["overflow"] and "table_log2" in world2["overflow"]
    assert "dest_capacity" in world4["route"]


def test_refine_check_over_the_sharded_engine(world4):
    from stateright_tpu.actor.test_util import PingPongCfg

    host = PingPongCfg(max_nat=3, maintains_history=False).into_model() \
        .with_lossy_network(False).checker().spawn_bfs().join()
    got = world4["refine"]
    assert got["complete"] and len(got["per_chip"]) == 4
    assert got["counts"] == (host.state_count(), host.unique_state_count())
    assert got["counts"][1] == 7


def test_lowered_paxos2_on_2_ranks(world2):
    """Against the JAX engine on a mesh of 2, with the same lowering (the
    JAX package's tests/test_sharded.py:288-322)."""
    from stateright_tpu.actor import Network
    from stateright_tpu.actor.register import GetOk
    from stateright_tpu.examples.paxos import NULL_VALUE, PaxosModelCfg
    from stateright_tpu.tensor import TensorProperty
    from stateright_tpu.tensor.lowering import lower_actor_model

    def properties(view):
        lin = view.history_pred(lambda h: h.is_consistent())
        chosen = view.any_env(lambda e: isinstance(e.msg, GetOk) and e.msg.value != NULL_VALUE)
        return [
            TensorProperty.always("linearizable", lambda m, s: lin(s)),
            TensorProperty.sometimes("value chosen", lambda m, s: chosen(s)),
        ]

    cfg = PaxosModelCfg(client_count=2, server_count=3,
                        network=Network.new_unordered_nonduplicating())
    lowered = lower_actor_model(cfg.into_model(), properties=properties, closure="exact")
    _, j = _jax(lowered, 2, batch_size=256, table_log2=16)
    got = world2["paxos2"]
    assert got["counts"] == (32971, 16668) and got["complete"]
    assert set(got["discoveries"]) == {"value chosen"}
    assert len(got["per_chip"]) == 2
    assert got == _jax_summary(j)


def test_a_failed_or_hung_rank_stops_the_world():
    """run_world kills every rank when one raises (its peer waits in a
    collective) or when the world outlives its timeout."""
    with pytest.raises(RuntimeError, match="failed"):
        run_world(sharded_ranks.fail_on_rank_1, 2, device="cpu", timeout=120)
    with pytest.raises(RuntimeError, match="did not finish"):
        run_world(sharded_ranks.sleep_past, 1, 120.0, device="cpu", timeout=3)


def test_torchrun_entry_point_equals_jax():
    """A script under torchrun (tests/torchrun_sharded.py: init_world from
    the environment torchrun sets) on two CPU ranks over gloo."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    here = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(here.parent)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         str(here / "torchrun_sharded.py")],
        capture_output=True, text=True, timeout=180, cwd=here.parent, env=env,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, out.stdout  # rank 0 alone prints
    got = json.loads(lines[0])
    _, j = _jax(jm.TensorTwoPhaseSys(3), 2, batch_size=64, table_log2=12)
    assert (got["generated"], got["unique"], got["steps"]) == (
        j.state_count, j.unique_state_count, j.steps) == (1146, 288, j.steps)
    assert got["per_chip_unique"] == j.detail["per_chip_unique"] and got["complete"]
    assert got["discoveries"] == sorted(j.discoveries)
