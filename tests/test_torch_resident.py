"""The port's device BFS end to end on the CPU — `spawn_cuda(device="cpu")`,
which runs tensor/resident.py with the plain insert — against the JAX
package's `spawn_tpu`: counts, depth, discovery fingerprints and
reconstructed paths."""

import io

import numpy as np
import pytest

from stateright_tpu.core.discovery import HasDiscoveries as JaxHD
from stateright_tpu.tensor import models as jm
from stateright_tpu_torch import HasDiscoveries, WriteReporter
from stateright_tpu_torch.tensor import models as tm
from stateright_tpu_torch.tensor import resident
from stateright_tpu_torch.tensor.resident import ResidentSearch


@pytest.fixture(scope="module")
def twopc3():
    """2pc-3 through JAX's Pallas insert (interpret mode) and through the
    port, once for the module."""
    jax_c = jm.TensorTwoPhaseSys(3).checker().spawn_tpu(
        insert_variant="pallas", table_log2=12
    ).join()
    port_c = tm.TensorTwoPhaseSys(3).checker().spawn_cuda(
        table_log2=12, device="cpu"
    ).join()
    return jax_c, port_c


def test_2pc3_counts_and_depth_equal_jax(twopc3):
    jax_c, port_c = twopc3
    assert (port_c.state_count(), port_c.unique_state_count()) == (1146, 288)
    assert (jax_c.state_count(), jax_c.unique_state_count()) == (1146, 288)
    assert port_c.max_depth() == jax_c.max_depth()
    assert port_c.result().complete


def test_2pc3_discoveries_and_paths_equal_jax(twopc3):
    jax_c, port_c = twopc3
    assert port_c.result().discoveries == jax_c._result.discoveries
    assert set(port_c.discoveries()) == {"abort agreement", "commit agreement"}
    for name, path in jax_c.discoveries().items():
        assert port_c.discoveries()[name].into_pairs() == path.into_pairs()
    # The whole parent table agrees too (lowest-lane attribution in both).
    assert port_c._search.build_parent_map() == jax_c._search.build_parent_map()


def test_2pc3_report_and_assertions(twopc3):
    _, port_c = twopc3
    out = io.StringIO()
    port_c.report(WriteReporter(out))
    assert out.getvalue().startswith("Done. states=1146, unique=288, depth=11, sec=")
    assert 'Discovered "abort agreement" example Path[3]:' in out.getvalue()
    port_c.assert_no_discovery("consistent")
    port_c.assert_discovery(
        "abort agreement",
        [("rm_choose_abort", 0), ("rm_choose_abort", 1), ("rm_choose_abort", 2)],
    )
    with pytest.raises(AssertionError, match="Invalid discovery"):
        port_c.assert_discovery("abort agreement", [("rm_choose_abort", 0)])


def test_2pc4_counts_equal_jax_default_engine():
    jax_c = jm.TensorTwoPhaseSys(4).checker().spawn_tpu(table_log2=14).join()
    port_c = tm.TensorTwoPhaseSys(4).checker().spawn_cuda(
        table_log2=14, device="cpu"
    ).join()
    assert (port_c.state_count(), port_c.unique_state_count()) == (8258, 1568)
    assert (jax_c.state_count(), jax_c.unique_state_count()) == (8258, 1568)
    assert port_c.max_depth() == jax_c.max_depth()
    assert port_c.result().discoveries == jax_c._result.discoveries


def test_linear_equation_finds_shortest_example():
    # As tests/test_tensor_checker.py pins it for the JAX engines.
    c = tm.TensorLinearEquation(2, 10, 14).checker().spawn_cuda(
        batch_size=512, table_log2=18, device="cpu"
    ).join()
    path = c.discoveries()["solvable"]
    assert sorted(path.actions()) == ["IncreaseX", "IncreaseX", "IncreaseY"]
    assert path.last_state() == (2, 1)
    c.assert_discovery("solvable", ["IncreaseY", "IncreaseX", "IncreaseX"])


@pytest.mark.parametrize(
    "configure",
    [
        lambda b, H: b.finish_when(H.ANY),
        lambda b, H: b.finish_when(H.ALL_FAILURES),
        lambda b, H: b.finish_when(H.any_of(["commit agreement"])),
        lambda b, H: b.target_state_count(500),
        lambda b, H: b.target_max_depth(5),
    ],
    ids=["any", "all_failures", "any_of", "target_state_count", "target_max_depth"],
)
def test_finish_policies_match_jax(configure):
    j = configure(jm.TensorTwoPhaseSys(3).checker(), JaxHD).spawn_tpu(
        batch_size=64, table_log2=12
    ).join()
    p = configure(tm.TensorTwoPhaseSys(3).checker(), HasDiscoveries).spawn_cuda(
        batch_size=64, table_log2=12, device="cpu"
    ).join()
    assert (p.state_count(), p.unique_state_count(), p.max_depth()) == (
        j.state_count(), j.unique_state_count(), j.max_depth()
    )
    assert p.result().discoveries == j._result.discoveries


def test_queue_overflow_is_reported():
    c = tm.TensorTwoPhaseSys(3).checker().spawn_cuda(
        batch_size=64, table_log2=12, queue_log2=6, device="cpu"
    )
    with pytest.raises(RuntimeError, match="frontier queue full"):
        c.join()


def test_table_overflow_is_reported():
    # 128 slots for 288 unique states.
    c = tm.TensorTwoPhaseSys(3).checker().spawn_cuda(
        batch_size=64, table_log2=7, queue_log2=10, device="cpu"
    )
    with pytest.raises(RuntimeError, match="hash table full"):
        c.join()


def test_chunk_size_does_not_change_results(monkeypatch):
    runs = []
    for k in (1, 7, 64):
        monkeypatch.setattr(resident, "CHUNK_STEPS", k)
        runs.append(ResidentSearch(tm.TensorTwoPhaseSys(3), 32, 12, device="cpu").run())
    assert {(r.state_count, r.unique_state_count, r.max_depth, r.steps) for r in runs} == {
        (runs[0].state_count, 288, runs[0].max_depth, runs[0].steps)
    }
    assert runs[0].state_count == 1146


def test_dump_states_covers_every_unique_state():
    rs = ResidentSearch(tm.TensorTwoPhaseSys(3), 64, 12, device="cpu")
    rs.run()
    rows = rs.dump_states(decode=False)
    assert len(rows) == len(set(rows)) == 288
    assert np.asarray(rows).shape == (288, 6)
