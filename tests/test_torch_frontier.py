"""The port's host-driven engine (stateright_tpu_torch/tensor/frontier.py::
FrontierSearch) on the CPU, held against the JAX package's FrontierSearch
with insert_variant="pallas" (interpret mode): the same counts, depths,
steps, discovery fingerprints and witness action lists on 2pc-3, 2pc-5,
LinearEquation and Raft-3, the early exits, and the frontier telemetry
ring (mirrors of tests/test_obs.py:136, :159). Every comparison is exact
(integers and fingerprints)."""

import pytest

from stateright_tpu.core.discovery import HasDiscoveries as JaxHasDiscoveries
from stateright_tpu.tensor import models as jm
from stateright_tpu.tensor.frontier import FrontierSearch as JaxFrontier
from stateright_tpu_torch import HasDiscoveries
from stateright_tpu_torch.obs import validate_detail
from stateright_tpu_torch.tensor import models as pm
from stateright_tpu_torch.tensor.frontier import FrontierSearch

CASES = {
    # name: (model builder, batch, table_log2, golden (generated, unique) or None)
    "2pc-3": (lambda m: m.TensorTwoPhaseSys(3), 64, 12, (1_146, 288)),
    "2pc-5": (lambda m: m.TensorTwoPhaseSys(5), 2048, 16, (58_146, 8_832)),
    "linear-equation(2,10,14)": (lambda m: m.TensorLinearEquation(2, 10, 14), 64, 14, None),
    "raft-3": (lambda m: m.TensorRaft(3, max_term=3), 1024, 14, (2_050, 601)),
}


def _outcome(r):
    return (r.state_count, r.unique_state_count, r.max_depth, r.steps, r.complete,
            r.discoveries)


def _witnesses(fs, r) -> dict:
    return {name: fs.reconstruct_path(fp).actions() for name, fp in r.discoveries.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_the_jax_engine(name):
    build, K, T, golden = CASES[name]
    jfs = JaxFrontier(build(jm), K, T, insert_variant="pallas")
    jr = jfs.run()
    fs = FrontierSearch(build(pm), K, T, device="cpu")
    r = fs.run()
    if golden is not None:
        assert (r.state_count, r.unique_state_count) == golden
    assert _outcome(r) == _outcome(jr)
    assert r.discoveries  # every case discovers something: witnesses compared
    assert _witnesses(fs, r) == _witnesses(jfs, jr)


def test_raft_verdicts():
    r = FrontierSearch(pm.TensorRaft(3, max_term=3), 1024, 14, device="cpu").run()
    assert r.complete
    assert "election safety" not in r.discoveries
    assert {"leader elected", "can elect"} <= set(r.discoveries)


def test_linear_equation_golden():
    # The JAX package's 65,536-state anchor (2 actions, 511 levels).
    r = FrontierSearch(pm.TensorLinearEquation(2, 4, 7), 4096, 18, device="cpu").run()
    assert (r.state_count, r.unique_state_count, r.complete) == (131_073, 65_536, True)
    assert r.discoveries == {}


def test_early_exit_matches_the_jax_engine():
    jfs = JaxFrontier(jm.TensorTwoPhaseSys(3), 64, 12, insert_variant="pallas")
    jr = jfs.run(finish_when=JaxHasDiscoveries.ANY)
    fs = FrontierSearch(pm.TensorTwoPhaseSys(3), 64, 12, device="cpu")
    r = fs.run(finish_when=HasDiscoveries.ANY)
    assert r.discoveries and not r.complete
    assert _outcome(r) == _outcome(jr)
    assert _witnesses(fs, r) == _witnesses(jfs, jr)
    # The exiting step's contribution is discarded; telemetry counts the
    # step as uncaptured, so its steps reconcile with the result's.
    t = r.detail["telemetry"]
    assert t["steps"] == r.steps and t["dropped_steps"] == 1
    assert {k: v for k, v in t.items() if k != "step_us"} == {
        k: v for k, v in jr.detail["telemetry"].items() if k != "step_us"}


def test_target_state_count_and_depth_match_the_jax_engine():
    for kw in (dict(target_state_count=500), dict(target_max_depth=5)):
        jr = JaxFrontier(jm.TensorTwoPhaseSys(3), 64, 12, insert_variant="pallas").run(**kw)
        r = FrontierSearch(pm.TensorTwoPhaseSys(3), 64, 12, device="cpu").run(**kw)
        assert _outcome(r) == _outcome(jr), kw


def test_frontier_ring_totals_match_golden():
    fs = FrontierSearch(pm.TensorTwoPhaseSys(3), 256, 12, device="cpu")
    r = fs.run()
    assert (r.state_count, r.unique_state_count) == (1_146, 288)
    t = r.detail["telemetry"]
    assert t["dropped_steps"] == 0 and t["steps"] == r.steps
    assert t["generated_total"] == r.state_count - 1
    assert t["claimed_total"] == r.unique_state_count - 1
    assert t["step_us"]["max"] > 0
    assert validate_detail(r.detail) == []
    m = fs.metrics()
    assert m["steps"] == r.steps and 0 < m["table_fill"] < 1


def test_progress_and_telemetry_off():
    seen = []
    fs = FrontierSearch(pm.TensorTwoPhaseSys(3), 64, 12, telemetry=False, device="cpu")
    r = fs.run(progress=lambda sc, uc, md: seen.append((sc, uc, md)))
    assert r.detail is None and fs.telemetry_summary() is None
    assert seen[-1][:2] == (1_146, 288)
    assert all(a <= b for a, b in zip(seen, seen[1:]))
