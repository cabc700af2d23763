"""The port's device simulation (stateright_tpu_torch/tensor/simulation.py)
on the CPU with dedup="trace", held against the JAX package's
DeviceSimulation on the same configurations (tests/test_device_simulation.py
:19, :38, :55, :68, :79, :94, :197, :217): the same walks, round after
round, so bit-identical totals, walk counts, telemetry, discoveries and
witness fingerprint paths, with `continuous` on and off. The draws are the
port's threefry twin of `jax.random` (tests/test_torch_prng.py). Every
comparison is exact; only the wall-clock rate `walks_per_sec` is left out."""

import jax.numpy as jnp
import pytest
import torch

from stateright_tpu.core.discovery import HasDiscoveries as JaxHasDiscoveries
from stateright_tpu.tensor import models as jm
from stateright_tpu.tensor.model import TensorModel as JaxTensorModel
from stateright_tpu.tensor.model import TensorProperty as JaxTensorProperty
from stateright_tpu.tensor.simulation import DeviceSimulation as JaxSimulation
from stateright_tpu_torch import HasDiscoveries
from stateright_tpu_torch.obs import validate_detail
from stateright_tpu_torch.tensor import models as pm
from stateright_tpu_torch.tensor.model import TensorModel, TensorProperty
from stateright_tpu_torch.tensor.simulation import DeviceSimulation
from tests.test_device_simulation import BoundedCounter as JaxBoundedCounter
from tests.test_tensor_checker import CounterModel as JaxCounterModel


class CounterModel(TensorModel):
    """tests/test_tensor_checker.py's CounterModel in torch: 0..max,
    terminal at max."""

    lanes = 1
    max_actions = 1

    def __init__(self, max_value):
        self.max_value = max_value

    def init_states(self):
        return torch.zeros((1, 1), dtype=torch.int64)

    def expand(self, states):
        return (states + 1)[:, None, :], (states[:, 0] < self.max_value)[:, None]

    def properties(self):
        return [
            TensorProperty.eventually("reaches odd", lambda m, s: s[:, 0] % 2 == 1),
            TensorProperty.eventually("exceeds max", lambda m, s: s[:, 0] > m.max_value),
        ]

    def decode(self, row):
        return int(row[0])


class BoundedCounter(TensorModel):
    """tests/test_device_simulation.py's BoundedCounter in torch: a walk
    exits the boundary instead of terminating."""

    lanes = 1
    max_actions = 1

    def __init__(self, bound):
        self.bound = bound

    def init_states(self):
        return torch.zeros((1, 1), dtype=torch.int64)

    def expand(self, states):
        return (states + 1)[:, None, :], torch.ones((states.shape[0], 1), dtype=torch.bool,
                                                    device=states.device)

    def within_boundary(self, states):
        return states[:, 0] <= self.bound

    def properties(self):
        return [TensorProperty.eventually("reaches ten", lambda m, s: s[:, 0] >= 10)]

    def decode(self, row):
        return int(row[0])


class Ring(TensorModel):
    """A counter mod 8 stepping +1 or +3: every walk closes a cycle, so the
    cycle check (the walk's path, or the shared mode's ring) decides how
    each walk ends."""

    lanes = 1
    max_actions = 2

    def init_states(self):
        return torch.zeros((1, 1), dtype=torch.int64)

    def expand(self, states):
        succ = torch.stack([(states + 1) % 8, (states + 3) % 8], dim=1)
        return succ, torch.ones((states.shape[0], 2), dtype=torch.bool, device=states.device)

    def properties(self):
        return [
            TensorProperty.sometimes("seven", lambda m, s: s[:, 0] == 7),
            TensorProperty.eventually("past a hundred", lambda m, s: s[:, 0] > 100),
        ]

    def decode(self, row):
        return int(row[0])


class JaxRing(JaxTensorModel):
    """Ring in JAX."""

    lanes = 1
    max_actions = 2

    def init_states(self):
        return jnp.zeros((1, 1), dtype=jnp.uint32)

    def expand(self, states):
        succ = jnp.stack([(states + 1) % 8, (states + 3) % 8], axis=1)
        return succ.astype(jnp.uint32), jnp.ones((states.shape[0], 2), dtype=bool)

    def properties(self):
        return [
            JaxTensorProperty.sometimes("seven", lambda m, s: s[:, 0] == 7),
            JaxTensorProperty.eventually("past a hundred", lambda m, s: s[:, 0] > 100),
        ]

    def decode(self, row):
        return int(row[0])


def outcome(r) -> tuple:
    tel = {k: v for k, v in (r.detail or {}).get("telemetry", {}).items()
           if k != "walks_per_sec"}
    return (r.state_count, r.unique_state_count, r.max_depth, r.steps, r.complete,
            r.discoveries, tel)


def run_both(jax_model, model, rounds=1, finish=("ALL", "ALL"), **kw):
    """Both engines round by round; every round's outcome must be equal.
    Returns the port's engine and its last result."""
    jsim = JaxSimulation(jax_model, insert_variant="pallas", **kw)
    sim = DeviceSimulation(model, device="cpu", **kw)
    jfinish = getattr(JaxHasDiscoveries, finish[0])
    pfinish = getattr(HasDiscoveries, finish[1])
    for _ in range(rounds):
        jr, r = jsim.run(finish_when=jfinish), sim.run(finish_when=pfinish)
        assert outcome(r) == outcome(jr)
        assert sim._discoveries == jsim._discoveries
        assert sim.metrics() == jsim.metrics()
    return sim, r


def test_finds_sometimes_example_and_is_reproducible():
    kw = dict(seed=7, traces=64, max_depth=64)
    sim, r = run_both(jm.TensorLinearEquation(2, 10, 14), pm.TensorLinearEquation(2, 10, 14),
                      rounds=4, **kw)
    assert "solvable" in r.discoveries
    again = DeviceSimulation(pm.TensorLinearEquation(2, 10, 14), device="cpu", **kw)
    for _ in range(4):
        r2 = again.run()
    assert outcome(r2) == outcome(r) and again._discoveries == sim._discoveries


def test_2pc_verdicts_match_the_jax_engine():
    # tests/test_device_simulation.py:38 and :217 (same config, 3 rounds).
    sim, r = run_both(jm.TensorTwoPhaseSys(3), pm.TensorTwoPhaseSys(3), rounds=3,
                      seed=3, traces=128, max_depth=64)
    assert "abort agreement" in r.discoveries
    assert "consistent" not in r.discoveries
    path = sim.discovery_path("abort agreement")
    assert len(path) == len(sim._discoveries["abort agreement"])


def test_eventually_counterexample_at_terminal_and_path():
    sim, r = run_both(JaxCounterModel(4), CounterModel(4), seed=0, traces=8, max_depth=32)
    assert "exceeds max" in r.discoveries and "reaches odd" not in r.discoveries
    assert sim.discovery_path("exceeds max").states() == [0, 1, 2, 3, 4]


def test_depth_cap_skips_eventually_check():
    _, r = run_both(JaxCounterModel(10), CounterModel(10), finish=("ANY", "ANY"),
                    seed=0, traces=4, max_depth=4)
    assert "exceeds max" not in r.discoveries


def test_no_global_dedup():
    _, r = run_both(jm.TensorTwoPhaseSys(3), pm.TensorTwoPhaseSys(3),
                    seed=1, traces=32, max_depth=32)
    assert r.unique_state_count == r.state_count and not r.complete
    assert validate_detail(r.detail) == []


def test_continuous_batching_on_and_off():
    _, r = run_both(jm.TensorTwoPhaseSys(3), pm.TensorTwoPhaseSys(3),
                    seed=3, traces=32, max_depth=64, walks=256)
    tel = r.detail["telemetry"]
    assert tel["walks"] >= 256 and tel["restarts"] > 0 and tel["lane_util"] == 1.0
    _, r_old = run_both(jm.TensorTwoPhaseSys(3), pm.TensorTwoPhaseSys(3), rounds=2,
                        seed=3, traces=32, max_depth=64, continuous=False)
    tel = r_old.detail["telemetry"]
    assert tel["walks"] <= 64 and tel["restarts"] == 0 and tel["lane_util"] < 1.0


def test_boundary_exit_records_pending_eventually_bits():
    sim, r = run_both(JaxBoundedCounter(4), BoundedCounter(4), seed=0, traces=4, max_depth=32)
    assert "reaches ten" in r.discoveries
    assert sim.discovery_path("reaches ten").states() == [0, 1, 2, 3, 4]
    _, r_ok = run_both(JaxBoundedCounter(12), BoundedCounter(12), seed=0, traces=4,
                       max_depth=32)
    assert "reaches ten" not in r_ok.discoveries


@pytest.mark.parametrize("kw", [
    dict(dedup="trace"),
    dict(dedup="trace", continuous=False),
    dict(dedup="shared", ring=3, table_log2=10),
    dict(dedup="shared", ring=64, table_log2=10, stale_limit=2),
], ids=["trace", "trace-lockstep", "shared-ring-3", "shared-stale"])
def test_cycles_end_walks_as_in_the_jax_engine(kw):
    # Every walk of the ring loops: the trace mode's path check, and the
    # shared mode's ring (period <= 3 caught, longer ones left to the depth
    # cap or the table's staleness) end them exactly where the JAX engine's
    # per-walk table and ring do; a loop records the pending eventually bit.
    sim, r = run_both(JaxRing(), Ring(), rounds=2, seed=11, traces=32, max_depth=16,
                      walks=96, **kw)
    assert r.detail["telemetry"]["walks"] > 0
    if kw.get("ring") == 3:
        # Most loops are longer than the ring: those walks end at the depth
        # cap, which records nothing.
        return
    assert "past a hundred" in r.discoveries
    path = sim.discovery_path("past a hundred")
    assert len(path) == len(sim._discoveries["past a hundred"])


def test_telemetry_off_and_knob_checks():
    sim = DeviceSimulation(pm.TensorTwoPhaseSys(3), traces=8, max_depth=16,
                           telemetry=False, device="cpu")
    assert sim.run().detail is None and sim.telemetry_summary() is None
    for kw, err in ((dict(dedup="global"), ValueError),
                    (dict(max_depth=512, cycle_log2=9), ValueError),
                    (dict(stale_limit=4), ValueError),
                    (dict(dedup="shared", salt=7), NotImplementedError)):
        try:
            DeviceSimulation(pm.TensorTwoPhaseSys(3), device="cpu", **kw)
        except err:
            continue
        raise AssertionError(f"{kw} was accepted")
