"""The port's device simulation with dedup="shared" on the CPU, held against
the JAX package's DeviceSimulation with insert_variant="pallas" (interpret
mode; tests/test_device_simulation.py:117, :271, :298, :357): every walk
state goes through the visited-set insert, whose lowest-lane election is
the JAX kernel's, so the dedup hits, stale cuts, coverage and witnesses are
bit-identical. Also the checkpoint of the rounds loop, both ways between
the packages (and a JAX file of its default "capped" layout, which the port
loads slot for slot on "capped"), and the builder's two spawns. Exact comparisons throughout;
only the wall-clock rate `walks_per_sec` is left out."""

import pytest

from stateright_tpu.core.discovery import HasDiscoveries as JaxHasDiscoveries
from stateright_tpu.tensor import models as jm
from stateright_tpu.tensor.simulation import DeviceSimulation as JaxSimulation
from stateright_tpu_torch import HasDiscoveries
from stateright_tpu_torch.obs import validate_detail
from stateright_tpu_torch.tensor import models as pm
from stateright_tpu_torch.tensor.simulation import DeviceSimulation
from tests.test_torch_simulation import outcome

SHARED_2PC3 = dict(seed=5, traces=64, max_depth=64, dedup="shared", table_log2=14,
                   walks=512, stale_limit=4)


def test_shared_dedup_matches_the_jax_engine():
    jsim = JaxSimulation(jm.TensorTwoPhaseSys(3), insert_variant="pallas", **SHARED_2PC3)
    sim = DeviceSimulation(pm.TensorTwoPhaseSys(3), device="cpu", **SHARED_2PC3)
    r = sim.run()
    # The JAX engine's numbers for this configuration.
    assert (r.state_count, r.unique_state_count) == (2_253, 126)
    assert sim._totals["walks"] == 532 and sim._totals["dedup_hits"] == 2_127
    assert set(r.discoveries) == {"abort agreement"}
    assert r.detail["telemetry"]["stale_restarts"] > 0
    assert validate_detail(r.detail) == []
    assert outcome(r) == outcome(jsim.run())
    assert sim._discoveries == jsim._discoveries
    # A second round dedups against the same table.
    r2, jr2 = sim.run(), jsim.run()
    assert outcome(r2) == outcome(jr2) and r2.unique_state_count <= 288
    assert sim.table.dump() == jsim.table.dump()  # slot for slot: same keys, parents


def test_raft_simulation_agrees_and_replays():
    kw = dict(seed=1, traces=64, max_depth=64, dedup="shared", table_log2=14, walks=512)
    jsim = JaxSimulation(jm.TensorRaft(3, max_term=3), insert_variant="pallas", **kw)
    sim = DeviceSimulation(pm.TensorRaft(3, max_term=3), device="cpu", **kw)
    for _ in range(3):
        r, jr = sim.run(), jsim.run()
        assert outcome(r) == outcome(jr)
    assert sim._discoveries == jsim._discoveries
    assert "election safety" not in r.discoveries
    assert {"can elect", "leader elected"} <= set(r.discoveries)
    assert r.unique_state_count <= 601
    path = sim.discovery_path("can elect")
    assert "L" in str(path.states()[-1])


def _lin(m):
    return m.TensorLinearEquation(2, 10, 14)


CKPT_KW = dict(seed=9, traces=32, max_depth=64, dedup="shared", table_log2=14, walks=128)


def test_checkpoint_resume_bit_identical(tmp_path):
    straight = DeviceSimulation(_lin(pm), device="cpu", **CKPT_KW)
    straight.run()
    straight.checkpoint(str(tmp_path / "sim.npz"))
    r2 = straight.run()
    resumed = DeviceSimulation.load_checkpoint(_lin(pm), str(tmp_path / "sim.npz"),
                                               device="cpu")
    assert outcome(resumed.run()) == outcome(r2)
    assert resumed._discoveries == straight._discoveries
    assert resumed.table.dump() == straight.table.dump()


@pytest.mark.parametrize("variant", ["pallas", "capped"])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, variant):
    jsim = JaxSimulation(_lin(jm), insert_variant=variant, **CKPT_KW)
    jsim.run()
    ckpt = str(tmp_path / f"jax-{variant}.npz")
    jsim.checkpoint(ckpt)
    jr2 = jsim.run()
    sim = DeviceSimulation.load_checkpoint(_lin(pm), ckpt, device="cpu")
    assert outcome(sim.run()) == outcome(jr2)
    assert sim._discoveries == jsim._discoveries


def test_port_checkpoint_resumes_in_the_jax_engine(tmp_path):
    sim = DeviceSimulation(pm.TensorTwoPhaseSys(3), device="cpu", **SHARED_2PC3)
    sim.run()
    ckpt = str(tmp_path / "port.npz")
    sim.checkpoint(ckpt)
    r2 = sim.run()
    jsim = JaxSimulation.load_checkpoint(jm.TensorTwoPhaseSys(3), ckpt)
    assert jsim.insert_variant == "pallas"
    assert outcome(jsim.run()) == outcome(r2)
    assert jsim._discoveries == sim._discoveries


def test_spawn_simulation_device_and_spawn_cuda_mode():
    jc = (jm.TensorLinearEquation(2, 10, 14).checker().finish_when(JaxHasDiscoveries.ANY)
          .target_state_count(100_000)
          .spawn_tpu(mode="simulation", traces=64, max_depth=64, dedup="shared",
                     table_log2=14, insert_variant="pallas").join())
    c = (pm.TensorLinearEquation(2, 10, 14).checker().finish_when(HasDiscoveries.ANY)
         .target_state_count(100_000)
         .spawn_cuda(mode="simulation", traces=64, max_depth=64, dedup="shared",
                     table_log2=14, device="cpu").join())
    assert "solvable" in c.discoveries()
    assert (c.state_count(), c.unique_state_count(), c.max_depth()) == (
        jc.state_count(), jc.unique_state_count(), jc.max_depth())
    assert c.table_fill() == jc.table_fill() > 0
    tel = c.telemetry_summary()
    assert tel["steps"] > 0 and tel["generated_total"] > 0
    assert [p.actions() for p in c.discoveries().values()] == [
        p.actions() for p in jc.discoveries().values()]
    # spawn_simulation with a device string is the same engine.
    c2 = (pm.TensorTwoPhaseSys(3).checker().target_state_count(2_000)
          .spawn_simulation(device="cpu", **SHARED_2PC3).join())
    assert (c2.state_count(), c2.unique_state_count()) == (2_253, 126)

    with pytest.raises(ValueError):
        pm.TensorTwoPhaseSys(3).checker().spawn_cuda(mode="montecarlo")
    with pytest.raises(TypeError):
        # device knobs without a device are refused, not ignored
        pm.TensorTwoPhaseSys(3).checker().spawn_simulation(dedup="shared")
    # device=False is the host walker, over host models: a tensor model
    # goes behind it through as_host_model, its expands on the adapter's
    # device.
    from stateright_tpu_torch.checker.simulation import SimulationChecker
    from stateright_tpu_torch.tensor import as_host_model

    h = (as_host_model(pm.TensorTwoPhaseSys(3), device="cpu").checker()
         .target_state_count(200).spawn_simulation(5).join())
    assert isinstance(h, SimulationChecker) and h.state_count() >= 200
