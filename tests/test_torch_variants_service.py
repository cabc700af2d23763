"""The XLA insert designs on the shared tables of the port's device
simulation and check service, held against the JAX package on the same
variant (CPU): `DeviceSimulation` with shared dedup through each design
(the same walks, totals, discoveries and table slot for slot) and its
"capped" checkpoint crossing both ways slot for slot; `CheckService`
through "sort" and "capped", on the device and the tiered store, against
the JAX service running the same submissions: per job (counts, depth,
steps, discoveries), the event journal event for event (but wall clocks,
pids and trace ids), the store's counters and the shared table slot for
slot. Every comparison is exact."""

import os

import numpy as np
import pytest

from stateright_tpu.obs import timeline as jax_tl
from stateright_tpu.service import CheckService as JaxService
from stateright_tpu.tensor import models as jm
from stateright_tpu.tensor.simulation import DeviceSimulation as JaxSimulation
from stateright_tpu_torch.service import CheckService
from stateright_tpu_torch.tensor import models as pm
from stateright_tpu_torch.tensor.pallas_hashtable import to_jax_table
from stateright_tpu_torch.tensor.simulation import DeviceSimulation
from tests.test_torch_simulation import outcome
from tests.test_torch_simulation_shared import SHARED_2PC3

DESIGNS = ["sort", "phased", "capped", "capped-phased"]
CLOCKS = ("ts", "pid", "trace", "traces", "adm_p99_ms", "drift")


def _jax_table(t):
    return [np.asarray(a) for a in (t.t_lo, t.t_hi, t.p_lo, t.p_hi)]


def _assert_table(t_key, t_parent, arrays):
    for ours, theirs in zip(to_jax_table(t_key, t_parent), arrays):
        np.testing.assert_array_equal(ours, theirs)


# -- the device simulation ---------------------------------------------------------------


@pytest.mark.parametrize("variant", DESIGNS)
def test_shared_simulation_through_each_design_equals_jax(variant):
    jsim = JaxSimulation(jm.TensorTwoPhaseSys(3), insert_variant=variant, **SHARED_2PC3)
    sim = DeviceSimulation(pm.TensorTwoPhaseSys(3), insert_variant=variant, device="cpu",
                           **SHARED_2PC3)
    for _ in range(2):  # two rounds on the one shared table
        assert outcome(sim.run()) == outcome(jsim.run())
    assert sim._discoveries == jsim._discoveries
    assert {k: v for k, v in sim._totals.items() if k != "duration"} == {
        k: v for k, v in jsim._totals.items() if k != "duration"}
    _assert_table(sim.table.t_key, sim.table.t_parent, _jax_table(jsim.table))
    assert sim.table.dump() == jsim.table.dump()


def test_capped_simulation_checkpoint_crosses_both_ways(tmp_path):
    kw = dict(SHARED_2PC3, insert_variant="capped")
    sim = DeviceSimulation(pm.TensorTwoPhaseSys(3), device="cpu", **kw)
    jsim = JaxSimulation(jm.TensorTwoPhaseSys(3), **kw)
    sim.run()
    jsim.run()
    port_ckpt, jax_ckpt = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    sim.checkpoint(port_ckpt)
    jsim.checkpoint(jax_ckpt)
    into_jax = JaxSimulation.load_checkpoint(jm.TensorTwoPhaseSys(3), port_ckpt)
    into_port = DeviceSimulation.load_checkpoint(pm.TensorTwoPhaseSys(3), jax_ckpt, device="cpu")
    assert into_jax.insert_variant == into_port.insert_variant == "capped"
    data = np.load(jax_ckpt)
    _assert_table(into_port.table.t_key, into_port.table.t_parent,
                  [data[k] for k in ("t_lo", "t_hi", "p_lo", "p_hi")])
    pdata = np.load(port_ckpt)
    for k in ("t_lo", "t_hi", "p_lo", "p_hi"):
        np.testing.assert_array_equal(pdata[k], data[k])
    want = jsim.run()
    for eng in (into_jax, into_port):
        assert outcome(eng.run()) == outcome(want)
    _assert_table(into_port.table.t_key, into_port.table.t_parent, _jax_table(jsim.table))


# -- the check service --------------------------------------------------------------------


def _strip(x):
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in CLOCKS}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


def _serve(side, variant, store, tmp):
    """Three jobs of two models on a foreground service, one submitted
    after the first step: per job results, the journal, the store's
    counters and the table."""
    svc_cls, models, kw = ((CheckService, pm, dict(device="cpu")) if side == "port"
                           else (JaxService, jm, {}))
    path = os.path.join(tmp, f"{side}-{variant}-{store}.jsonl")
    sizes = (dict(batch_size=32, table_log2=11, store="tiered", high_water=0.6,
                  summary_log2=14) if store == "tiered" else dict(batch_size=64, table_log2=14))
    svc = svc_cls(insert_variant=variant, background=False, events_out=path, **sizes, **kw)
    m3, m4 = models.TensorTwoPhaseSys(3), models.TensorTwoPhaseSys(4)
    try:
        hs = [svc.submit(m4), svc.submit(m3)]
        svc.pump(1)
        hs.append(svc.submit(m4))
        svc.drain(timeout=300)
        jobs = [(r.state_count, r.unique_state_count, r.max_depth, r.steps, r.complete,
                 r.discoveries) for r in (h.result() for h in hs)]
        eng = svc._engine
        stats = eng._store.stats(eng.hot_claims) if store == "tiered" else None
        table = (to_jax_table(eng.table.t_key, eng.table.t_parent) if side == "port"
                 else _jax_table(eng.table))
        steps = svc.stats()["device_steps"]
    finally:
        svc.close()
    return jobs, _strip(jax_tl.load_events([path])), stats, table, steps


@pytest.mark.parametrize("store", ["device", "tiered"])
@pytest.mark.parametrize("variant", ["sort", "capped"])
def test_check_service_through_a_design_equals_jax(variant, store, tmp_path, monkeypatch):
    # The JAX service's calibration comparator journals wall-clock drift
    # events (SR_TPU_CALIB=0 turns it off; the port's results stay equal).
    monkeypatch.setenv("SR_TPU_CALIB", "0")
    port = _serve("port", variant, store, str(tmp_path))
    ref = _serve("jax", variant, store, str(tmp_path))
    jobs, events, stats, table, steps = port
    for job in jobs:
        assert job[:2] in ((1146, 288), (8258, 1568)) and job[4]
    assert jobs == ref[0] and steps == ref[4]
    assert events == ref[1]
    if store == "tiered":
        assert stats["spill_events"] >= 1 and stats["partition_spills"] == 0
        for k in ("spilled_states", "spill_events", "suspects_checked", "suspects_dup"):
            assert stats[k] == ref[2][k], k
    for ours, theirs in zip(table, ref[3]):
        np.testing.assert_array_equal(ours, theirs)
