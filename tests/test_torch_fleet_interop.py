"""The port's foreground fleet held against the JAX package's fleet under
the same FaultPlan, and the fleet's files read across the two packages.

Both fleets run the same submissions on the CPU (the port's services with
device="cpu", the JAX services with insert_variant="pallas" in interpret
mode), foreground, so every routing decision is deterministic:

- a crash, steals, requeues and resumes from checkpoint generations, with
  journals on;
- a partitioned replica declared dead, its lease revoked after an
  injected revoke race, the zombie fenced on its next checkpoint write.

Per job: counts, max depth, discoveries, requeues and steals; for the
fleet: its `stats()` counters and replica rows (but the wall-clock
admission waits); and the journals, event for event (but wall clocks,
pids and trace ids). Then the files: lease records, fenced checkpoint
generations, `fleet_snapshot` checkpoints (resumed in the other package's
service) and event journals written by either package are read by the
other. Every comparison is exact."""

import os

import numpy as np
import pytest

import stateright_tpu.faults as jax_faults
import stateright_tpu.service as jax_service
import stateright_tpu.tensor.models as jax_models
import stateright_tpu_torch.faults as port_faults
import stateright_tpu_torch.service as port_service
import stateright_tpu_torch.tensor.models as port_models
from stateright_tpu.faults import ckptio as jax_ckptio
from stateright_tpu.obs import timeline as jax_tl
from stateright_tpu.service.lease import LeaseStore as JaxLeaseStore
from stateright_tpu.service.queue import JobResume as JaxJobResume
from stateright_tpu_torch.faults import ckptio as port_ckptio
from stateright_tpu_torch.obs import timeline as port_tl
from stateright_tpu_torch.service.lease import LeaseStore as PortLeaseStore
from stateright_tpu_torch.service.queue import JobResume as PortJobResume

GOLD_2PC3 = (1_146, 288)
SIDES = {
    "port": (port_service, port_faults, port_models, dict(device="cpu")),
    "jax": (jax_service, jax_faults, jax_models, dict(insert_variant="pallas")),
}
SVC = dict(batch_size=128, table_log2=14)
# Wall-clock fields: the only ones allowed to differ.
CLOCKS = ("ts", "pid", "trace", "traces", "adm_p99_ms", "drift")


def _crash(side, tmp):
    svc, faults, models, kw = SIDES[side]
    m3, mi = models.TensorTwoPhaseSys(3), models.TensorIncrementLock(4)
    fleet = svc.ServiceFleet(n_replicas=3, background=False, max_resident=1,
                             service_kwargs=dict(SVC, **kw),
                             journal_dir=os.path.join(tmp, side, "journal"))
    handles = [fleet.submit(m) for m in (m3, m3, mi, m3, mi)]
    victim = sorted({h._job.replica for h in handles})[0]
    plan = faults.FaultPlan().rule("fleet.replica_crash", "crash", after=6,
                                   match={"replica": victim})
    with faults.active(plan):
        fleet.drain(timeout=600)
    return fleet, handles, plan


def _zombie(side, tmp):
    svc, faults, models, kw = SIDES[side]
    m3 = models.TensorTwoPhaseSys(3)
    fleet = svc.ServiceFleet(n_replicas=2, background=False, max_resident=1,
                             service_kwargs=dict(SVC, **kw),
                             lease_dir=os.path.join(tmp, side, "leases"),
                             journal_dir=os.path.join(tmp, side, "journal"),
                             router_kwargs=dict(steal=False, unhealthy_after=2))
    handles = [fleet.submit(m3) for _ in range(4)]
    victim = handles[0]._job.replica
    for _ in range(3):
        fleet.pump(1)
    plan = (faults.FaultPlan()
            .rule("fleet.partition", "io", times=-1, match={"replica": victim})
            .rule("lease.revoke_race", "io", times=1))
    with faults.active(plan):
        fleet.drain(timeout=600)
    return fleet, handles, plan


def _strip(x):
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in CLOCKS}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


def _outcome(side, scenario, tmp):
    fleet, handles, plan = scenario(side, tmp)
    try:
        jobs = []
        for h in handles:
            r = h.result()
            jobs.append((r.state_count, r.unique_state_count, r.max_depth, r.complete,
                         r.discoveries, h._job.requeues, h._job.steals, h._job.replica))
        stats = _strip(fleet.stats())
        injected = dict(plan.injected)
    finally:
        fleet.close()
    jd = os.path.join(tmp, side, "journal")
    journals = {n: _strip(jax_tl.load_events([os.path.join(jd, n)]))
                for n in sorted(os.listdir(jd))}
    return jobs, stats, injected, journals


@pytest.mark.parametrize("scenario", [_crash, _zombie], ids=["crash", "zombie"])
def test_port_fleet_equals_the_jax_fleet(scenario, tmp_path, monkeypatch):
    # The JAX services' calibration comparator journals wall-clock drift
    # events; the port has none yet (ROADMAP A15).
    monkeypatch.setenv("SR_TPU_CALIB", "0")
    port = _outcome("port", scenario, str(tmp_path))
    ref = _outcome("jax", scenario, str(tmp_path))
    jobs, stats, injected, journals = port
    for job in jobs:
        assert job[:2] in (GOLD_2PC3, (257, 257)) and job[3]
    assert stats["replica_crashes"] == 1 and stats["requeued_jobs"] >= 1
    if scenario is _crash:
        assert stats["steals"] >= 1 and stats["restored_jobs"] >= 1
    else:
        assert stats["lease_revokes"] == 1 and stats["lease_rejected"] >= 1
    assert jobs == ref[0]
    assert stats == ref[1]
    assert injected == ref[2]
    assert journals.keys() == ref[3].keys()
    for name in journals:
        assert journals[name] == ref[3][name], name
    # Each package's timeline reads the other's journals to the same report.
    for side in ("port", "jax"):
        jd = os.path.join(str(tmp_path), side, "journal")
        ours, theirs = port_tl.load_events([jd]), jax_tl.load_events([jd])
        assert ours == theirs
        assert port_tl.find_anomalies(port_tl.group_traces(ours)[0]) == []
        assert port_tl.fence_events(ours) == jax_tl.fence_events(theirs)


# -- files across the packages ------------------------------------------------------


def test_lease_records_are_byte_identical_and_read_both_ways(tmp_path):
    ps, js = PortLeaseStore(str(tmp_path / "p")), JaxLeaseStore(str(tmp_path / "j"))
    try:
        for store in (ps, js):
            store.grant("replica0")
            store.grant("replica0")
            store.revoke("replica0")
        for suffix in ("", ".prev"):
            with open(ps.path_for("replica0") + suffix, "rb") as a, \
                    open(js.path_for("replica0") + suffix, "rb") as b:
                assert a.read() == b.read()
        # A port store over the JAX directory and the reverse.
        p_over_j, j_over_p = PortLeaseStore(js.root), JaxLeaseStore(ps.root)
        assert p_over_j.state("replica0") == j_over_p.state("replica0") == (2, "revoked")
        lease = j_over_p.grant("replica0")  # the JAX store grants epoch 3 ...
        assert p_over_j.validate("replica0", 1) is False
        assert PortLeaseStore(ps.root).validate("replica0", lease.epoch)  # ... the port reads it
        p_over_j.close()
        j_over_p.close()
    finally:
        ps.close()
        js.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_fenced_generations_read_across_packages(writer, tmp_path):
    w_store = (PortLeaseStore if writer == "port" else JaxLeaseStore)(str(tmp_path / "leases"))
    r_store = (JaxLeaseStore if writer == "port" else PortLeaseStore)(str(tmp_path / "leases"))
    w_io, r_io = ((port_ckptio, jax_ckptio) if writer == "port" else (jax_ckptio, port_ckptio))
    w_faults = port_faults if writer == "port" else jax_faults
    try:
        router, l0 = w_store.grant("router"), w_store.grant("replica0")
        path = str(tmp_path / "fleetjob1.npz")
        w_io.fenced_savez(path, {"gen": np.asarray([1])}, lease=l0)
        data, src = r_io.fenced_load_latest(path, validator=r_store.validate)
        assert r_io.lease_stamp(data) == ("replica0", 1) and int(data["gen"][0]) == 1
        w_store.revoke("replica0")
        data, _ = r_io.fenced_load_latest(path)  # the router's CRC-only load
        arrays = {k: data[k] for k in data.files if k not in r_io.LEASE_STAMP_KEYS}
        w_io.fenced_savez(path, arrays, lease=router)  # the re-seal
        with w_faults.active(w_faults.FaultPlan().rule("fleet.zombie_write", "bypass")):
            w_io.fenced_savez(path, {"gen": np.asarray([666])}, lease=l0)
        rejected = []
        data, src = r_io.fenced_load_latest(path, validator=r_store.validate,
                                            on_reject=lambda *a: rejected.append(a[1:]))
        assert src.endswith(".prev") and int(data["gen"][0]) == 1
        assert rejected == [("replica0", 1)]
        assert r_io.lease_stamp(data) == ("router", 1)
    finally:
        w_store.close()
        r_store.close()


def _snapshot(side, rounds):
    svc, _faults, models, kw = SIDES[side]
    s = svc.CheckService(background=False, **SVC, **kw)
    m3 = models.TensorTwoPhaseSys(3)
    s.submit(m3)  # another job in the table
    h = s.submit(m3, journal=True)
    s.pump(rounds)
    snap = h._job.fleet_snapshot()
    s.close()
    return snap


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_fleet_snapshot_resumes_in_the_other_package(writer, tmp_path):
    port_snap, jax_snap = _snapshot("port", 3), _snapshot("jax", 3)
    assert port_snap.keys() == jax_snap.keys()
    for k in port_snap:
        assert port_snap[k].dtype == jax_snap[k].dtype, k
        np.testing.assert_array_equal(port_snap[k], jax_snap[k], err_msg=k)
    assert len(port_snap["j_lo"]) > 0 and len(port_snap["q_lo"]) > 0
    path = str(tmp_path / "fleetjob.npz")
    w_io = port_ckptio if writer == "port" else jax_ckptio
    w_io.fenced_savez(path, port_snap if writer == "port" else jax_snap)
    reader = "jax" if writer == "port" else "port"
    r_io = jax_ckptio if reader == "jax" else port_ckptio
    data, _src = r_io.fenced_load_latest(path)
    rz = (JaxJobResume if reader == "jax" else PortJobResume).from_npz(data)
    svc, _faults, models, kw = SIDES[reader]
    s = svc.CheckService(background=False, **SVC, **kw)
    m3 = models.TensorTwoPhaseSys(3)
    try:
        h0 = s.submit(m3)
        h = s.submit(m3, resume=rz)
        s.drain(timeout=300)
        r, r0 = h.result(), h0.result()
    finally:
        s.close()
    assert (r.state_count, r.unique_state_count) == GOLD_2PC3 and r.complete
    assert (r.max_depth, r.discoveries) == (r0.max_depth, r0.discoveries)


def _tiered_resume(side):
    svc, faults, models, kw = SIDES[side]
    if side == "jax":
        kw = dict(insert_variant="sort")  # its pallas form aborts at 2^11 (ROADMAP C)
    m4 = models.TensorTwoPhaseSys(4)
    fleet = svc.ServiceFleet(n_replicas=2, background=False,
                             service_kwargs=dict(batch_size=32, table_log2=11, store="tiered",
                                                 summary_log2=14, **kw))
    try:
        hs = [fleet.submit(m4) for _ in range(2)]
        victim = hs[0]._job.replica
        store = fleet.replicas[victim].service._engine._store
        while store.spill_events == 0:
            assert fleet.pump(1), "the tiered replica finished without a spill"
        plan = faults.FaultPlan().rule("fleet.replica_crash", "crash", times=1,
                                       match={"replica": victim})
        with faults.active(plan):
            fleet.drain(timeout=600)
        survivor = fleet.replicas[1 - victim].service._engine
        jobs = [(r.state_count, r.unique_state_count, r.max_depth, r.complete, r.discoveries)
                for r in (h.result() for h in hs)]
        s = fleet.stats()
        return (jobs, {k: s[k] for k in ("replica_crashes", "requeued_jobs", "restored_jobs")},
                survivor._store.spill_events)
    finally:
        fleet.close()


def test_tiered_fleet_resume_equals_the_jax_fleet():
    """Two 2pc-4 jobs on a 2^11-slot tiered replica, crashed after its first
    spill: the survivor re-seeds journals that hold every claim, the evicted
    ones too, evicting between batches (the port) so its hot tier holds."""
    port, ref = _tiered_resume("port"), _tiered_resume("jax")
    jobs, stats, spills = port
    assert all(j[:2] == (8_258, 1_568) and j[3] for j in jobs)
    assert stats == {"replica_crashes": 1, "requeued_jobs": 2, "restored_jobs": 2}
    assert spills >= 1
    assert (jobs, stats) == ref[:2]


def test_local_blob_store_and_corruption_probes_match_jax(tmp_path):
    from stateright_tpu.faults import blobstore as jax_blob
    from stateright_tpu_torch.faults import blobstore as port_blob

    listings = []
    for mod, d in ((port_blob, "p"), (jax_blob, "j")):
        (tmp_path / d).mkdir()
        store = mod.blob_backend("file://" + str(tmp_path / d))
        assert mod.backend_of(str(tmp_path / d)) == "file"
        assert store.put("a", b"one") == 1 and store.put("a", b"two") == 1  # rotates
        assert store.put("a", b"three", if_absent=True) is None
        assert store.get("a") == b"two" and store.get("a.prev") == b"one"
        assert store.exists("a") and store.delete("a.prev") and not store.exists("a.prev")
        listings.append([(b.name, b.size) for b in store.list()])
    assert listings[0] == listings[1] == [("a", 3)]
    for seed in (0, 1):
        data = bytes(range(200))
        assert port_ckptio._corrupt_payload(data, seed) == jax_ckptio._corrupt_payload(data, seed)
    path = str(tmp_path / "gen.npz")
    assert not port_ckptio.any_generation(path)
    port_ckptio.atomic_savez(path, {"gen": np.asarray([1])})
    jax_ckptio.atomic_savez(path, {"gen": np.asarray([2])})  # 1 moves to .prev
    assert port_ckptio.any_generation(path)
    port_ckptio.corrupt_one_byte(path)
    for io in (port_ckptio, jax_ckptio):
        data, src = io.load_latest(path)
        assert src.endswith(".prev") and int(data["gen"][0]) == 1
        assert io.latest_generation(path) == path + ".prev"
