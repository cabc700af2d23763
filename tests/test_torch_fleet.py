"""The port's service fleet (stateright_tpu_torch/service/{router,fleet}.py)
on the CPU: the mirrors of the 17 tests of tests/test_fleet.py, a
background fleet through a crash, and the router's retire drain.

N CheckService replicas behind the consistent-hash router finish a mixed
job set at the single-replica goldens through a replica crash mid-run
(requeue and resume from fenced checkpoint generations), router
submission faults (bounded deterministic retry), load imbalance (idle
replicas steal queued jobs), a hung replica, a partitioned zombie fenced
by its revoked lease, and a rejoin. The ring and the job-level results
are also held against the JAX package's (`HashRing`, the goldens its
tests pin); tests/test_torch_fleet_interop.py holds whole fleet runs
against the JAX fleet.

Every fleet but one is foreground (pump()/drain(), no threads), the hang
mirror included: its probe hangs are parked and released by the plan's
own limit inside `pump()`, with no sleep."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from stateright_tpu.service.router import HashRing as JaxRing
from stateright_tpu_torch.faults import FaultPlan, active
from stateright_tpu_torch.service import CheckService, ServiceFleet, serve_fleet, serve_service
from stateright_tpu_torch.service.queue import AdmissionQueue, Job, JobStatus
from stateright_tpu_torch.service.router import FleetRouter, HashRing, lease_member
from stateright_tpu_torch.service.server import ModelRegistry
from stateright_tpu_torch.tensor.models import TensorIncrementLock, TensorTwoPhaseSys

GOLD_2PC3 = (1_146, 288)
GOLD_INCLOCK4 = (257, 257)

# Module-level model instances: jobs of one instance share a step.
M3 = TensorTwoPhaseSys(3)
MI = TensorIncrementLock(4)

SVC_KW = dict(batch_size=128, table_log2=14, device="cpu")


# -- consistent hashing ----------------------------------------------------------


def test_hash_ring_moves_only_the_dead_members_keys():
    ring, ref = HashRing([0, 1, 2]), JaxRing([0, 1, 2])
    keys = [f"model-{i}" for i in range(200)]
    before = {k: ring.lookup(k) for k in keys}
    assert before == {k: ref.lookup(k) for k in keys}
    assert set(before.values()) == {0, 1, 2}
    ring.remove(1)
    ref.remove(1)
    after = {k: ring.lookup(k) for k in keys}
    assert after == {k: ref.lookup(k) for k in keys}
    for k in keys:
        if before[k] != 1:
            assert after[k] == before[k]  # survivors keep their keys
        else:
            assert after[k] in (0, 2)


def test_hash_ring_preference_starts_at_owner_and_covers_all():
    ring, ref = HashRing([0, 1, 2]), JaxRing([0, 1, 2])
    for k in ("a", "b", "c", "paxos-2", "TensorTwoPhaseSys"):
        pref = ring.preference(k)
        assert pref == ref.preference(k)
        assert pref[0] == ring.lookup(k)
        assert sorted(pref) == [0, 1, 2]


def test_hash_ring_rejoin_reclaims_exactly_its_pre_death_keys():
    ring = HashRing([0, 1, 2])
    keys = [f"model-{i}" for i in range(200)]
    before = {k: ring.lookup(k) for k in keys}
    ring.remove(1)
    during = {k: ring.lookup(k) for k in keys}
    ring.add(1)  # the rejoin promotion
    after = {k: ring.lookup(k) for k in keys}
    assert after == before
    reclaimed = {k for k in keys if during[k] != after[k]}
    assert reclaimed == {k for k in keys if before[k] == 1}


# -- the queue under requeues ------------------------------------------------------


class _M:
    lanes = 2


def test_requeued_lanes_pop_exactly_once_in_original_order():
    job = Job(1, _M(), journal=True)
    n0 = 10
    states = np.arange(n0 * 2, dtype=np.int64).reshape(n0, 2)
    keys = np.arange(1, n0 + 1, dtype=np.int64) | (np.arange(100, 100 + n0) << 32)
    ebits = np.zeros((n0, 1), dtype=bool)
    depth = np.ones(n0, dtype=np.int64)
    job.push(states[:6], keys[:6], ebits[:6], depth[:6])
    job.push(states[6:], keys[6:], ebits[6:], depth[6:])
    t_states, t_keys, t_eb, t_dp = job.take(4)
    assert list(t_keys & 0xFFFFFFFF) == [1, 2, 3, 4]
    job.push_front(t_states, t_keys, t_eb, t_dp)  # a faulted step's unwind
    popped = []
    while job.pending_lanes:
        popped.extend(int(x) for x in job.take(3)[1] & 0xFFFFFFFF)
    assert popped == list(range(1, 11))


def test_admission_queue_priority_order_survives_requeue():
    q = AdmissionQueue()
    lowa, high, lowb = Job(1, _M(), priority=0), Job(2, _M(), priority=5), Job(3, _M())
    for j in (lowa, high, lowb):
        q.push(j)
    assert q.pop_next() is high
    high2 = Job(4, _M(), priority=5)
    q.push(high2)
    q.push(high)  # the requeue re-enters behind its priority's peers
    assert [q.pop_next().id for _ in range(4)] == [4, 2, 1, 3]


def test_admission_queue_inflight_jobs_survive_rejoin_exactly_once():
    dying, rejoined = AdmissionQueue(), AdmissionQueue()
    for i in range(1, 6):
        dying.push(Job(i, _M()))
    inflight = dying.pop_next()
    survivors = [inflight] + [dying.pop_next() for _ in range(len(dying))]
    assert dying.pop_next() is None
    for j in survivors:
        rejoined.push(j)
    stolen = [rejoined.jobs()[-1], rejoined.jobs()[-2]]
    assert all(rejoined.remove(j) for j in stolen)
    assert not rejoined.remove(stolen[0])
    thief = AdmissionQueue()
    for j in stolen:
        thief.push(j)
    popped = []
    while len(rejoined) or len(thief):
        for q in (rejoined, thief):
            j = q.pop_next()
            if j is not None:
                popped.append(j.id)
    assert sorted(popped) == [1, 2, 3, 4, 5]


# -- the acceptance bar: a replica crash mid-run, no lost job ---------------------


def test_replica_crash_mid_run_zero_lost_jobs_bit_identical():
    fleet = ServiceFleet(n_replicas=3, background=False, service_kwargs=SVC_KW)
    try:
        handles = [fleet.submit(m) for m in (M3, M3, MI, M3, MI)]
        victim = sorted({h._job.replica for h in handles})[0]
        plan = FaultPlan().rule("fleet.replica_crash", "crash", after=6,
                                match={"replica": victim})
        with active(plan):
            fleet.drain(timeout=600)
        assert plan.injected_total() == 1
        gold = {id(M3): GOLD_2PC3, id(MI): GOLD_INCLOCK4}
        for h in handles:
            r = h.result()
            assert r.complete
            assert (r.state_count, r.unique_state_count) == gold[id(h._job.model)]
        m3 = [h.result() for h in handles if h._job.model is M3]
        for r in m3[1:]:
            assert r.discoveries == m3[0].discoveries and r.max_depth == m3[0].max_depth
        s = fleet.stats()
        assert s["replica_crashes"] == 1 and s["healthy"] == 2
        assert s["requeued_jobs"] >= 1 and s["restored_jobs"] >= 1
        requeued = [h for h in handles if h._job.requeues]
        assert requeued and all(h._job.replica != victim for h in requeued)
    finally:
        fleet.close()


# -- one foreground fleet: stealing, retry, the front door -------------------------


@pytest.fixture(scope="module")
def fleet2():
    f = ServiceFleet(n_replicas=2, background=False, max_resident=1, service_kwargs=SVC_KW)
    yield f
    f.close()


def test_idle_replica_steals_queued_jobs(fleet2):
    handles = [fleet2.submit(M3) for _ in range(4)]
    assert len({h._job.replica for h in handles}) == 1  # one key, one owner
    fleet2.drain(timeout=600)
    for h in handles:
        r = h.result()
        assert (r.state_count, r.unique_state_count) == GOLD_2PC3
    assert fleet2.stats()["steals"] >= 1
    assert len({h._job.replica for h in handles}) == 2
    first = handles[0].result()
    for h in handles[1:]:
        assert h.result().discoveries == first.discoveries


def test_router_timeout_retries_with_deterministic_backoff(fleet2):
    before = fleet2.stats()["router_retries"]
    plan = FaultPlan().rule("router.timeout", "io", times=1)
    with active(plan):
        h = fleet2.submit(M3)
    fleet2.drain(timeout=600)
    r = h.result()
    assert (r.state_count, r.unique_state_count) == GOLD_2PC3
    assert fleet2.stats()["router_retries"] == before + 1
    assert plan.injected_total() == 1


def test_steal_fault_leaves_job_where_it_was(fleet2):
    before = fleet2.stats()["steals"]
    plan = FaultPlan().rule("fleet.steal", "io", times=-1)
    handles = [fleet2.submit(M3) for _ in range(3)]
    with active(plan):
        fleet2.drain(timeout=600)
    for h in handles:
        r = h.result()
        assert (r.state_count, r.unique_state_count) == GOLD_2PC3
    assert plan.injected_total() >= 1
    assert fleet2.stats()["steals"] == before


def test_fleet_http_front_door_and_retry_after(fleet2):
    srv = serve_fleet(fleet2, address="localhost:0",
                      registry=ModelRegistry({"2pc3": lambda: M3}))
    try:
        base = "http://" + srv.address

        def get(p):
            return json.loads(urllib.request.urlopen(base + p, timeout=10).read())

        plan = FaultPlan().rule("service.http", "http", times=1)
        with active(plan):
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(base + "/.status", timeout=10)
            assert exc.value.code == 503
            assert exc.value.headers.get("Retry-After") == "1"
        req = urllib.request.Request(base + "/jobs", data=json.dumps({"model": "2pc3"}).encode(),
                                     method="POST")
        jid = json.loads(urllib.request.urlopen(req, timeout=10).read())["job"]
        fleet2.drain(timeout=600)
        p = get(f"/jobs/{jid}")
        assert p["status"] == "done"
        assert (p["state_count"], p["unique_state_count"]) == GOLD_2PC3
        st = get("/.status")
        assert st["healthy"] == 2
        assert any(row["id"] == jid for row in st["job_rows"])
        text = urllib.request.urlopen(base + "/metrics", timeout=10).read()
        assert b"stateright_fleet_healthy 2" in text
    finally:
        srv.shutdown()


def test_fleet_stats_conform_to_obs_schema(fleet2):
    from stateright_tpu.obs.schema import FLEET_COUNTER_KEYS as JAX_KEYS
    from stateright_tpu_torch.obs import REGISTRY
    from stateright_tpu_torch.obs.schema import (
        FLEET_COUNTER_KEYS,
        REGISTRY_SOURCES,
        all_detail_key_paths,
    )

    assert set(fleet2.stats()) == set(FLEET_COUNTER_KEYS) == set(JAX_KEYS)
    assert fleet2.router._metrics_name in REGISTRY.collect()
    assert {"fleet", "lease", "service"} <= set(REGISTRY_SOURCES)
    h = fleet2.submit(M3)
    fleet2.drain(timeout=600)
    detail = h.result().detail
    paths = all_detail_key_paths()
    assert set(detail) <= paths
    assert {f"service.{k}" for k in detail["service"]} <= paths


# -- background mode ------------------------------------------------------------------


def test_background_fleet_survives_a_crash():
    # Runner threads and the router thread: whatever the interleaving, the
    # crashed replica is declared dead and every job ends at its golden.
    fleet = ServiceFleet(n_replicas=2, background=True, service_kwargs=SVC_KW)
    try:
        handles = [fleet.submit(m) for m in (M3, M3, MI)]
        victim = handles[0]._job.replica
        plan = FaultPlan().rule("fleet.replica_crash", "crash", times=1,
                                match={"replica": victim})
        with active(plan):
            fleet.drain(timeout=300)
            deadline = time.monotonic() + 60
            while fleet.stats()["replica_crashes"] < 1:
                assert time.monotonic() < deadline, fleet.stats()
                time.sleep(0.01)
        gold = {id(M3): GOLD_2PC3, id(MI): GOLD_INCLOCK4}
        for h in handles:
            r = h.result(timeout=60)
            assert r.complete and (r.state_count, r.unique_state_count) == gold[id(h._job.model)]
        assert victim in fleet.router._dead and fleet.stats()["healthy"] == 1
    finally:
        fleet.close()
    assert all(r._thread is None for r in fleet.replicas)


# -- a hung replica, driven by pump() ------------------------------------------------


def test_hung_replica_detected_and_jobs_requeued():
    # The victim's probe hangs on the plan's gate, which the plan's own
    # limit releases as a failure inside pump(): two failed probes in a row
    # declare it dead, with no sleep and no probe thread.
    fleet = ServiceFleet(n_replicas=2, background=False, service_kwargs=SVC_KW,
                         router_kwargs=dict(unhealthy_after=2))
    try:
        handles = [fleet.submit(M3) for _ in range(2)]
        victim = handles[0]._job.replica
        plan = FaultPlan(hang_limit_s=0.02).rule("fleet.replica_hang", "hang", times=-1,
                                                 match={"replica": victim})
        with active(plan):
            fleet.drain(timeout=600)
            deadline = time.monotonic() + 60
            while victim not in fleet.router._dead:
                assert time.monotonic() < deadline, fleet.stats()
                fleet.pump(1)
        for h in handles:
            r = h.result()
            assert (r.state_count, r.unique_state_count) == GOLD_2PC3
            if h._job.requeues:
                assert h._job.replica != victim
        s = fleet.stats()
        assert s["probe_failures"] >= 2 and s["replica_crashes"] >= 1
        assert plan.injected["fleet.replica_hang:hang"] >= 2
    finally:
        fleet.close()


# -- the single service's 503 carries Retry-After ------------------------------------


def test_service_503_carries_retry_after():
    svc = CheckService(batch_size=64, table_log2=12, background=False, device="cpu")
    server = serve_service(svc, address="localhost:0")
    try:
        plan = FaultPlan().rule("service.http", "http", times=1)
        with active(plan):
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen("http://" + server.address + "/.status", timeout=10)
        assert exc.value.code == 503
        assert exc.value.headers.get("Retry-After") == "1"
    finally:
        server.shutdown()
        svc.close()


# -- epoch-fenced leases in one process ---------------------------------------------


def test_inproc_partition_zombie_is_fenced_and_results_bit_identical(tmp_path):
    fleet = ServiceFleet(
        n_replicas=2, background=False, max_resident=1, service_kwargs=SVC_KW,
        lease_dir=str(tmp_path / "leases"),
        router_kwargs=dict(steal=False, unhealthy_after=2),
    )
    try:
        handles = [fleet.submit(M3) for _ in range(4)]
        owners = {h._job.replica for h in handles}
        assert len(owners) == 1
        victim = owners.pop()
        while fleet.replicas[victim].service._engine.total_steps < 2:
            fleet.pump(1)
        plan = (FaultPlan()
                .rule("fleet.partition", "io", times=-1, match={"replica": victim})
                .rule("lease.revoke_race", "io", times=1))
        with active(plan):
            deadline = time.monotonic() + 60
            while fleet.stats()["replica_crashes"] < 1:
                assert time.monotonic() < deadline, fleet.stats()
                fleet.pump(1)
            fleet.drain(timeout=600)
        assert plan.injected["lease.revoke_race:io"] == 1
        for h in handles:
            r = h.result()
            assert r.complete and (r.state_count, r.unique_state_count) == GOLD_2PC3
        s = fleet.stats()
        assert s["replica_crashes"] == 1 and s["lease_revokes"] == 1
        assert s["requeued_jobs"] >= 1
        assert s["lease_rejected"] >= 1, s
        assert fleet.lease_store.counters["rejected_writes"] >= 1
        assert not fleet.replicas[victim].alive
        assert "LeaseRevoked" in (fleet.replicas[victim].error or "")
    finally:
        fleet.close()


# -- retire ------------------------------------------------------------------------


def test_router_retire_drains_a_member_loss_free(tmp_path):
    # The autoscaler's scale-in is ROADMAP A item 3, but the router's drain
    # is ported: revoke the member's lease, requeue its jobs resumed from
    # their generations, and let the fenced runner die on its next write.
    fleet = ServiceFleet(n_replicas=2, background=False, service_kwargs=SVC_KW,
                         lease_dir=str(tmp_path / "leases"),
                         router_kwargs=dict(steal=False))
    try:
        handles = [fleet.submit(M3) for _ in range(2)]
        victim = handles[0]._job.replica
        fleet.pump(2)  # generations exist
        assert fleet.router.retire(victim)
        assert not fleet.router.retire(1 - victim)  # never the last member
        fleet.drain(timeout=600)
        for h in handles:
            r = h.result()
            assert (r.state_count, r.unique_state_count) == GOLD_2PC3
            assert h._job.replica == 1 - victim
        s = fleet.stats()
        assert s["scale_ins"] == 1 and s["lease_revokes"] == 1
        assert s["requeued_jobs"] == 2 and s["restored_jobs"] == 2
        assert s["replica_crashes"] == 0
    finally:
        fleet.close()


# -- rejoin ------------------------------------------------------------------------


def test_probation_only_fleet_still_places_jobs():
    class _StubJob:
        def __init__(self):
            self.status = JobStatus.QUEUED
            self.event = threading.Event()
            self.result = None
            self.error = None

    class _StubHandle:
        def __init__(self, jid):
            self.id = jid
            self._job = _StubJob()

    class _StubReplica:
        def __init__(self, idx):
            self.idx = idx
            self.alive = True
            self.error = None
            self.submitted = []

        def submit(self, spec, ckpt_path=None):
            self.submitted.append(spec)
            return _StubHandle(len(self.submitted))

        def probe(self):
            return {}

        def idle(self):
            return True

        def withdraw(self, jid):
            return False

        def snapshot_row(self):
            return {"alive": 1, "queued": 0}

    router = FleetRouter([_StubReplica(0)], backoff_base_s=0.0)
    try:
        router._dead.add(0)
        router.ring.remove(0)
        assert router.rejoin(_StubReplica(0))
        assert router.ring.members() == []  # quarantined
        h = router.submit(object(), route_key="m")
        assert h.status() == "routed"  # placed on the probation member
        assert router.replicas[0].submitted
    finally:
        router.close()


def test_crashed_replica_rejoins_fresh_epoch_probation_then_work(tmp_path):
    fleet = ServiceFleet(
        n_replicas=2, background=False, max_resident=1, service_kwargs=SVC_KW,
        lease_dir=str(tmp_path / "leases"),
        router_kwargs=dict(steal=True, unhealthy_after=2, probation_probes=2),
    )
    try:
        handles = [fleet.submit(M3) for _ in range(4)]
        owners = {h._job.replica for h in handles}
        assert len(owners) == 1
        victim = owners.pop()
        member = lease_member(victim)
        epoch0, _ = fleet.lease_store.state(member)
        plan = FaultPlan().rule("fleet.replica_crash", "crash", after=6,
                                match={"replica": victim})
        with active(plan):
            deadline = time.monotonic() + 60
            while fleet.stats()["replica_crashes"] < 1:
                assert time.monotonic() < deadline, fleet.stats()
                fleet.pump(1)
        assert fleet.stats()["requeued_jobs"] >= 1
        with active(FaultPlan().rule("fleet.rejoin", "io", times=1)):
            assert not fleet.rejoin_replica(victim)
        assert victim in fleet.router._dead and fleet.stats()["rejoins"] == 0
        assert fleet.rejoin_replica(victim)
        assert fleet.lease_store.state(member) == (epoch0 + 1, "granted")
        assert victim not in fleet.router._dead
        assert victim not in fleet.router.ring.members()  # in probation
        deadline = time.monotonic() + 60
        while fleet.stats()["rejoin_promotions"] < 1:
            assert time.monotonic() < deadline, fleet.stats()
            fleet.pump(1)
        assert victim in fleet.router.ring.members()
        fleet.drain(timeout=600)
        for h in handles:
            r = h.result()
            assert r.complete and (r.state_count, r.unique_state_count) == GOLD_2PC3
        s = fleet.stats()
        assert s["rejoins"] == 1 and s["rejoin_promotions"] == 1
        assert s["steals"] >= 1, s
        assert any(h._job.replica == victim for h in handles)
        h2 = fleet.submit(M3)
        assert h2._job.replica == victim  # the ring gave its keys back
        fleet.drain(timeout=600)
        r2 = h2.result()
        assert (r2.state_count, r2.unique_state_count) == GOLD_2PC3
    finally:
        fleet.close()
