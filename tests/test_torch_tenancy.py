"""The tenancy plane of the port's check service (service/tenancy.py, the
tenant rotation of service/queue.py, the two-level waterfill of
service/scheduler.py), mirroring tests/test_tenancy.py and held against the
JAX package's AdmissionQueue and ServiceEngine on the same jobs: the same
pop orders and the same lane splits. Then tenants end to end: a quota
refusal as an HTTP 429, and two tenants' jobs on one service step for step
with the JAX service."""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from stateright_tpu.service.queue import AdmissionQueue as JaxQueue
from stateright_tpu.service.queue import Job as JaxJob
from stateright_tpu.service.scheduler import ServiceEngine as JaxEngine
from stateright_tpu_torch.service import CheckService, serve_service
from stateright_tpu_torch.service.queue import AdmissionQueue, Job
from stateright_tpu_torch.service.scheduler import ServiceEngine
from stateright_tpu_torch.service.server import ModelRegistry
from stateright_tpu_torch.service.tenancy import (
    DEFAULT_TENANT,
    QuotaExceeded,
    TenantQuotas,
    tenant_salt,
)


class _M:
    lanes = 1


def _job(jid, tenant=DEFAULT_TENANT, priority=0):
    return Job(jid, _M(), priority=priority, tenant=tenant)


def _pops(pushes, n):
    """Pop ids of the port's queue and of the JAX one, fed the same pushes
    ((id, tenant, priority), or "requeue" of the last popped job)."""
    out = []
    for queue_cls, job_cls in ((AdmissionQueue, Job), (JaxQueue, JaxJob)):
        q, popped = queue_cls(), []
        for ev in pushes:
            if ev == "pop":
                popped.append(q.pop_next())
            elif ev == "requeue":
                q.push(popped[-1])
            else:
                jid, tenant, prio = ev
                q.push(job_cls(jid, _M(), priority=prio, tenant=tenant))
        popped += [q.pop_next() for _ in range(n)]
        out.append([j.id for j in popped])
    assert out[0] == out[1]
    return out[0]


# -- quota ledger --------------------------------------------------------------


def test_in_flight_quota_gates_only_configured_tenants():
    q = TenantQuotas()
    q.set_quota("capped", max_in_flight=2)
    q.admit("capped", in_flight=1)
    with pytest.raises(QuotaExceeded) as ei:
        q.admit("capped", in_flight=2)
    assert ei.value.tenant == "capped"
    assert "in_flight 2 >= max 2" in ei.value.reason
    assert ei.value.retry_after_s >= 0.1
    q.admit("unmetered", in_flight=10_000)
    q.admit(DEFAULT_TENANT, in_flight=10_000)


def test_lane_seconds_budget_throttles_and_refills_linearly():
    q = TenantQuotas()
    q.set_quota("burny", lane_seconds=10.0, window_s=10.0)  # 1 lane-s/s
    q.charge("burny", 12.0)
    with pytest.raises(QuotaExceeded) as ei:
        q.admit("burny", in_flight=0)
    assert "lane_seconds" in ei.value.reason
    assert 0.1 <= ei.value.retry_after_s <= 30.0
    q._last_refill["burny"] -= 5.0  # five seconds of refill, without sleeping
    assert q.spent("burny") == pytest.approx(7.0, abs=0.25)
    q.admit("burny", in_flight=0)


def test_charge_is_recorded_for_unmetered_tenants_too():
    q = TenantQuotas()
    q.charge("watched", 3.5)
    assert q.spent("watched") == pytest.approx(3.5)
    snap = q.snapshot()
    assert snap["watched"]["max_in_flight"] is None
    assert snap["watched"]["spent"] == pytest.approx(3.5)


def test_snapshot_reports_quota_and_spend_per_tenant():
    q = TenantQuotas()
    q.set_quota("a", max_in_flight=4, lane_seconds=60.0, window_s=30.0)
    q.charge("a", 1.25)
    row = q.snapshot()["a"]
    assert (row["max_in_flight"], row["lane_seconds"], row["window_s"]) == (4, 60.0, 30.0)
    assert row["spent"] == pytest.approx(1.25, abs=0.01)


def test_quota_exceeded_carries_the_http_429_pieces():
    e = QuotaExceeded("acme", "in_flight 3 >= max 3", retry_after_s=2.5)
    assert e.tenant == "acme" and e.retry_after_s == 2.5
    assert "retry after 2.5s" in str(e)
    assert QuotaExceeded("a", "r", retry_after_s=0.0).retry_after_s == 0.1


def test_default_tenant_admission_costs_no_ledger_entry():
    q = TenantQuotas()
    t0 = time.monotonic()
    for _ in range(10_000):
        q.admit(DEFAULT_TENANT, in_flight=0)
    assert time.monotonic() - t0 < 1.0
    assert q.snapshot() == {}
    assert tenant_salt(None) is None and tenant_salt(DEFAULT_TENANT) is None
    assert tenant_salt("acme") == "acme"


# -- two-level admission (the queue) -------------------------------------------


def test_tenant_flood_cannot_starve_a_one_job_tenant():
    pushes = [(i, "noisy", 0) for i in range(100)] + [(100, "quiet", 0)]
    assert _pops(pushes, 7) == [0, 100, 1, 2, 3, 4, 5]


def test_single_tenant_admission_is_the_jobs_only_order():
    pushes = [(1, DEFAULT_TENANT, 0), (2, DEFAULT_TENANT, 5), (3, DEFAULT_TENANT, 0),
              (4, DEFAULT_TENANT, 5)]
    assert _pops(pushes, 4) == [2, 4, 1, 3]


def test_priority_beats_tenant_rotation():
    pushes = [(i, "noisy", 0) for i in range(5)] + [(10, "quiet", 0), (11, "noisy", 9)]
    assert _pops(pushes, 1) == [11]


def test_tenant_requeue_lands_behind_same_priority_peers():
    pushes = [(1, "a", 0), (2, "b", 0), (3, "a", 0), "pop", "requeue"]
    assert _pops(pushes, 3) == [1, 2, 3, 1]


def test_tenant_tagged_requeue_pops_exactly_once_in_original_order():
    class _M2:
        lanes = 2

    job = Job(7, _M2(), tenant="tagged")
    n = 8
    keys = np.arange(1, n + 1, dtype=np.int64)
    job.push(np.arange(n * 2, dtype=np.int64).reshape(n, 2), keys,
             np.zeros((n, 1), dtype=bool), np.ones(n, dtype=np.int64))
    job.push_front(*job.take(5))
    popped = []
    while job.pending_lanes:
        popped.extend(int(x) for x in job.take(3)[1])
    assert popped == list(range(1, n + 1))


# -- the two-level waterfill (the scheduler) -----------------------------------


class _J:
    def __init__(self, pending, tenant=DEFAULT_TENANT):
        self.pending_lanes = pending
        self.tenant = tenant


def _grants(jobs, K):
    mine = ServiceEngine._grants(ServiceEngine.__new__(ServiceEngine), jobs, K)
    assert mine == JaxEngine._grants(JaxEngine.__new__(JaxEngine), jobs, K)
    return mine


def test_two_level_waterfill_splits_lanes_across_tenants_first():
    g = _grants([_J(100, "noisy"), _J(100, "noisy"), _J(100, "noisy"), _J(100, "quiet")], 64)
    assert sum(g) == 64 and g[3] >= 31 and sum(g[:3]) >= 31


def test_two_level_waterfill_single_tenant_identity():
    for pend, K in (([5, 50, 3], 16), ([1, 1, 1], 64), ([100, 100], 7), ([0, 9], 4)):
        assert _grants([_J(p) for p in pend], K) == ServiceEngine._waterfill(pend, K)


def test_two_level_waterfill_unused_share_spills_to_hungry_tenants():
    assert _grants([_J(2, "tiny"), _J(100, "big")], 64) == [2, 62]


def test_waterfill_equals_jax_on_seeded_demands():
    rng = np.random.default_rng(9)
    for _ in range(200):
        n = int(rng.integers(1, 7))
        jobs = [_J(int(rng.integers(0, 300)), f"t{int(rng.integers(0, 3))}") for _ in range(n)]
        _grants(jobs, int(rng.integers(1, 512)))


# -- tenants end to end --------------------------------------------------------


def _two_tenants(svc_cls, models, **kw):
    m3 = models.TensorTwoPhaseSys(3)
    svc = svc_cls(batch_size=64, table_log2=13, background=False, **kw)
    try:
        hs = [svc.submit(m3, tenant=t) for t in ("acme", "acme", "acme", "zorg")]
        svc.drain(timeout=300)
        rs = [h.result() for h in hs]
        return ([(r.state_count, r.unique_state_count, r.max_depth, r.steps, r.discoveries)
                 for r in rs], [r.detail["tenant"]["name"] for r in rs],
                svc.stats()["device_steps"])
    finally:
        svc.close()


def test_two_tenants_share_steps_as_the_jax_service_does():
    from stateright_tpu.service import CheckService as JaxService
    from stateright_tpu.tensor import models as jm
    from stateright_tpu_torch.tensor import models as pm

    mine = _two_tenants(CheckService, pm, device="cpu")
    assert all(o[:2] == (1_146, 288) for o in mine[0])
    assert mine[1] == ["acme", "acme", "acme", "zorg"]
    assert mine == _two_tenants(JaxService, jm, insert_variant="pallas")


def test_over_quota_submission_is_an_http_429():
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys

    q = TenantQuotas()
    q.set_quota("capped", max_in_flight=1)
    svc = CheckService(batch_size=64, table_log2=12, background=False, quotas=q,
                       device="cpu")
    m3 = TensorTwoPhaseSys(3)
    server = serve_service(svc, "localhost:0", registry=ModelRegistry({"2pc3": lambda: m3}))
    try:
        def post(body):
            req = urllib.request.Request(f"http://{server.address}/jobs",
                                         data=json.dumps(body).encode(), method="POST")
            return json.loads(urllib.request.urlopen(req, timeout=10).read())

        jid = post({"model": "2pc3", "tenant": "capped"})["job"]
        with pytest.raises(urllib.error.HTTPError) as exc:
            post({"model": "2pc3", "tenant": "capped"})
        assert exc.value.code == 429 and float(exc.value.headers["Retry-After"]) >= 0.1
        post({"model": "2pc3"})  # the default tenant is never gated
        svc.drain(timeout=120)
        r = svc.result(jid)
        assert r.detail["tenant"]["name"] == "capped" and r.detail["tenant"]["lane_seconds"] > 0
        st = svc.stats()
        assert st["quota_rejected"] == 1 and st["tenants"]["capped"]["spent"] > 0
        post({"model": "2pc3", "tenant": "capped"})  # in flight again: admitted
    finally:
        server.shutdown()
        svc.close()
