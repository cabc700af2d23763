"""The check service's hardening and observability in the port, each held
against the JAX package's CheckService (insert_variant="pallas", interpret
mode) under the same fault plan: mirrors of tests/test_faults.py:404,
:439, :462, :490, tests/test_obs.py:250, :298 and tests/test_events.py:365.
A poison job is quarantined while its group and the service finish at
their goldens; a transient step fault retries exactly; an injected HTTP
fault is a 503; the Prometheus text, the telemetry and the event journal
match. Counts, fault counters and event sequences compare exactly."""

import json
import re
import urllib.error
import urllib.request

import numpy as np
import pytest

from stateright_tpu import faults as jfaults
from stateright_tpu.service import CheckService as JaxService
from stateright_tpu.service.server import ModelRegistry as JaxRegistry
from stateright_tpu.service.server import serve_service as jax_serve
from stateright_tpu.tensor import models as jm
from stateright_tpu_torch import faults as pfaults
from stateright_tpu_torch.obs import LogHistogram, flatten_metrics, render_prometheus
from stateright_tpu_torch.service import CheckService, serve_service
from stateright_tpu_torch.service.server import ModelRegistry, metrics_view
from stateright_tpu_torch.tensor import models as pm

GOLD_2PC3 = (1_146, 288)
GOLD_INCLOCK4 = (257, 257)
SIDES = {
    "jax": (JaxService, dict(insert_variant="pallas"), jfaults, jm),
    "port": (CheckService, dict(device="cpu"), pfaults, pm),
}
_PROM_LINE = re.compile(
    r'^(# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* (gauge|histogram)|'
    r'[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-z_]+="[^"]*"\})? -?[0-9.e+-]+|'
    r'[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-z_]+="[^"]*"\})? [+-]?inf)$'
)


def _counts(r):
    return r.state_count, r.unique_state_count, r.max_depth, r.steps, r.discoveries


def _poison(side):
    svc_cls, kw, faults, models = SIDES[side]
    m3, mi = models.TensorTwoPhaseSys(3), models.TensorIncrementLock(4)
    svc = svc_cls(batch_size=256, table_log2=14, background=False, retry_limit=1, **kw)
    h_ok = svc.submit(m3)
    h_poison = svc.submit(m3)  # the same model instance: the same group
    h_other = svc.submit(mi)  # another group
    plan = faults.FaultPlan().rule("service.step", "poison", times=-1,
                                   match={"job": h_poison.id})
    with faults.active(plan):
        svc.drain(timeout=300)
    r_ok, r_other = h_ok.result(), h_other.result()
    poison = svc.poll(h_poison.id)
    out = (_counts(r_ok), _counts(r_other), poison["status"], poison["quarantined"],
           poison["steps"], svc.stats()["faults"], r_ok.detail["faults"], plan.stats(),
           svc.stats()["device_steps"])
    svc.close()
    return out


def test_service_poison_job_quarantined_group_and_service_survive():
    mine = _poison("port")
    assert mine[0][:2] == GOLD_2PC3 and mine[1][:2] == GOLD_INCLOCK4
    assert mine[2] == "error" and mine[3]
    assert mine[5]["quarantined_jobs"] == 1 and mine[5]["retries"] >= 1
    assert mine[6]["quarantined_jobs"] == 1
    assert mine == _poison("jax")


def _transient(side):
    svc_cls, kw, faults, models = SIDES[side]
    m3 = models.TensorTwoPhaseSys(3)
    svc = svc_cls(batch_size=256, table_log2=14, background=False, retry_limit=3, **kw)
    h1, h2 = svc.submit(m3), svc.submit(m3)
    plan = faults.FaultPlan().rule("service.step", "xla", after=1, times=2)
    with faults.active(plan):
        svc.drain(timeout=300)
    out = ([_counts(h.result()) for h in (h1, h2)], svc.stats()["faults"],
           svc.stats()["device_steps"])
    svc.close()
    return out


def test_service_transient_step_fault_retries_exactly():
    mine = _transient("port")
    assert all(c[:2] == GOLD_2PC3 for c in mine[0])
    assert mine[1] == {"step_faults": 2, "retries": 2, "quarantined_jobs": 0}
    assert mine == _transient("jax")


def test_service_http_fault_degrades_to_503():
    svc = CheckService(batch_size=64, table_log2=12, background=False, device="cpu")
    server = serve_service(svc, address="localhost:0")
    port = server.httpd.server_address[1]
    plan = pfaults.FaultPlan().rule("service.http", "http", times=1)
    try:
        with pfaults.active(plan):
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(f"http://localhost:{port}/.status", timeout=10)
            assert exc.value.code == 503
            assert exc.value.headers["Retry-After"] == "1"
            # The front end survives its own fault.
            with urllib.request.urlopen(f"http://localhost:{port}/.status",
                                        timeout=10) as resp:
                assert resp.status == 200
                assert "faults" in json.load(resp)
        assert plan.stats() == {"injected_total": 1, "injected": {"service.http:http": 1}}
    finally:
        server.shutdown()
        svc.close()


def test_push_front_preserves_pop_order():
    # The exactly-retriable unwind: lanes a faulted step took go back to
    # the front, and the retry pops the same order.
    from stateright_tpu_torch.service.queue import Job

    job = Job(1, pm.TensorTwoPhaseSys(3))

    def mk(a, b):
        return (np.arange(a, b, dtype=np.int64).reshape(-1, 1), np.arange(a, b, dtype=np.int64),
                np.zeros((b - a, 0), dtype=bool), np.ones(b - a, dtype=np.int64))

    job.push(*mk(1, 6))
    job.push(*mk(6, 9))
    taken = job.take(4)
    assert list(taken[1]) == [1, 2, 3, 4]
    job.push_front(*taken)
    assert list(job.take(8)[1]) == [1, 2, 3, 4, 5, 6, 7, 8]


# -- metrics -------------------------------------------------------------------


def _assert_prometheus_text(body: str) -> int:
    lines = [ln for ln in body.splitlines() if ln.strip()]
    for line in lines:
        assert _PROM_LINE.match(line), f"bad exposition line: {line!r}"
    samples = [ln for ln in lines if not ln.startswith("#")]
    assert samples, "no samples in scrape"
    return len(samples)


def test_render_prometheus_equals_jax():
    from stateright_tpu.obs import registry as jreg

    groups = {"src": {"steps": 3, "fill": {"last": 0.5}, "per_chip": [1, 2], "flag": True,
                      "label": "skipped", "none": None}}
    text = render_prometheus(groups)
    _assert_prometheus_text(text)
    assert "stateright_src_fill_last 0.5" in text
    assert 'stateright_src_per_chip{index="1"} 2' in text
    assert text == jreg.render_prometheus(groups)
    assert flatten_metrics({"a": {"b": 2}}) == {"a_b": 2}
    h, jh = LogHistogram(), jreg.LogHistogram()
    for v in (0.01, 0.3, 7.0, 7.0, 1e6):
        h.observe(v)
        jh.observe(v)
    assert h.render("x") == jh.render("x")
    assert render_prometheus({"s": {"h": h}}) == jreg.render_prometheus({"s": {"h": jh}})


def _metrics(side, serve):
    svc_cls, kw, _faults, models = SIDES[side]
    svc = svc_cls(batch_size=256, table_log2=14, background=False, **kw)
    try:
        h = svc.submit(models.TensorTwoPhaseSys(3))
        svc.drain()
        assert h.result().unique_state_count == GOLD_2PC3[1]
        st = svc.stats()
        assert st["telemetry"]["steps"] == st["device_steps"] > 0
        server = serve(svc, "localhost:0")
        try:
            body = urllib.request.urlopen(f"http://{server.address}/metrics",
                                          timeout=10).read().decode()
            status = json.loads(urllib.request.urlopen(
                f"http://{server.address}/.status", timeout=10).read())
        finally:
            server.shutdown()
        _assert_prometheus_text(body)
        assert "device_steps" in body
        assert status["telemetry"]["steps"] == st["device_steps"]
        telemetry = {k: v for k, v in st["telemetry"].items() if k != "step_us"}
        return st["device_steps"], telemetry, h.result().steps
    finally:
        svc.close()


def test_service_metrics_endpoint_and_status():
    mine = _metrics("port", serve_service)
    assert mine == _metrics("jax", jax_serve)
    svc = CheckService(batch_size=64, table_log2=12, background=False, device="cpu")
    try:
        _assert_prometheus_text(metrics_view(svc))
        assert "stateright_service_admission_wait_ms_bucket" in metrics_view(svc)
    finally:
        svc.close()


# -- the event journal over HTTP -----------------------------------------------


def _events(side, serve, registry, tmp_path):
    svc_cls, kw, _faults, models = SIDES[side]
    m3 = models.TensorTwoPhaseSys(3)
    svc = svc_cls(batch_size=128, table_log2=14, background=False,
                  events_out=str(tmp_path / f"{side}.jsonl"), **kw)
    server = serve(svc, address="localhost:0", registry=registry({"2pc3": lambda: m3}))
    try:
        base = "http://" + server.address
        h = svc.submit(m3)
        svc.drain()
        r = h.result()
        assert (r.state_count, r.unique_state_count) == GOLD_2PC3
        body = json.loads(urllib.request.urlopen(
            f"{base}/jobs/{h.id}/events?since=0", timeout=10).read())
        names = [e["event"] for e in body["events"]]
        assert names[0] == "job.submitted" and names[-1] == "job.done"
        assert "replica.admit" in names and "engine.chunk" in names
        assert all(e.get("job") == h.id or h.id in e.get("jobs", []) for e in body["events"])
        nxt = body["next"]
        body2 = json.loads(urllib.request.urlopen(
            f"{base}/jobs/{h.id}/events?since={nxt}", timeout=10).read())
        assert body2["events"] == [] and body2["next"] == nxt
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"{base}/jobs/999/events", timeout=10)
        assert exc.value.code == 404
        drop = ("ts", "pid", "trace", "traces", "writer")
        return [{k: v for k, v in e.items() if k not in drop} for e in body["events"]], nxt
    finally:
        server.shutdown()
        svc.close()


def test_service_events_endpoint_long_poll_cursor(tmp_path):
    mine = _events("port", serve_service, ModelRegistry, tmp_path)
    assert mine == _events("jax", jax_serve, JaxRegistry, tmp_path)
    # The journal file the service wrote reads back the same way in both
    # packages.
    from stateright_tpu.obs import read_journal as jax_read
    from stateright_tpu_torch.obs import read_journal

    assert read_journal(str(tmp_path / "port.jsonl")) == jax_read(str(tmp_path / "port.jsonl"))
    assert [e["event"] for e in read_journal(str(tmp_path / "port.jsonl"))] == [
        e["event"] for e in jax_read(str(tmp_path / "jax.jsonl"))]
