"""The port's flight recorder across a fleet and its forensic timeline
(stateright_tpu_torch/obs/timeline.py) on the CPU: the mirrors of the
timeline, CLI and events-endpoint tests of tests/test_events.py.

One foreground N=3 port fleet runs a mixed job set through a mid-run
replica crash and a work steal, with journals and a flushing tracer on;
from its journals the timeline rebuilds every job's whole lifecycle as one
trace with no anomaly, event counts equal to the fleet's counters, and a
Perfetto-loadable merged Chrome trace. The port's CLI report equals the
JAX package's CLI report on the same journals, and the anomaly verdicts
equal the JAX package's on synthetic lifecycles."""

import json
import os
import subprocess
import sys

import pytest

from stateright_tpu.obs import timeline as jax_tl
from stateright_tpu_torch.obs import EventJournal, Tracer, read_journal
from stateright_tpu_torch.obs import timeline as tl

GOLD_2PC3 = (1_146, 288)
GOLD_INCLOCK4 = (257, 257)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- anomaly verdicts on synthetic lifecycles ----------------------------------------


def _mk(event, ts, writer="w", seq=0, **kw):
    return {"event": event, "ts": ts, "seq": seq, "writer": writer, **kw}


def test_anomaly_no_terminal_and_duplicate_admission():
    traces = {
        "lost": [_mk("job.submitted", 1.0, job=1, trace="lost"),
                 _mk("replica.admit", 2.0, job=1, trace="lost")],
        "dup": [_mk("job.submitted", 1.0, job=2, trace="dup"),
                _mk("replica.admit", 2.0, job=2, trace="dup", writer="r0"),
                _mk("replica.admit", 3.0, job=9, trace="dup", writer="r1"),
                _mk("job.done", 4.0, job=2, trace="dup")],
        "clean": [_mk("job.submitted", 1.0, job=3, trace="clean"),
                  _mk("replica.admit", 2.0, job=3, trace="clean"),
                  _mk("job.requeued", 3.0, job=3, trace="clean", src=0),
                  _mk("job.resumed", 4.0, job=3, trace="clean"),
                  _mk("job.done", 5.0, job=3, trace="clean")],
    }
    found = tl.find_anomalies(traces)
    assert found == jax_tl.find_anomalies(traces)
    assert {(a["kind"], a["trace"]) for a in found} == {
        ("no_terminal", "lost"), ("duplicate_admission", "dup")}


def test_anomaly_admission_gap_uses_budget():
    traces = {"slow": [_mk("job.submitted", 0.0, job=1, trace="slow"),
                       _mk("replica.admit", 100.0, job=1, trace="slow"),
                       _mk("job.done", 101.0, job=1, trace="slow")]}
    assert tl.find_anomalies(traces, gap_s=30.0) != []
    assert tl.find_anomalies(traces, gap_s=30.0) == jax_tl.find_anomalies(traces, gap_s=30.0)
    assert tl.find_anomalies(traces, gap_s=200.0) == []


# -- the acceptance bar: a chaos fleet run -> journals -> a clean timeline -------------


@pytest.fixture(scope="module")
def chaos_fleet_run(tmp_path_factory):
    """One N=3 foreground port fleet with a mid-run replica crash and a
    work steal, journals and a flushing tracer attached."""
    from stateright_tpu_torch.faults import FaultPlan, active
    from stateright_tpu_torch.service import ServiceFleet
    from stateright_tpu_torch.tensor.models import TensorIncrementLock, TensorTwoPhaseSys

    td = tmp_path_factory.mktemp("recorder")
    journal_dir = os.path.join(str(td), "journal")
    trace_path = os.path.join(str(td), "trace.json")
    m3, mi = TensorTwoPhaseSys(3), TensorIncrementLock(4)
    tracer = Tracer(out=trace_path, flush_every=20)
    # max_resident=1 queues same-key jobs, so the idle replicas steal; the
    # crash then requeues and resumes on top.
    fleet = ServiceFleet(
        n_replicas=3, background=False, max_resident=1,
        service_kwargs=dict(batch_size=128, table_log2=14, device="cpu"),
        journal_dir=journal_dir, tracer=tracer,
    )
    handles = [fleet.submit(m) for m in (m3, m3, mi, m3, mi)]
    victim = sorted({h._job.replica for h in handles})[0]
    plan = FaultPlan().rule("fleet.replica_crash", "crash", after=6,
                            match={"replica": victim})
    with active(plan):
        fleet.drain(timeout=600)
    results = [h.result() for h in handles]
    stats = fleet.stats()
    with open(trace_path) as f:
        partial_trace = json.load(f)  # before close: the flush cadence wrote it
    fleet.close()
    yield dict(journal_dir=journal_dir, trace_path=trace_path, handles=handles,
               results=results, stats=stats, plan=plan, victim=victim,
               partial_trace=partial_trace, models=(m3, mi))


def test_chaos_run_results_still_golden(chaos_fleet_run):
    m3, mi = chaos_fleet_run["models"]
    gold = {id(m3): GOLD_2PC3, id(mi): GOLD_INCLOCK4}
    assert chaos_fleet_run["plan"].injected_total() == 1
    for h, r in zip(chaos_fleet_run["handles"], chaos_fleet_run["results"]):
        assert r.complete
        assert (r.state_count, r.unique_state_count) == gold[id(h._job.model)]
        assert r.detail.get("trace") == h._job.trace
    s = chaos_fleet_run["stats"]
    assert s["replica_crashes"] == 1 and s["steals"] >= 1
    assert s["requeued_jobs"] >= 1 and s["restored_jobs"] >= 1


def test_timeline_reconstructs_every_lifecycle_zero_anomalies(chaos_fleet_run):
    jd = chaos_fleet_run["journal_dir"]
    assert sorted(os.listdir(jd)) == [
        "replica0.jsonl", "replica1.jsonl", "replica2.jsonl", "router.jsonl"]
    evs = tl.load_events([jd])
    traces, _untraced = tl.group_traces(evs)
    assert len(traces) == len(chaos_fleet_run["handles"])
    assert tl.find_anomalies(traces) == []
    for h in chaos_fleet_run["handles"]:
        lc = tl.lifecycle(traces[h._job.trace])
        assert lc["first"] == "job.submitted" and lc["terminal"] == "job.done"
    requeued = [h for h in chaos_fleet_run["handles"] if h._job.requeues]
    assert requeued
    restored = 0
    for h in requeued:
        names = [e["event"] for e in traces[h._job.trace]]
        assert "job.requeued" in names
        restored += "job.resumed" in names
        assert len(tl.lifecycle(traces[h._job.trace])["writers"]) >= 2
    assert restored == chaos_fleet_run["stats"]["restored_jobs"]


def test_event_counts_consistent_with_fleet_counters(chaos_fleet_run):
    counts = tl.event_counts(tl.load_events([chaos_fleet_run["journal_dir"]]))
    s = chaos_fleet_run["stats"]
    assert counts.get("replica.crash", 0) == s["replica_crashes"]
    assert counts.get("job.requeued", 0) == s["requeued_jobs"]
    assert counts.get("fleet.steal", 0) == s["steals"]
    assert counts.get("job.resumed", 0) == s["restored_jobs"]
    assert counts.get("fault.injected", 0) == 1  # the chaos plan was adopted
    assert counts.get("job.done", 0) >= len(chaos_fleet_run["handles"])
    recent = s["events_recent"]
    assert recent and all("event" in e for e in recent)


def test_partial_trace_survives_crash_and_merges_perfetto_loadable(chaos_fleet_run, tmp_path):
    partial = chaos_fleet_run["partial_trace"]
    assert isinstance(partial["traceEvents"], list) and partial["traceEvents"]
    out = str(tmp_path / "merged.json")
    rc = tl.main([chaos_fleet_run["journal_dir"], "--traces", chaos_fleet_run["trace_path"],
                  "--chrome-out", out])
    assert rc == 0
    with open(out) as f:
        merged = json.load(f)
    assert len(merged["traceEvents"]) >= len(partial["traceEvents"])
    for e in merged["traceEvents"]:
        assert ("ph" in e and "pid" in e) or e.get("ph") == "M"
    synth = str(tmp_path / "synth.json")
    assert tl.main([chaos_fleet_run["journal_dir"], "--chrome-out", synth]) == 0
    with open(synth) as f:
        env = json.load(f)
    assert {e.get("ph") for e in env["traceEvents"]} <= {"M", "i"}


def test_timeline_cli_json_report(chaos_fleet_run, capsys):
    assert tl.main([chaos_fleet_run["journal_dir"], "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["anomalies"] == []
    assert len(report["traces"]) == len(chaos_fleet_run["handles"])
    for lc in report["traces"].values():
        assert lc["terminal"] == "job.done"


def test_timeline_cli_json_equals_the_jax_cli(chaos_fleet_run, capsys):
    jd = chaos_fleet_run["journal_dir"]
    assert tl.main([jd, "--json"]) == 0
    ours = json.loads(capsys.readouterr().out)
    assert jax_tl.main([jd, "--json"]) == 0
    theirs = json.loads(capsys.readouterr().out)
    assert ours == theirs


def test_timeline_runs_as_a_module_cli(chaos_fleet_run):
    proc = subprocess.run(
        [sys.executable, "-m", "stateright_tpu_torch.obs.timeline",
         chaos_fleet_run["journal_dir"], "--json"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout)
    assert report["anomalies"] == [] and report["lease_rejected_events"] == 0
    empty = subprocess.run([sys.executable, "-m", "stateright_tpu_torch.obs.timeline"],
                           cwd=REPO, capture_output=True, text=True, timeout=120)
    assert empty.returncode == 1  # nothing to read


def test_timeline_refuses_wire_store_roots(tmp_path):
    """Wire-store journal roots, once refused, are read: journals mirrored
    to a ``blob://`` root load as the local files do, and the port's CLI
    report over the wire root equals the JAX CLI's over the same root. An
    unreachable root is an empty journal (the reader never raises)."""
    from stateright_tpu_torch.faults.blobstore import serve_blobd

    srv = serve_blobd()
    try:
        root = srv.root_uri + "/journal"
        for name, writer in (("router.jsonl", "router"), ("replica0.jsonl", "replica0")):
            j = EventJournal(str(tmp_path / name), writer=writer,
                             sync_uri=f"{root}/{name}")
            if writer == "router":
                j.emit("job.submitted", job=1, trace="t1")
            else:
                j.emit("replica.admit", job=1, trace="t1")
                j.emit("job.done", job=1, trace="t1")
            j.close()
        local = tl.load_events([str(tmp_path)])
        wire = tl.load_events([root])
        assert [e["event"] for e in wire] == [e["event"] for e in local] == [
            "job.submitted", "replica.admit", "job.done"]
        assert read_journal(root + "/router.jsonl") == read_journal(str(tmp_path / "router.jsonl"))
        out = [subprocess.run([sys.executable, "-m", mod, root, "--json"], cwd=REPO,
                              capture_output=True, text=True, timeout=120)
               for mod in ("stateright_tpu_torch.obs.timeline", "stateright_tpu.obs.timeline")]
        assert [o.returncode for o in out] == [0, 0], [o.stderr[-400:] for o in out]
        reports = [json.loads(o.stdout.strip().splitlines()[-1]) for o in out]
        assert reports[0] == reports[1] and reports[0]["anomalies"] == []
        assert reports[0]["traces"]["t1"]["terminal"] == "job.done"
    finally:
        srv.shutdown()
    assert read_journal("blob://localhost:9/journal/router.jsonl") == []


# -- live event tails over HTTP ---------------------------------------------------------


def test_fleet_events_endpoint(tmp_path):
    import urllib.request

    from stateright_tpu_torch.service import ServiceFleet, serve_fleet
    from stateright_tpu_torch.service.server import ModelRegistry
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys

    m3 = TensorTwoPhaseSys(3)
    fleet = ServiceFleet(n_replicas=2, background=False,
                         service_kwargs=dict(batch_size=128, table_log2=14, device="cpu"),
                         journal_dir=str(tmp_path / "journal"))
    srv = serve_fleet(fleet, address="localhost:0",
                      registry=ModelRegistry({"2pc3": lambda: m3}))
    try:
        base = "http://" + srv.address
        req = urllib.request.Request(base + "/jobs", data=json.dumps({"model": "2pc3"}).encode(),
                                     method="POST")
        jid = json.loads(urllib.request.urlopen(req, timeout=10).read())["job"]
        fleet.drain(timeout=600)
        body = json.loads(urllib.request.urlopen(
            f"{base}/jobs/{jid}/events?since=0&wait=0", timeout=10).read())
        names = [e["event"] for e in body["events"]]
        assert names[0] == "job.submitted"
        assert "router.route" in names and names[-1] == "job.done"
        st = json.loads(urllib.request.urlopen(base + "/.status", timeout=10).read())
        assert st["events_recent"]
        import urllib.error

        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"{base}/jobs/999/events", timeout=10)
        assert exc.value.code == 404
    finally:
        srv.shutdown()
        fleet.close()


def test_withdraw_endpoint_removes_only_queued_jobs(tmp_path):
    import urllib.request

    from stateright_tpu_torch.service import CheckService, serve_service
    from stateright_tpu_torch.service.server import ModelRegistry
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys

    m3 = TensorTwoPhaseSys(3)
    svc = CheckService(batch_size=128, table_log2=14, background=False, device="cpu",
                       max_resident=1)
    server = serve_service(svc, address="localhost:0",
                           registry=ModelRegistry({"2pc3": lambda: m3}))
    try:
        base = "http://" + server.address

        def post(path, body=None):
            req = urllib.request.Request(base + path, data=json.dumps(body or {}).encode(),
                                         method="POST")
            return json.loads(urllib.request.urlopen(req, timeout=10).read())

        a, b = post("/jobs", {"model": "2pc3"})["job"], post("/jobs", {"model": "2pc3"})["job"]
        svc.pump(1)  # admits a; b waits behind max_resident=1
        assert post(f"/jobs/{a}/withdraw") == {"withdrawn": False}
        assert post(f"/jobs/{b}/withdraw") == {"withdrawn": True}
        svc.drain(timeout=300)
        assert (svc.poll(a)["state_count"], svc.poll(a)["unique_state_count"]) == GOLD_2PC3
        assert svc.poll(b)["status"] == "cancelled"
    finally:
        server.shutdown()
        svc.close()


def test_plan_readopts_live_journal_after_previous_run_closed(tmp_path):
    from stateright_tpu_torch.faults import FaultError, FaultPlan, active
    from stateright_tpu_torch.service import CheckService

    plan = FaultPlan().rule("store.append", "io", times=-1)
    p1, p2 = str(tmp_path / "run1.jsonl"), str(tmp_path / "run2.jsonl")
    with active(plan):
        svc1 = CheckService(batch_size=64, table_log2=12, background=False, events_out=p1,
                            device="cpu")
        svc1.pump(1)  # an empty round still adopts
        j1 = svc1._events
        assert plan.events is j1
        with pytest.raises(FaultError):
            plan.fire("store.append", {})
        svc1.close()
        assert plan.events is None
        svc2 = CheckService(batch_size=64, table_log2=12, background=False, events_out=p2,
                            device="cpu")
        plan.events = j1  # a stale, closed adoptee is replaced
        assert j1.closed
        svc2.pump(1)
        assert plan.events is svc2._events
        with pytest.raises(FaultError):
            plan.fire("store.append", {})
        svc2.close()
    assert [e["event"] for e in read_journal(p1)].count("fault.injected") == 1
    assert [e["event"] for e in read_journal(p2)].count("fault.injected") == 1


def test_fenced_journal_of_a_revoked_writer_reads_clean(tmp_path):
    from stateright_tpu_torch.service.lease import FencedEvents, LeaseStore

    ls = LeaseStore(str(tmp_path / "leases"))
    (tmp_path / "j").mkdir()
    router = EventJournal(str(tmp_path / "j" / "router.jsonl"), writer="router")
    rep = FencedEvents(EventJournal(str(tmp_path / "j" / "replica0.jsonl"),
                                    writer="replica0"), ls.grant("replica0"))
    try:
        router.emit("job.submitted", job=1, trace="t")
        rep.emit("replica.admit", job=1, trace="t")
        epoch = ls.revoke("replica0")
        router.emit("lease.revoke", member="replica0", epoch=epoch)
        assert rep.emit("job.done", job=1, trace="t") is None  # gated
        router.emit("job.error", job=1, trace="t", error="replica lost")
    finally:
        rep.close()
        router.close()
        ls.close()
    evs = tl.load_events([str(tmp_path / "j")])
    assert [e["event"] for e in evs].count("lease.reject") == 1
    assert tl.find_anomalies(tl.group_traces(evs)[0]) == []
