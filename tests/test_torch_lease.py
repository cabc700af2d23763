"""The port's epoch-fenced checkpoint leases (stateright_tpu_torch/service/
lease.py and faults/ckptio.py's fenced half) on the CPU: the mirrors of
tests/test_lease.py, its corpus-publish test included (a slow publish runs
off the service lock).

Once the router revokes a member's lease, that member's writes are
harmless: refused at the write, rejected at the read (the open-fd race the
``fleet.zombie_write`` point simulates), dropped at the journal gate and
discarded at the timeline's merge. Lease records and stamped generations
are the JAX package's bytes (tests/test_torch_fleet_interop.py reads them
across packages)."""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from stateright_tpu_torch.faults import FaultPlan, active
from stateright_tpu_torch.faults.ckptio import (
    LEASE_STAMP_KEYS,
    fenced_load_latest,
    fenced_savez,
    lease_stamp,
)
from stateright_tpu_torch.obs import EventJournal
from stateright_tpu_torch.service.lease import (
    FencedEvents,
    LeaseRevoked,
    LeaseStore,
)


# -- the lease store -----------------------------------------------------------


def test_grant_revoke_validate_epoch_monotonic(tmp_path):
    ls = LeaseStore(str(tmp_path))
    try:
        l1 = ls.grant("replica0")
        assert l1.epoch == 1 and l1.valid()
        assert ls.validate("replica0", 1)
        # Revoke persists; validation of the revoked epoch fails, and the
        # next grant bumps the epoch (old tokens NEVER validate again).
        assert ls.revoke("replica0") == 1
        assert not l1.valid()
        l2 = ls.grant("replica0")
        assert l2.epoch == 2 and l2.valid() and not l1.valid()
        # revoke is idempotent; a never-granted member revokes to None.
        assert ls.revoke("replica0") == 2
        assert ls.revoke("replica0") == 2
        assert ls.revoke("ghost") is None
        # acquire (the replica-process boot path) only serves a GRANTED
        # lease.
        with pytest.raises(LeaseRevoked):
            ls.acquire("replica0")
        l3 = ls.grant("replica0")
        got = ls.acquire("replica0")
        assert (got.member, got.epoch) == ("replica0", l3.epoch)
    finally:
        ls.close()


def test_torn_lease_record_fails_safe_and_prev_falls_back(tmp_path):
    ls = LeaseStore(str(tmp_path))
    try:
        lease = ls.grant("replica0")
        path = ls.path_for("replica0")
        # Second write rotates the first record to .prev...
        ls.revoke("replica0")
        with open(path, "r+b") as f:
            f.seek(4)
            f.write(b"\xff\xff")
        # ...so a torn CURRENT record serves the previous one (granted
        # epoch 1): the fence survives a torn lease write.
        assert ls.state("replica0") == (1, "granted")
        assert lease.valid()
        # Both torn: fail SAFE — nothing validates, fenced writers refuse.
        with open(path + ".prev", "r+b") as f:
            f.seek(4)
            f.write(b"\xff\xff")
        assert ls.state("replica0") == (0, "unreadable")
        assert not lease.valid()
    finally:
        ls.close()


def test_revoke_race_chaos_point_leaves_lease_granted(tmp_path):
    ls = LeaseStore(str(tmp_path))
    try:
        lease = ls.grant("replica0")
        plan = FaultPlan().rule("lease.revoke_race", "io", times=1)
        with active(plan):
            with pytest.raises(Exception):
                ls.revoke("replica0")
            # Nothing was persisted: the lease is still granted and the
            # caller's retry (the router's next tick) succeeds.
            assert lease.valid()
            assert ls.revoke("replica0") == 1
            assert not lease.valid()
        assert plan.injected == {"lease.revoke_race:io": 1}
    finally:
        ls.close()


# -- fenced checkpoint IO ------------------------------------------------------


def test_fenced_savez_stamps_and_refuses_after_revoke(tmp_path):
    ls = LeaseStore(str(tmp_path / "leases"))
    try:
        lease = ls.grant("replica0")
        path = str(tmp_path / "job.npz")
        fenced_savez(path, {"x": np.arange(3)}, lease=lease)
        data, src = fenced_load_latest(path, validator=ls.validate)
        assert lease_stamp(data) == ("replica0", 1)
        assert int(np.asarray(data["x"]).sum()) == 3
        ls.revoke("replica0")
        with pytest.raises(LeaseRevoked):
            fenced_savez(path, {"x": np.arange(9)}, lease=lease)
        assert ls.counters["rejected_writes"] == 1
        # The refused write changed NOTHING on disk... but the stamp it
        # carries is now revoked, so later fenced reads reject it too
        # unless the router re-seals (tested below).
        data, _src = fenced_load_latest(path)
        assert int(np.asarray(data["x"]).sum()) == 3
    finally:
        ls.close()


def test_unstamped_legacy_generations_always_pass_the_fence(tmp_path):
    ls = LeaseStore(str(tmp_path / "leases"))
    try:
        path = str(tmp_path / "job.npz")
        fenced_savez(path, {"x": np.arange(4)})  # lease=None: no stamp
        data, _src = fenced_load_latest(path, validator=ls.validate)
        assert lease_stamp(data) is None
        assert int(np.asarray(data["x"]).sum()) == 6
    finally:
        ls.close()


def test_zombie_write_rejected_at_load_after_reseal(tmp_path):
    """The full revoke -> re-seal -> zombie-race -> fenced-read sequence
    the router's death handler performs (the open-fd race simulated by
    the `fleet.zombie_write` bypass chaos point)."""
    ls = LeaseStore(str(tmp_path / "leases"))
    try:
        router = ls.grant("router")
        l0 = ls.grant("replica0")
        path = str(tmp_path / "job.npz")
        fenced_savez(path, {"x": np.asarray([1])}, lease=l0)  # last good gen
        ls.revoke("replica0")
        # Router re-seal: CRC-only load of the pre-revocation generation,
        # re-written under the router's own (never-revoked) lease.
        data, _src = fenced_load_latest(path)
        arrays = {k: data[k] for k in data.files if k not in LEASE_STAMP_KEYS}
        fenced_savez(path, arrays, lease=router)
        # Zombie write through an already-open fd: the bypass kind skips
        # the write-side check — the stale generation LANDS at `path`.
        plan = FaultPlan().rule("fleet.zombie_write", "bypass", times=1)
        with active(plan):
            fenced_savez(path, {"x": np.asarray([666])}, lease=l0)
        assert plan.injected == {"fleet.zombie_write:bypass": 1}
        # The survivor's fenced load REJECTS the stale generation and
        # serves the re-sealed one from .prev — never the zombie's.
        rejected = []
        data, src = fenced_load_latest(
            path, validator=ls.validate,
            on_reject=lambda *a: rejected.append(a),
        )
        assert src.endswith(".prev")
        assert int(np.asarray(data["x"])[0]) == 1
        assert rejected == [(os.path.join(str(tmp_path), "job.npz"),
                             "replica0", 1)]
        assert lease_stamp(data) == ("router", 1)
    finally:
        ls.close()


def test_cross_process_fenced_load_rejects_stale_generation(tmp_path):
    """This process plays the dead replica whose open fd wrote a stale
    generation after the revocation; a second process, the survivor
    resuming the job, must serve the re-sealed generation and never the
    stale one, with no state shared but the files."""
    ls = LeaseStore(str(tmp_path / "leases"))
    try:
        router = ls.grant("router")
        l0 = ls.grant("replica0")
        path = str(tmp_path / "fleetjob1.npz")
        fenced_savez(path, {"gen": np.asarray([1])}, lease=l0)
        ls.revoke("replica0")
        data, _src = fenced_load_latest(path)
        arrays = {k: data[k] for k in data.files if k not in LEASE_STAMP_KEYS}
        fenced_savez(path, arrays, lease=router)  # the re-seal
        with active(FaultPlan().rule("fleet.zombie_write", "bypass")):
            fenced_savez(path, {"gen": np.asarray([666])}, lease=l0)
    finally:
        ls.close()
    code = (
        "from stateright_tpu_torch.faults.ckptio import fenced_load_latest\n"
        "from stateright_tpu_torch.service.lease import LeaseStore\n"
        f"ls = LeaseStore({str(tmp_path / 'leases')!r})\n"
        "rej = []\n"
        f"data, src = fenced_load_latest({path!r}, validator=ls.validate,\n"
        "    on_reject=lambda *a: rej.append(a))\n"
        "assert int(data['gen'][0]) == 1, data['gen']\n"
        "assert src.endswith('.prev'), src\n"
        "assert len(rej) == 1 and rej[0][1:] == ('replica0', 1), rej\n"
        "assert ls.counters['rejected_reads'] == 0  # on_reject owns the count\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


# -- the journal gate ----------------------------------------------------------


def test_fenced_events_gate_drops_terminal_events_after_revoke(tmp_path):
    ls = LeaseStore(str(tmp_path / "leases"))
    try:
        lease = ls.grant("replica0")
        journal = EventJournal(
            str(tmp_path / "replica0.jsonl"), writer="replica0"
        )
        events = FencedEvents(journal, lease)
        # Granted: gated and ungated events pass, stamped with the epoch.
        rec = events.emit("job.done", job=1, trace="t1")
        assert rec["epoch"] == 1
        events.emit("engine.chunk", jobs=[1])
        ls.revoke("replica0")
        # Revoked: gated events are DROPPED (returned None), counted, and
        # recorded as lease.reject evidence; hot-path events still pass.
        assert events.emit("job.done", job=2, trace="t2") is None
        assert events.emit("replica.admit", job=3) is None
        assert events.emit("engine.chunk", jobs=[2]) is not None
        assert ls.counters["rejected_events"] == 2
        events.close()
        from stateright_tpu_torch.obs import read_journal

        names = [e["event"] for e in read_journal(str(tmp_path / "replica0.jsonl"))]
        assert names.count("job.done") == 1
        assert names.count("lease.reject") == 2
        assert "replica.admit" not in names
    finally:
        ls.close()


def test_timeline_fence_drops_post_revocation_gated_events():
    """The merge-time half: a zombie's gated event that beat the journal
    gate (buffered pre-revocation, flushed after) is discarded at merge,
    and never produces a lifecycle anomaly."""
    from stateright_tpu_torch.obs.timeline import fence_events, find_anomalies, group_traces

    base = {"ts": 0.0, "pid": 1}
    events = [
        dict(base, event="job.submitted", writer="router", seq=1, job=1,
             trace="t1", ts=1.0),
        dict(base, event="replica.admit", writer="replica0", seq=1, job=1,
             trace="t1", epoch=1, ts=2.0),
        dict(base, event="lease.revoke", writer="router", seq=2,
             member="replica0", epoch=1, ts=3.0),
        dict(base, event="job.requeued", writer="router", seq=3, job=1,
             trace="t1", src=0, ts=3.5),
        dict(base, event="job.resumed", writer="replica1", seq=1, job=4,
             trace="t1", epoch=1, ts=4.0),
        # The zombie's stale verdict, flushed after the revocation:
        dict(base, event="job.done", writer="replica0", seq=2, job=1,
             trace="t1", epoch=1, ts=4.5),
        dict(base, event="job.done", writer="replica1", seq=2, job=4,
             trace="t1", epoch=1, ts=5.0),
        dict(base, event="job.done", writer="router", seq=4, job=1,
             trace="t1", ts=5.1),
    ]
    kept, rejected = fence_events(events)
    assert [e["writer"] for e in rejected] == ["replica0"]
    assert rejected[0]["event"] == "job.done"
    traces, _untraced = group_traces(kept)
    assert find_anomalies(traces) == []
    # Pre-revocation admissions from the (then-valid) member survive.
    names = [e["event"] for e in traces["t1"]]
    assert "replica.admit" in names and names.count("job.done") == 2


# -- probe backoff ---------------------------------------------------------------


class _FakeReplica:
    """Duck-typed Replica for router-only tests: alive, probe() raises
    when `failing`."""

    def __init__(self, idx, failing=False):
        self.idx = idx
        self.failing = failing
        self.probes = 0
        self.error = None

    @property
    def alive(self):
        return True

    def probe(self):
        self.probes += 1
        if self.failing:
            raise RuntimeError("partitioned")
        return {"replica": self.idx}

    def idle(self):
        return False

    def snapshot_row(self):
        return {"alive": 1}


def test_probe_backoff_defers_failing_member_probes():
    from stateright_tpu_torch.service.router import FleetRouter

    good, bad = _FakeReplica(0), _FakeReplica(1, failing=True)
    router = FleetRouter(
        [good, bad], unhealthy_after=100, steal=False,
        probe_backoff_base=1, probe_backoff_cap=8,
    )
    try:
        for _ in range(40):
            router.tick()
        # The healthy member is probed every tick; the failing member's
        # probes are exponentially deferred (with seeded jitter) — it
        # must NOT eat a probe out of every tick.
        assert good.probes == 40
        assert bad.probes < 15, bad.probes
        s = router.stats()
        assert s["probe_skipped"] > 20
        assert s["probe_failures"] == bad.probes
        # Recovery resets the backoff: probes resume every tick.
        bad.failing = False
        before = bad.probes
        deadline = time.monotonic() + 5
        while bad.probes == before and time.monotonic() < deadline:
            router.tick()
        router.tick()
        router.tick()
        assert bad.probes >= before + 2
    finally:
        router.close()


def test_probe_backoff_does_not_block_death_declaration():
    from stateright_tpu_torch.service.router import FleetRouter

    bad = _FakeReplica(0, failing=True)
    router = FleetRouter([bad], unhealthy_after=3, steal=False)
    try:
        for _ in range(30):
            router.tick()
        assert router.stats()["replica_crashes"] == 1
        assert bad.probes == 3  # exactly unhealthy_after probes, then dead
    finally:
        router.close()


def test_slow_corpus_publish_does_not_stall_unrelated_poll(tmp_path, monkeypatch):
    """While one job's corpus publish is parked in its (off-lock) write, an
    unrelated job's poll answers at once instead of queueing on the service
    lock."""
    import stateright_tpu_torch.store.corpus as corpus_mod
    from stateright_tpu_torch.service import CheckService
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys

    started, release = threading.Event(), threading.Event()
    orig = corpus_mod.CorpusStore.publish

    def slow_publish(self, *a, **kw):
        started.set()
        release.wait(20)
        return orig(self, *a, **kw)

    monkeypatch.setattr(corpus_mod.CorpusStore, "publish", slow_publish)
    svc = CheckService(batch_size=128, table_log2=14, store="tiered", summary_log2=16,
                       corpus_dir=str(tmp_path / "corpus"), background=True, device="cpu")
    try:
        m = TensorTwoPhaseSys(3)
        h1 = svc.submit(m)
        assert started.wait(120), "publisher never reached the corpus"
        h2 = svc.submit(m)
        t0 = time.monotonic()
        out = svc.poll(h2.id)
        dt = time.monotonic() - t0
        assert out["id"] == h2.id
        assert dt < 1.0, f"poll stalled {dt:.2f}s behind a corpus publish"
        release.set()
        r1 = h1.result(timeout=120)
        assert (r1.state_count, r1.unique_state_count) == (1_146, 288)
        assert r1.detail["corpus"]["published"] is True
        h2.result(timeout=120)
    finally:
        release.set()
        svc.close()
