"""The process-fleet chaos matrix of the port, on the CPU: five phases over
one store backend (kill -9, a SIGSTOP zombie, an injected partition, a
rejoin after kill -9, and an autoscale out and in under a partition and a
zombie), each on a fresh three-process fleet of 2pc-3 jobs, each checked
at the golden counts with a clean timeline. The JAX package's matrix with
the port's modules; tests/test_torch_remote_fleet.py runs it (slow).

It imports only the port, so the replica processes it starts import only
the port too."""

import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import urllib.request

GOLD_2PC3 = (1_146, 288)
REF = ("2pc", {"n": 3})
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SVC_KW = dict(batch_size=128, table_log2=14, device="cpu")


def start_fleet(root, n_jobs=5):
    """A three-process fleet on `root` with `n_jobs` 2pc-3 jobs pinned to
    one replica (one route key, max_resident=1, no stealing), returned
    once that victim has taken a device step."""
    from stateright_tpu_torch.service import ServiceFleet
    from stateright_tpu_torch.service.server import ModelRegistry

    fleet = ServiceFleet(
        n_replicas=3, remote=True, store_root=root, max_resident=1,
        service_kwargs=SVC_KW,
        router_kwargs=dict(probe_timeout_s=0.5, unhealthy_after=2, steal=False),
    )
    reg = ModelRegistry()
    handles = [fleet.submit(reg.get(*REF), model_ref=REF) for _ in range(n_jobs)]
    victim = fleet.replicas[handles[0]._job.replica]
    wait_steps(victim)
    return fleet, handles, victim


def wait_steps(replica, timeout=120.0):
    """Until `replica` answers its probe with at least one device step."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            if replica._get_json("/.probe", timeout=1.0).get("device_steps", 0) >= 1:
                return
        except Exception:  # noqa: BLE001 — not up yet
            pass
        time.sleep(0.02)
    raise TimeoutError("victim never stepped")


def wait_crashes(fleet, n, timeout=90.0):
    deadline = time.monotonic() + timeout
    while fleet.stats()["replica_crashes"] < n:
        assert time.monotonic() < deadline, fleet.stats()
        time.sleep(0.05)


def check_golden(handles):
    for h in handles:
        r = h.result()
        assert (r.state_count, r.unique_state_count) == GOLD_2PC3


def zombie_rejections(victim, timeout=30.0):
    """The victim process's own lease `rejected_total`, read over its
    still-serving HTTP plane (that it still answers is the point)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            st = json.loads(urllib.request.urlopen(victim.base_url + "/.status", timeout=2).read())
            rej = st.get("lease", {}).get("rejected_total", 0)
            if rej > 0:
                return rej
        except Exception:  # noqa: BLE001 — retry inside the window
            pass
        time.sleep(0.1)
    return 0


def run_timeline(journal_root):
    """The port's timeline CLI in a process of its own, over a local or a
    wire journal root; returns its --json report."""
    proc = subprocess.run(
        [sys.executable, "-m", "stateright_tpu_torch.obs.timeline", journal_root, "--json"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-800:])
    return json.loads(proc.stdout.strip().splitlines()[-1])


class Roots:
    """Fresh store roots on one backend: temporary directories, or fresh
    prefixes on one emulator of this process, whose endpoint and
    credential environment is installed so the replica processes (which
    inherit it) sign against the same emulator."""

    def __init__(self, backend):
        self.backend = backend
        self._srv = None
        self._env_saved = None
        self._n = 0
        self._dirs = []
        if backend != "file":
            from stateright_tpu_torch.faults.blobstore import serve_blobd

            self._srv = serve_blobd(dialect=backend)
            if self._srv.env:
                self._env_saved = {k: os.environ.get(k) for k in self._srv.env}
                os.environ.update(self._srv.env)

    def fresh(self, tag):
        self._n += 1
        if self.backend == "file":
            d = tempfile.TemporaryDirectory(prefix=f"srtpu-procs-{tag}-")
            self._dirs.append(d)
            return d.name
        return f"{self._srv.root_uri}/{tag}{self._n}"

    def journal_root(self, root):
        return os.path.join(root, "journal") if self.backend == "file" else root + "/journal"

    def close(self):
        if self._env_saved:
            for key, old in self._env_saved.items():
                if old is None:
                    os.environ.pop(key, None)
                else:
                    os.environ[key] = old
        if self._srv is not None:
            self._srv.shutdown()
        for d in self._dirs:
            d.cleanup()


def run_matrix(backend, log=print) -> None:
    from stateright_tpu_torch.faults import FaultPlan, active

    roots = Roots(backend)
    try:
        log(f"== [{backend}] phase 1: kill -9 the victim mid-backlog ==")
        root = roots.fresh("kill9")
        fleet, handles, victim = start_fleet(root)
        try:
            os.kill(victim.proc.pid, signal.SIGKILL)
            wait_crashes(fleet, 1)
            fleet.drain(timeout=300)
            check_golden(handles)
            s = fleet.stats()
            assert s["lease_revokes"] == 1 and s["requeued_jobs"] >= 1, s
        finally:
            fleet.close()
        assert run_timeline(roots.journal_root(root))["anomalies"] == []

        log(f"== [{backend}] phase 2: SIGSTOP -> declared dead -> SIGCONT zombie ==")
        root = roots.fresh("zombie")
        fleet, handles, victim = start_fleet(root)
        try:
            os.kill(victim.proc.pid, signal.SIGSTOP)
            wait_crashes(fleet, 1)
            os.kill(victim.proc.pid, signal.SIGCONT)
            fleet.drain(timeout=300)
            check_golden(handles)
            assert zombie_rejections(victim) > 0, "the zombie was not fenced"
        finally:
            fleet.close()
        assert run_timeline(roots.journal_root(root))["anomalies"] == []

        log(f"== [{backend}] phase 3: injected router<->replica partition ==")
        root = roots.fresh("part")
        fleet, handles, victim = start_fleet(root)
        try:
            plan = FaultPlan().rule("fleet.partition", "io", times=-1,
                                    match={"replica": victim.idx})
            if backend != "file":
                plan.rule("blob.put", "http", times=2)
                plan.rule("blob.put", "torn", times=1, after=4)
            with active(plan):
                wait_crashes(fleet, 1)
                fleet.drain(timeout=300)
            check_golden(handles)
            assert plan.injected_total() >= 1
            assert zombie_rejections(victim) > 0, "the partitioned replica was not fenced"
            assert fleet.stats()["lease_revokes"] == 1
        finally:
            fleet.close()
        assert run_timeline(roots.journal_root(root))["anomalies"] == []

        log(f"== [{backend}] phase 4: kill -9 -> rejoin mid-backlog ==")
        root = roots.fresh("rejoin")
        fleet, handles, victim = start_fleet(root, n_jobs=6)
        try:
            os.kill(victim.proc.pid, signal.SIGKILL)
            wait_crashes(fleet, 1)
            assert fleet.rejoin_replica(victim.idx), "rejoin refused"
            deadline = time.monotonic() + 90
            while fleet.stats()["rejoin_promotions"] < 1:
                assert time.monotonic() < deadline, fleet.stats()
                time.sleep(0.05)
            fleet.drain(timeout=300)
            check_golden(handles)
            s = fleet.stats()
            assert s["rejoins"] == 1 and s["rejoin_promotions"] == 1, s
        finally:
            fleet.close()
        assert run_timeline(roots.journal_root(root))["anomalies"] == []

        log(f"== [{backend}] phase 5: autoscale out and in under a partition and a zombie ==")
        root = roots.fresh("autoscale")
        fleet, handles, victim = start_fleet(root, n_jobs=6)
        try:
            partner = fleet.replicas[(victim.idx + 1) % 3]
            plan = FaultPlan().rule("fleet.partition", "io", times=-1,
                                    match={"replica": partner.idx})
            plan.rule("fleet.autoscale", "crash", times=1)
            with active(plan):
                os.kill(victim.proc.pid, signal.SIGSTOP)
                wait_crashes(fleet, 2)
                n_before = len(fleet.replicas)
                assert fleet.scale_out() is None, "the injected fault did not abort the grow"
                assert len(fleet.replicas) == n_before
                assert fleet.scale_out() is not None, "scale_out refused"
                deadline = time.monotonic() + 90
                while fleet.stats()["rejoin_promotions"] < 1:
                    assert time.monotonic() < deadline, fleet.stats()
                    time.sleep(0.05)
                os.kill(victim.proc.pid, signal.SIGCONT)
                assert fleet.scale_in() is not None, "scale_in refused"
                fleet.drain(timeout=300)
            check_golden(handles)
            assert zombie_rejections(victim) > 0, "the zombie was not fenced"
            s = fleet.stats()
            assert s["scale_outs"] == 1 and s["scale_ins"] == 1, s
        finally:
            fleet.close()
        assert run_timeline(roots.journal_root(root))["anomalies"] == []
    finally:
        roots.close()
