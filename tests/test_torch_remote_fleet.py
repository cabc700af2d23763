"""The port's fleet across processes (stateright_tpu_torch/service/
{remote,replica_main,discovery}.py behind ServiceFleet(remote=True)) on
the CPU: replicas as `replica_main` processes with device="cpu" over one
shared store root.

The fast test runs two replica processes, pins five 2pc-3 jobs to one of
them and kills it with SIGKILL mid-backlog: every job finishes at the
golden with the discoveries and depth of the JAX package's single-replica
service, the lease of the dead replica is revoked before its jobs are
requeued, and the port's timeline CLI finds no anomaly in the journals.
The slow tests mirror tests/test_remote_fleet.py: the SIGSTOP zombie, and
the chaos matrix (tests/fleet_procs_matrix.py) over every store backend.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time

import pytest

from fleet_procs_matrix import (
    GOLD_2PC3,
    REF,
    REPO,
    SVC_KW,
    run_matrix,
    run_timeline,
    start_fleet,
    wait_crashes,
    zombie_rejections,
)
from stateright_tpu_torch.knobs import BLOB_BACKENDS
from stateright_tpu_torch.service import ServiceFleet
from stateright_tpu_torch.service.server import ModelRegistry


def _jax_single_replica():
    """The JAX package's single-replica service on 2pc-3: (depth,
    discoveries)."""
    from stateright_tpu.service import CheckService
    from stateright_tpu.tensor.models import TensorTwoPhaseSys

    svc = CheckService(batch_size=128, table_log2=14, background=False)
    try:
        h = svc.submit(TensorTwoPhaseSys(3))
        svc.drain()
        r = h.result()
        assert (r.state_count, r.unique_state_count) == GOLD_2PC3
        return r.max_depth, dict(r.discoveries)
    finally:
        svc.close()


def test_remote_fleet_kill9_requeues_every_job_at_the_jax_golden(tmp_path):
    fleet = ServiceFleet(
        n_replicas=2, remote=True, store_root=str(tmp_path), max_resident=1,
        service_kwargs=SVC_KW, router_kwargs=dict(steal=False),
    )
    reg = ModelRegistry()
    try:
        assert fleet.scratch_dir == str(tmp_path)
        handles = [fleet.submit(reg.get(*REF), model_ref=REF) for _ in range(5)]
        owners = {h._job.replica for h in handles}
        assert len(owners) == 1  # one route key: one owner holds the backlog
        victim = fleet.replicas[owners.pop()]
        deadline = time.monotonic() + 60
        while (victim._last_probe.get("device_steps") or 0) < 1:
            assert time.monotonic() < deadline, "the victim never stepped"
            time.sleep(0.02)
        os.kill(victim.proc.pid, signal.SIGKILL)
        wait_crashes(fleet, 1)
        fleet.drain(timeout=120)
        results = [h.result() for h in handles]
        s = fleet.stats()
        survivor = next(r for r in fleet.replicas if r is not victim)
        resume = survivor._get_json("/.status")["resume"]
        assert all(r.boot_s > 0 for r in fleet.replicas)
    finally:
        fleet.close()
    depth, discoveries = _jax_single_replica()
    for r in results:
        assert (r.state_count, r.unique_state_count) == GOLD_2PC3 and r.complete
        assert r.max_depth == depth
        assert r.discoveries == discoveries  # the JAX package's u64 values
    assert any(v >= 1 << 63 for v in discoveries.values())  # a top-bit print crossed
    assert s["replica_crashes"] == 1 and s["lease_revokes"] == 1
    assert s["requeued_jobs"] >= 1
    # The survivor's side of the recovery: the generations it loaded, the
    # journal rows it re-seeded, a resumed job's first step.
    assert resume["resumes"] == s["restored_jobs"] >= 1
    assert resume["reseed_rows"] > 0 and resume["first_step_ts"] is not None
    assert 0 < resume["load_npz_s"] <= resume["load_s"]
    report = run_timeline(str(tmp_path / "journal"))
    assert report["anomalies"] == [] and len(report["traces"]) == 5
    # The children ran the port alone, on the device they were given.
    for name in ("replica0.log", "replica1.log"):
        with open(tmp_path / "logs" / name) as f:
            ready = [ln for ln in f if ln.startswith("REPLICA_READY")]
        assert len(ready) == 1 and "device=cpu foreign_modules=[]" in ready[0]


def test_remote_fleet_refuses_a_device_object_and_a_model_object(tmp_path):
    import torch

    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys

    with pytest.raises(TypeError, match="device"):
        ServiceFleet(n_replicas=1, remote=True, store_root=str(tmp_path / "a"),
                     service_kwargs=dict(device=torch.device("cpu")))
    assert not os.path.exists(tmp_path / "a" / "logs")  # nothing was spawned
    fleet = ServiceFleet(n_replicas=1, remote=True, store_root=str(tmp_path / "b"),
                         service_kwargs=dict(SVC_KW))
    try:
        with pytest.raises(TypeError, match="model_ref"):
            fleet.submit(TensorTwoPhaseSys(3))
    finally:
        fleet.close()


@pytest.mark.slow
def test_remote_fleet_zombie_replica_fenced_and_bit_identical(tmp_path):
    fleet, handles, victim = start_fleet(str(tmp_path))
    try:
        os.kill(victim.proc.pid, signal.SIGSTOP)
        wait_crashes(fleet, 1)
        os.kill(victim.proc.pid, signal.SIGCONT)  # the zombie rises
        fleet.drain(timeout=300)
        results = [h.result() for h in handles]
        for r in results:
            assert (r.state_count, r.unique_state_count) == GOLD_2PC3 and r.complete
        for r in results[1:]:
            assert (r.discoveries, r.max_depth) == (results[0].discoveries, results[0].max_depth)
        s = fleet.stats()
        assert s["replica_crashes"] == 1 and s["lease_revokes"] == 1
        assert s["requeued_jobs"] >= 1
        assert zombie_rejections(victim) > 0, "the zombie wrote nothing or was not fenced"
    finally:
        fleet.close()
    report = run_timeline(str(tmp_path / "journal"))
    assert report["anomalies"] == [] and len(report["traces"]) == 5


@pytest.mark.slow
@pytest.mark.parametrize("backend", list(BLOB_BACKENDS))
def test_fleet_procs_full_matrix(backend):
    run_matrix(backend, log=lambda _msg: None)


def test_replica_process_exits_when_its_parent_dies(tmp_path):
    """A replica process never outlives its fleet: started by a parent
    that is killed -9, it sees its parent go and exits on its own."""
    code = f"""
import sys, time
sys.path.insert(0, {REPO!r})
from stateright_tpu_torch.service import ServiceFleet
f = ServiceFleet(n_replicas=1, remote=True, store_root={str(tmp_path)!r},
                 service_kwargs=dict(device="cpu", batch_size=64, table_log2=12))
print(f.replicas[0].proc.pid, flush=True)
time.sleep(600)
"""
    parent = subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              stdout=subprocess.PIPE, text=True)
    try:
        child = int(parent.stdout.readline())
        parent.kill()
        parent.wait(timeout=10)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            try:
                os.kill(child, 0)
            except ProcessLookupError:
                break
            time.sleep(0.1)
        else:
            os.kill(child, signal.SIGKILL)
            pytest.fail("the replica process outlived its parent")
    finally:
        if parent.poll() is None:
            parent.kill()
    with open(tmp_path / "logs" / "replica0.log") as f:
        assert re.search(r"REPLICA_EXIT member=replica0 foreign_modules=\[\]", f.read())


def test_a_child_without_its_card_fails_its_boot_with_its_log(tmp_path):
    """With no device given a replica process runs on the card; on a box
    without one it fails its boot, and `spawn_replica_proc` raises with
    the tail of the child's log."""
    import torch

    from stateright_tpu_torch.service.lease import LeaseStore
    from stateright_tpu_torch.service.remote import spawn_replica_proc

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the child would boot on it")
    store = LeaseStore(str(tmp_path / "leases"))
    try:
        store.grant("replica0")
        with pytest.raises(RuntimeError, match="exited during startup") as ei:
            spawn_replica_proc(0, str(tmp_path), dict(batch_size=64, table_log2=12),
                               timeout_s=60)
    finally:
        store.close()
    assert "cuda" in str(ei.value).lower()
    members = tmp_path / "members"  # it never published a member record
    assert not members.exists() or not list(members.iterdir())
