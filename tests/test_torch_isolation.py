"""The port stands alone: it imports torch and never jax or the JAX package,
and its entry point runs on the CUDA card unless the caller asks for the
CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "stateright_tpu_torch"


def _imported_roots(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path",
    sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "stateright_tpu"}


def test_running_the_port_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys\n"
        "c = TensorTwoPhaseSys(3).checker().spawn_cuda(table_log2=12, device='cpu').join()\n"
        "assert (c.state_count(), c.unique_state_count()) == (1146, 288)\n"
        "c.discoveries()\n"
        "t = TensorTwoPhaseSys(3).checker().spawn_cuda(batch_size=16, table_log2=9,\n"
        "    store='tiered', high_water=0.5, summary_log2=12, device='cpu').join()\n"
        "assert t.unique_state_count() == 288 and t.store_stats()['spill_events'] >= 1\n"
        "t.discoveries()\n"
        "s = TensorTwoPhaseSys(3, symmetry=True).checker().spawn_cuda(table_log2=12,\n"
        "    device='cpu').join()\n"
        "assert s.unique_state_count() < 288 and set(s.discoveries()) == set(c.discoveries())\n"
        "from stateright_tpu_torch.tensor import TensorPaxos\n"
        "p = TensorPaxos(1).checker().spawn_cuda(table_log2=12, device='cpu').join()\n"
        "assert (p.state_count(), p.unique_state_count()) == (482, 265)\n"
        "p.discoveries()\n"
        "import os, tempfile\n"
        "from stateright_tpu_torch.tensor.resident import ResidentSearch\n"
        "rs = ResidentSearch(TensorTwoPhaseSys(3), 64, 12, device='cpu')\n"
        "assert not rs.run(max_steps=3).complete\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    ckpt = os.path.join(d, 'c.npz')\n"
        "    rs.checkpoint(ckpt)\n"
        "    r = ResidentSearch.load_checkpoint(TensorTwoPhaseSys(3), ckpt, table_log2=13,\n"
        "        device='cpu').run()\n"
        "assert (r.state_count, r.unique_state_count) == (1146, 288) and r.complete\n"
        "from stateright_tpu_torch.actor.test_util import PingPongCfg\n"
        "from stateright_tpu_torch.tensor.lowering import lower_actor_model, refine_check\n"
        "pp = PingPongCfg(max_nat=5).into_model().with_lossy_network(True)\n"
        "lw = lower_actor_model(pp, local_boundary=lambda i, s: s <= 5,\n"
        "    boundary=lambda v: (lambda f: lambda s: (f(s) <= 5).all(1))(\n"
        "        v.actor_feature(lambda i, s: s)))\n"
        "c = lw.checker().spawn_cuda(batch_size=512, table_log2=16, device='cpu').join()\n"
        "assert c.unique_state_count() == 4094\n"
        "rr, _ = refine_check(PingPongCfg(max_nat=3).into_model(), batch_size=32,\n"
        "    table_log2=10, seed_states=2, device='cpu', boundary=lambda v: (lambda f:\n"
        "    lambda s: (f(s) <= 3).all(1))(v.actor_feature(lambda i, s: s)))\n"
        "assert rr.unique_state_count == 7 and rr.complete\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', 'stateright_tpu')\n"
        "       or m.startswith(('jax.', 'jaxlib.', 'stateright_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_spawn_cuda_defaults_to_the_card():
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys

    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device; the default runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        TensorTwoPhaseSys(3).checker().spawn_cuda(table_log2=12)


def test_new_entry_points_run_without_jax():
    """The host-driven engine, the device simulation, visitors, telemetry
    and tracing load neither jax nor the JAX package."""
    code = (
        "import os, sys, tempfile\n"
        "from stateright_tpu_torch.core.visitor import PathRecorder\n"
        "from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys\n"
        "from stateright_tpu_torch.tensor.frontier import FrontierSearch\n"
        "from stateright_tpu_torch.tensor.simulation import DeviceSimulation\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    c = TensorTwoPhaseSys(3).checker().trace_out(os.path.join(d, 't.json'))\\\n"
        "        .spawn_cuda(table_log2=12, resident=False, device='cpu').join()\n"
        "    assert (c.state_count(), c.unique_state_count()) == (1146, 288)\n"
        "    c.discoveries()\n"
        "    fs = FrontierSearch(TensorTwoPhaseSys(3), 64, 12, device='cpu')\n"
        "    fs.run(max_steps=3)\n"
        "    fs.checkpoint(os.path.join(d, 'f.npz'))\n"
        "    r = FrontierSearch.load_checkpoint(TensorTwoPhaseSys(3), os.path.join(d, 'f.npz'),\n"
        "        batch_size=64, device='cpu').run()\n"
        "    assert (r.state_count, r.unique_state_count) == (1146, 288)\n"
        "    rec = PathRecorder()\n"
        "    TensorTwoPhaseSys(3).checker().visitor(rec).spawn_cuda(table_log2=12,\n"
        "        device='cpu').join()\n"
        "    assert len(rec.paths) == 288\n"
        "    sim = DeviceSimulation(TensorTwoPhaseSys(3), seed=5, traces=64, max_depth=64,\n"
        "        dedup='shared', table_log2=14, walks=512, stale_limit=4, device='cpu')\n"
        "    r = sim.run()\n"
        "    assert (r.state_count, r.unique_state_count) == (2253, 126)\n"
        "    sim.discovery_path('abort agreement')\n"
        "    sim.checkpoint(os.path.join(d, 's.npz'))\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', 'stateright_tpu')\n"
        "       or m.startswith(('jax.', 'jaxlib.', 'stateright_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_new_entry_points_default_to_the_card():
    from stateright_tpu_torch.tensor.frontier import FrontierSearch
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys
    from stateright_tpu_torch.tensor.simulation import DeviceSimulation

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the defaults run there")
    with pytest.raises(RuntimeError, match="cuda"):
        FrontierSearch(TensorTwoPhaseSys(3), 64, 12)
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceSimulation(TensorTwoPhaseSys(3), traces=8, max_depth=8)
    with pytest.raises(RuntimeError, match="cuda"):
        TensorTwoPhaseSys(3).checker().spawn_simulation(device=True, traces=8, max_depth=8)
    with pytest.raises(RuntimeError, match="cuda"):
        TensorTwoPhaseSys(3).checker().spawn_cuda(mode="simulation", traces=8, max_depth=8)
    with pytest.raises(RuntimeError, match="cuda"):
        TensorTwoPhaseSys(3).checker().spawn_cuda(table_log2=12, resident=False)


def test_sharded_search_runs_without_jax():
    """The sharded engine's ranks and the process that spawns them load
    neither jax nor the JAX package."""
    code = (
        "import sys\n"
        "sys.path.insert(0, 'tests')\n"
        "import sharded_ranks\n"
        "from stateright_tpu_torch.parallel import run_world\n"
        "if __name__ == '__main__':\n"
        "    assert run_world(sharded_ranks.loaded_jax_modules, 2, device='cpu') == [[], []]\n"
        "    bad = [m for m in sys.modules if m in ('jax', 'jaxlib', 'stateright_tpu')\n"
        "           or m.startswith(('jax.', 'jaxlib.', 'stateright_tpu.'))]\n"
        "    assert not bad, bad\n"
        "    print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=180,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_sharded_entry_points_default_to_the_card():
    """ShardedSearch, run_world and init_world go to the card unless asked
    for the CPU; a CUDA device in a gloo group raises."""
    import sharded_ranks
    from stateright_tpu_torch.parallel import ShardedSearch, init_world, run_world
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the defaults run there")
    with pytest.raises(RuntimeError, match="cuda"):
        ShardedSearch(TensorTwoPhaseSys(3), table_log2=12)
    with pytest.raises(RuntimeError, match="cuda"):
        run_world(sharded_ranks.world_of_1, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        init_world()
    (msg,) = run_world(sharded_ranks.cuda_in_a_gloo_group, 1, device="cpu", timeout=120)
    assert "nccl" in msg and "gloo" in msg


def test_the_check_service_runs_without_jax():
    """The check service, its HTTP front end, the chaos plane and the
    event journal load neither jax nor the JAX package."""
    code = (
        "import json, os, sys, tempfile, urllib.request\n"
        "from stateright_tpu_torch import faults\n"
        "from stateright_tpu_torch.service import CheckService, serve_service\n"
        "from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    svc = CheckService(batch_size=64, table_log2=12, device='cpu',\n"
        "        events_out=os.path.join(d, 'j.jsonl'))\n"
        "    srv = serve_service(svc, 'localhost:0')\n"
        "    req = urllib.request.Request('http://' + srv.address + '/jobs', method='POST',\n"
        "        data=json.dumps({'model': '2pc', 'args': {'n': 3}}).encode())\n"
        "    jid = json.loads(urllib.request.urlopen(req, timeout=30).read())['job']\n"
        "    with faults.active(faults.FaultPlan().rule('service.step', 'xla', times=1)):\n"
        "        svc.drain(timeout=60)\n"
        "    r = svc.result(jid)\n"
        "    assert (r.state_count, r.unique_state_count) == (1146, 288)\n"
        "    assert svc.stats()['faults']['retries'] == 1\n"
        "    assert set(svc.discovery_paths(jid)) == {'abort agreement', 'commit agreement'}\n"
        "    srv.shutdown()\n"
        "    svc.close()\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', 'stateright_tpu')\n"
        "       or m.startswith(('jax.', 'jaxlib.', 'stateright_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_the_fleet_runs_without_jax():
    """A foreground fleet of two replicas through a crash, with leases,
    journals and the timeline CLI, loads neither jax nor the JAX package."""
    code = (
        "import os, sys, tempfile\n"
        "from stateright_tpu_torch import faults\n"
        "from stateright_tpu_torch.obs import timeline\n"
        "from stateright_tpu_torch.service import ServiceFleet\n"
        "from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys\n"
        "m = TensorTwoPhaseSys(3)\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    fleet = ServiceFleet(n_replicas=2, background=False,\n"
        "        service_kwargs=dict(batch_size=64, table_log2=12, device='cpu'),\n"
        "        lease_dir=os.path.join(d, 'leases'), journal_dir=os.path.join(d, 'j'))\n"
        "    hs = [fleet.submit(m) for _ in range(2)]\n"
        "    victim = hs[0]._job.replica\n"
        "    plan = faults.FaultPlan().rule('fleet.replica_crash', 'crash', after=4,\n"
        "        match={'replica': victim})\n"
        "    with faults.active(plan):\n"
        "        fleet.drain(timeout=120)\n"
        "    assert all((h.result().state_count, h.result().unique_state_count)\n"
        "               == (1146, 288) for h in hs)\n"
        "    s = fleet.stats()\n"
        "    assert s['replica_crashes'] == 1 and s['restored_jobs'] >= 1, s\n"
        "    fleet.close()\n"
        "    assert timeline.main([os.path.join(d, 'j'), '--json']) == 0\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', 'stateright_tpu')\n"
        "       or m.startswith(('jax.', 'jaxlib.', 'stateright_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_fleet_services_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs there")
    from stateright_tpu_torch.service import ServiceFleet

    with pytest.raises(RuntimeError, match="cuda"):
        ServiceFleet(n_replicas=1, background=False,
                     service_kwargs=dict(batch_size=64, table_log2=12))


def test_unported_fleet_surfaces_raise_naming_their_item(tmp_path):
    """The fleet surfaces that once raised naming ROADMAP A item 3 now work:
    a remote fleet builds on a wire store root, every wire scheme resolves
    to its store against the in-repo emulators and carries checkpoint
    generations and records, an in-process fleet takes wire dirs, and
    `scale_out` / `scale_in` act on a foreground fleet."""
    from stateright_tpu_torch.faults.blobstore import (
        HTTPBlobStore,
        blob_backend,
        serve_blobd,
    )
    from stateright_tpu_torch.faults.blobstore_gcs import GCSBlobStore
    from stateright_tpu_torch.faults.blobstore_s3 import S3BlobStore
    from stateright_tpu_torch.faults.ckptio import (
        atomic_savez,
        load_latest,
        read_record_latest,
        write_record,
    )
    from stateright_tpu_torch.service import ServiceFleet

    # The warm-start corpus: a fleet over one corpus directory builds, each
    # replica on a tiered store with the corpus attached and fenced by its
    # lease.
    fleet = ServiceFleet(n_replicas=2, background=False, corpus_dir=str(tmp_path / "c"),
                         lease_dir=str(tmp_path / "l"),
                         service_kwargs=dict(batch_size=64, table_log2=12, device="cpu"))
    try:
        for rep in fleet.replicas:
            corpus = rep.service._engine._corpus
            assert rep.service._engine.store == "tiered" and corpus is not None
            assert corpus.root == str(tmp_path / "c") and corpus._lease is rep.lease
    finally:
        fleet.close()
    servers = {d: serve_blobd(dialect=d) for d in ("blob", "s3", "gs")}
    saved = {k: os.environ.get(k) for srv in servers.values() for k in srv.env}
    try:
        for srv in servers.values():
            os.environ.update(srv.env)
        kinds = {"blob": HTTPBlobStore, "s3": S3BlobStore, "gs": GCSBlobStore}
        for dialect, srv in servers.items():
            uri = srv.root_uri + "/r"
            assert isinstance(blob_backend(uri), kinds[dialect])
            atomic_savez(uri + "/x.npz", {"a": np.arange(3)})
            assert list(load_latest(uri + "/x.npz")[0]["a"]) == [0, 1, 2]
            write_record(uri + "/lease", b"{}", b"SRTPLSE1")
            assert read_record_latest(uri + "/lease", b"SRTPLSE1") == (b"{}", True)
        blob = servers["blob"].root_uri
        # An in-process fleet with its corpus and leases on a wire store.
        fleet = ServiceFleet(n_replicas=1, background=False, corpus_dir=blob + "/corpus",
                             lease_dir=blob + "/leases",
                             service_kwargs=dict(batch_size=64, table_log2=12, device="cpu"))
        try:
            assert fleet.replicas[0].service._engine._corpus.root == blob + "/corpus"
            assert fleet.lease_store.state("replica0") == (1, "granted")
        finally:
            fleet.close()
        # A remote fleet on a wire root: its children's logs and the local
        # halves of the journals go to a scratch directory of this host.
        fleet = ServiceFleet(n_replicas=1, remote=True, store_root=blob + "/fleet",
                             service_kwargs=dict(batch_size=64, table_log2=12, device="cpu"))
        try:
            assert fleet.scratch_dir is not None and os.path.isdir(fleet.scratch_dir)
            assert os.path.exists(os.path.join(fleet.scratch_dir, "logs", "replica0.log"))
            assert fleet.replicas[0].probe()["device"] == "cpu"
        finally:
            fleet.close()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for srv in servers.values():
            srv.shutdown()
    fleet = ServiceFleet(n_replicas=1, background=False,
                         service_kwargs=dict(batch_size=64, table_log2=12, device="cpu"))
    try:
        assert fleet.scale_in() is None  # never the last member
        assert fleet.scale_out() == 1
        assert fleet.scale_in() is None  # the new member is in probation
        fleet.pump(rounds=4)  # its probation probes pass
        assert fleet.scale_in() in (0, 1)
        s = fleet.stats()
        assert (s["scale_outs"], s["scale_ins"]) == (1, 1)
    finally:
        fleet.close()


def test_replica_processes_run_without_jax(tmp_path):
    """A remote fleet's replica process runs a job on the port alone: its
    own `sys.modules`, read from its log at boot and at exit, holds neither
    jax nor the JAX package."""
    from stateright_tpu_torch.service import ServiceFleet
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys

    fleet = ServiceFleet(n_replicas=1, remote=True, store_root=str(tmp_path),
                         service_kwargs=dict(batch_size=64, table_log2=12, device="cpu"))
    try:
        h = fleet.submit(TensorTwoPhaseSys(3), model_ref=("2pc", {"n": 3}))
        r = h.result(timeout=120)
        assert (r.state_count, r.unique_state_count) == (1146, 288)
    finally:
        fleet.close()
    log = (tmp_path / "logs" / "replica0.log").read_text()
    lines = [ln for ln in log.splitlines() if ln.startswith(("REPLICA_READY", "REPLICA_EXIT"))]
    assert [ln.split()[0] for ln in lines] == ["REPLICA_READY", "REPLICA_EXIT"], log
    assert all(ln.endswith("foreign_modules=[]") for ln in lines), lines


def test_host_checkers_load_neither_torch_nor_jax():
    """A plain host `Model` on the host checkers and the Explorer loads no
    torch (the tensor model stays a lazy import) and nothing of jax."""
    code = (
        "import json, sys, urllib.request\n"
        "import stateright_tpu_torch as sr\n"
        "from stateright_tpu_torch.fixtures import LinearEquation\n"
        "from stateright_tpu_torch.examples.two_phase_commit import TwoPhaseSys\n"
        "m = LinearEquation(2, 10, 14)\n"
        "assert m.checker().spawn_bfs().join().unique_state_count() == 12\n"
        "assert m.checker().spawn_dfs().join().unique_state_count() == 55\n"
        "assert m.checker().spawn_simulation(7).join().state_count() == 4\n"
        "c = TwoPhaseSys(3).checker().symmetry().spawn_on_demand().join()\n"
        "assert c.unique_state_count() == 288\n"
        "srv = TwoPhaseSys(3).checker().serve('localhost:0')\n"
        "v = json.loads(urllib.request.urlopen('http://' + srv.address + '/.states/').read())\n"
        "srv.shutdown()\n"
        "assert len(v) == 1 and sr.Model and sr.CheckerBuilder\n"
        "bad = [m for m in sys.modules if m in ('torch', 'jax', 'jaxlib', 'stateright_tpu')\n"
        "       or m.startswith(('torch.', 'jax.', 'jaxlib.', 'stateright_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_actor_runtime_native_bridge_and_clis_run_without_jax():
    """Spawned actors over UDP, the native serializer (its library built
    into the port's `_build/`, never the JAX package's `_native/build/`),
    the example CLIs and the sequence diagram load neither jax nor the JAX
    package."""
    code = (
        "import contextlib, io, sys\n"
        "from pathlib import Path\n"
        "from stateright_tpu_torch.actor.spawn import local_ids, spawn\n"
        "from stateright_tpu_torch.actor.test_util import Ping, PingPongActor, Pong\n"
        "from stateright_tpu_torch.examples.__main__ import main\n"
        "from stateright_tpu_torch.examples.paxos import PaxosModelCfg\n"
        "from stateright_tpu_torch.semantics import LinearizabilityTester, Register\n"
        "from stateright_tpu_torch.semantics import Read, ReadOk, Write, WriteOk\n"
        "from stateright_tpu_torch.semantics import _native_bridge as nb\n"
        "a, b = local_ids(2)\n"
        "threads, stop = spawn([(a, PingPongActor(serve_to=b)), (b, PingPongActor())],\n"
        "    msg_types=[Ping, Pong], block=False)\n"
        "stop.set()\n"
        "[t.join(timeout=3) for t in threads]\n"
        "assert not any(t.is_alive() for t in threads)\n"
        "t = LinearizabilityTester(Register('A')).on_invoke(0, Write('B')).on_return(0,\n"
        "    WriteOk()).on_invoke(1, Read()).on_return(1, ReadOk('B'))\n"
        "assert nb.native_serialized_history(t.init_ref_obj, t.history_by_thread,\n"
        "    t.in_flight_by_thread, linearizable=True, min_ops=0) is not None\n"
        "assert nb.native_searches() == 1\n"
        "so = Path(nb._load()._name).resolve()\n"
        "assert so.parent == Path('stateright_tpu_torch/_build').resolve(), so\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert '_native/build' not in maps and str(so) in maps\n"
        "buf = io.StringIO()\n"
        "with contextlib.redirect_stdout(buf):\n"
        "    main(['2pc', 'check-cuda', '3', '--device', 'cpu'])\n"
        "assert 'unique=288' in buf.getvalue()\n"
        "m = PaxosModelCfg(client_count=1, server_count=3).into_model()\n"
        "p = m.checker().spawn_bfs().join().discovery('value chosen')\n"
        "assert m.as_svg(p).startswith('<svg')\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', 'stateright_tpu')\n"
        "       or m.startswith(('jax.', 'jaxlib.', 'stateright_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
