"""The port stands alone: it imports torch and never jax or the JAX package,
and its entry point runs on the CUDA card unless the caller asks for the
CPU."""

import ast
import subprocess
import sys
from pathlib import Path

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
    from stateright_tpu_torch.faults.blobstore import blob_backend
    from stateright_tpu_torch.faults.ckptio import atomic_savez, write_record
    from stateright_tpu_torch.service import ServiceFleet

    with pytest.raises(NotImplementedError, match="item 3"):
        ServiceFleet(remote=True)
    # The warm-start corpus is ported: a fleet over one corpus directory
    # builds, each replica on a tiered store with the corpus attached and
    # fenced by its lease; a wire-store corpus root names item 3.
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
    with pytest.raises(NotImplementedError, match="item 3"):
        ServiceFleet(corpus_dir="blob://localhost:9/corpus")
    with pytest.raises(NotImplementedError, match="item 3"):
        ServiceFleet(lease_dir="blob://localhost:9/leases")
    for uri in ("blob://localhost:9/r", "s3://bucket/r", "gs://bucket/r"):
        with pytest.raises(NotImplementedError, match="item 3"):
            blob_backend(uri)
        with pytest.raises(NotImplementedError, match="item 3"):
            atomic_savez(uri + "/x.npz", {})
        with pytest.raises(NotImplementedError, match="item 3"):
            write_record(uri + "/lease", b"{}", b"SRTPLSE1")
    fleet = ServiceFleet(n_replicas=1, background=False,
                         service_kwargs=dict(batch_size=64, table_log2=12, device="cpu"))
    try:
        with pytest.raises(NotImplementedError, match="item 3"):
            fleet.scale_out()
        with pytest.raises(NotImplementedError, match="item 3"):
            fleet.scale_in()
    finally:
        fleet.close()
