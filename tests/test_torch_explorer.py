"""The port's on-demand checker, Explorer and tensor-model adapter
(checker/on_demand.py, explorer/, tensor/adapter.py) held against the JAX
package's on the CPU: the cases of tests/test_on_demand_and_explorer.py and
tests/test_tensor_adapter.py, each run by both packages, with the adapter's
expands at `device="cpu"`. Counts, the Explorer's JSON views (fingerprints
included), the adapter's rows and their host fingerprints must be equal;
all are integers or strings, so the tolerance is 0."""

import json
import time
import urllib.request

import pytest
import torch

import sharded_ranks
from stateright_tpu.core.fingerprint import fingerprint as jax_fingerprint
from stateright_tpu.core.visitor import StateRecorder as JaxRecorder
from stateright_tpu.examples.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys
from stateright_tpu.explorer import server as jax_server
from stateright_tpu.fixtures import BinaryClock as JaxClock
from stateright_tpu.fixtures import LinearEquation as JaxLinearEquation
from stateright_tpu.tensor import as_host_model as jax_as_host_model
from stateright_tpu.tensor.models import TensorTwoPhaseSys as JaxTensorTwoPhaseSys
from stateright_tpu_torch.core.fingerprint import fingerprint
from stateright_tpu_torch.core.visitor import PathRecorder, StateRecorder
from stateright_tpu_torch.examples.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.explorer import server
from stateright_tpu_torch.explorer.server import serve, states_view, status_view
from stateright_tpu_torch.fixtures import BinaryClock, LinearEquation
from stateright_tpu_torch.parallel import run_world
from stateright_tpu_torch.tensor import TensorModelAdapter, as_host_model
from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys
from stateright_tpu_torch.tensor.resident import ResidentSearch


def _wait(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=10) as r:
        return json.loads(r.read())


def _post(base, path):
    req = urllib.request.Request(base + path, method="POST", data=b"")
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def _adapters(n=3):
    return jax_as_host_model(JaxTensorTwoPhaseSys(n)), as_host_model(
        TensorTwoPhaseSys(n), device="cpu")


# -- the on-demand checker (tests/test_on_demand_and_explorer.py) ------------------


def test_on_demand_is_lazy_then_completes():
    for model, fp in ((JaxLinearEquation(2, 10, 14), jax_fingerprint),
                      (LinearEquation(2, 10, 14), fingerprint)):
        checker = model.checker().spawn_on_demand()
        assert checker.unique_state_count() == 1
        checker.check_fingerprint(fp((0, 0)))
        assert _wait(lambda: checker.unique_state_count() == 3)
        checker.check_fingerprint(123456789)  # unknown: ignored
        checker.run_to_completion()
        checker.join()
        assert checker.discovery("solvable") is not None
    assert fingerprint((0, 0)) == jax_fingerprint((0, 0))


def test_on_demand_join_runs_to_completion():
    jc = JaxTwoPhaseSys(3).checker().spawn_on_demand().join()
    pc = TwoPhaseSys(3).checker().spawn_on_demand().join()
    assert pc.unique_state_count() == jc.unique_state_count() == 288
    assert pc.state_count() == jc.state_count()
    pc.assert_properties()
    assert {n: p.encode() for n, p in pc.discoveries().items()} == {
        n: p.encode() for n, p in jc.discoveries().items()}


def test_on_demand_expand_single_step_counts():
    for model, fp in ((JaxClock(), jax_fingerprint), (BinaryClock(), fingerprint)):
        checker = model.checker().spawn_on_demand()
        assert checker.unique_state_count() == 2
        checker.check_fingerprint(fp(0))
        _wait(lambda: checker.state_count() > 2)
        assert checker.unique_state_count() == 2  # successor (1) already known
        checker.join()


# -- the Explorer's views ------------------------------------------------------------


def test_status_view_equals_jax():
    jv = jax_server.status_view(JaxTwoPhaseSys(3).checker().spawn_on_demand().join())
    pv = status_view(TwoPhaseSys(3).checker().spawn_on_demand().join())
    assert pv == jv
    assert pv["model"] == "TwoPhaseSys" and pv["unique_state_count"] == 288 and pv["done"]
    by_name = {p["name"]: p for p in pv["properties"]}
    assert by_name["commit agreement"]["classification"] == "example"
    assert by_name["consistent"]["discovery"] is None


def test_states_view_equals_jax():
    init = states_view(TwoPhaseSys(3), [])
    assert init == jax_server.states_view(JaxTwoPhaseSys(3), [])
    assert len(init) == 1 and init[0]["action"] is None
    fp = int(init[0]["fingerprint"])
    nxt = states_view(TwoPhaseSys(3), [fp])
    assert nxt == jax_server.states_view(JaxTwoPhaseSys(3), [fp])
    assert any("abort" in v["action"].lower() for v in nxt)
    assert {p["name"] for p in nxt[0]["properties"]} == {
        "abort agreement", "commit agreement", "consistent"}
    deeper = [fp, int(nxt[0]["fingerprint"])]
    assert states_view(TwoPhaseSys(3), deeper) == jax_server.states_view(
        JaxTwoPhaseSys(3), deeper)


def test_states_view_404_on_bogus_path():
    with pytest.raises(KeyError):
        states_view(TwoPhaseSys(3), [42])


def test_explorer_http_roundtrip():
    jsrv = JaxTwoPhaseSys(3).checker().serve("localhost:0")
    psrv = TwoPhaseSys(3).checker().serve("localhost:0")
    try:
        jb, pb = f"http://{jsrv.address}", f"http://{psrv.address}"
        assert _get(pb, "/.status") == _get(jb, "/.status")
        init = _get(pb, "/.states")
        assert init == _get(jb, "/.states")
        fp = init[0]["fingerprint"]
        assert _get(pb, f"/.states/{fp}") == _get(jb, f"/.states/{fp}")
        for asset in ("/", "/app.js", "/app.css"):
            with urllib.request.urlopen(pb + asset, timeout=5) as r:
                body = r.read()
            assert body == (server._UI_DIR / server._ASSETS[asset][0]).read_bytes()
        assert _post(pb, "/.runtocompletion")["ok"]
        assert _wait(lambda: _get(pb, "/.status")["done"], timeout=10)
        assert _get(pb, "/.status")["unique_state_count"] == 288
        assert "checker_unique_state_count 288" in urllib.request.urlopen(
            pb + "/metrics", timeout=5).read().decode()
    finally:
        jsrv.shutdown()
        psrv.shutdown()


def test_the_ui_is_the_ports_own_copy():
    import stateright_tpu_torch

    pkg = type(server._UI_DIR)(stateright_tpu_torch.__file__).parent
    assert server._UI_DIR == pkg / "explorer" / "ui"
    for name in ("index.htm", "app.js", "app.css"):
        assert (server._UI_DIR / name).read_bytes() == (jax_server._UI_DIR / name).read_bytes()


def test_status_recent_path_snapshot():
    srv = serve(LinearEquation(2, 10, 14).checker(), "localhost:0")
    try:
        base = f"http://localhost:{srv.httpd.server_address[1]}"
        assert _get(base, "/.status")["recent_path"] is None  # lazy: nothing evaluated
        _post(base, "/.runtocompletion")
        assert _wait(lambda: _get(base, "/.status")["done"], timeout=60)
        rp = _get(base, "/.status")["recent_path"]
        assert rp and all(int(p) != 0 for p in rp.split("/"))
    finally:
        srv.shutdown()


# -- the tensor-model adapter (tests/test_tensor_adapter.py) ------------------------


@pytest.fixture(scope="module")
def jax_adapter_bfs():
    """The JAX adapter's host BFS of 2pc-3 with a StateRecorder, run once:
    its eager one-row JAX expands are the slow part of this file."""
    rec = JaxRecorder()
    c = jax_as_host_model(JaxTensorTwoPhaseSys(3)).checker().visitor(rec).spawn_bfs().join()
    return c, rec.states


@pytest.mark.parametrize("threads", [1, 4])
def test_adapter_host_bfs_matches_device_counts(threads, jax_adapter_bfs):
    jh, _ = jax_adapter_bfs
    _, pm = _adapters()
    ph = pm.checker().threads(threads).spawn_bfs().join()
    dev = TensorTwoPhaseSys(3).checker().spawn_cuda(table_log2=12, device="cpu").join()
    assert ph.unique_state_count() == jh.unique_state_count() == dev.unique_state_count() == 288
    assert ph.state_count() == jh.state_count() == dev.state_count() == 1_146
    assert set(ph.discoveries()) == set(jh.discoveries()) == set(dev.discoveries())
    if threads == 1:
        assert {n: p.encode() for n, p in ph.discoveries().items()} == {
            n: p.encode() for n, p in jh.discoveries().items()}


def test_adapter_rows_and_fingerprints_equal_jax(jax_adapter_bfs):
    _, jstates = jax_adapter_bfs
    jm, pm = _adapters()
    prec = StateRecorder()
    pm.checker().visitor(prec).spawn_bfs().join()
    assert [tuple(s) for s in prec.states] == [tuple(s) for s in jstates]
    assert [fingerprint(s) for s in prec.states] == [jax_fingerprint(s) for s in jstates]
    assert [repr(s) for s in prec.states] == [repr(s) for s in jstates]
    assert all(type(x) is int for s in prec.states for x in s)
    s = prec.states[5]
    assert pm.next_steps(s) == [(a, tuple(n)) for a, n in jm.next_steps(jstates[5])]


def test_explorer_views_over_tensor_model():
    jm, pm = _adapters()
    init = states_view(pm, [])
    assert init == jax_server.states_view(jm, [])
    assert len(init) == 1 and not init[0]["ignored"] and "working" in init[0]["state"]
    fp = int(init[0]["fingerprint"])
    nxt = states_view(pm, [fp])
    assert nxt == jax_server.states_view(jm, [fp])
    assert all(v["fingerprint"] is not None for v in nxt if not v["ignored"])


@pytest.mark.parametrize("threads", [1, 4])
def test_host_checkers_over_tensor_model(threads):
    _, pm = _adapters()
    counts = []
    for spawn in ("spawn_dfs", "spawn_on_demand"):
        c = getattr(pm.checker().threads(threads), spawn)()
        c.join()
        counts.append((c.state_count(), c.unique_state_count()))
    assert counts == [(1_146, 288)] * 2


def test_threads_share_the_adapter_under_a_short_switch_interval():
    # Eight workers (more threads than cores on a small host) share one adapter's
    # expansion memo and the checker's visited map; a lost update would
    # lose or double a state.
    import sys
    import threading

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        c = as_host_model(TensorTwoPhaseSys(3), device="cpu").checker().threads(8).spawn_bfs()
        done = threading.Thread(target=c.join)
        done.start()
        done.join(timeout=120)
        assert not done.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert (c.state_count(), c.unique_state_count()) == (1_146, 288)


def test_explorer_http_roundtrip_over_tensor_model():
    jm, pm = _adapters()
    psrv, jsrv = serve(pm.checker(), "localhost:0"), jax_server.serve(jm.checker(), "localhost:0")
    try:
        pb, jb = f"http://{psrv.address}", f"http://{jsrv.address}"
        assert _get(pb, "/.status") == _get(jb, "/.status")  # before any expansion
        views = _get(pb, "/.states/")
        assert views == _get(jb, "/.states/")
        assert len(views) == 1 and "working" in views[0]["state"]
        fp = views[0]["fingerprint"]
        assert _get(pb, f"/.states/{fp}") == _get(jb, f"/.states/{fp}")
        # The visit queued the init state's expansion in both checkers.
        for base in (pb, jb):
            assert _wait(lambda: _get(base, "/.status")["unique_state_count"] == 8)
    finally:
        jsrv.shutdown()
        psrv.shutdown()


def test_resident_dump_states_is_exact_state_set():
    rs = ResidentSearch(TensorTwoPhaseSys(3), 256, 14, device="cpu")
    assert rs.run(budget=4).complete
    dump = rs.dump_states(decode=False)
    assert len(dump) == len(set(dump)) == 288
    rec = StateRecorder()
    as_host_model(TensorTwoPhaseSys(3), device="cpu").checker().visitor(rec).spawn_bfs().join()
    assert set(dump) == {tuple(s) for s in rec.states}


def test_sharded_dump_states_union_over_shards():
    dumps = run_world(sharded_ranks.dump_2pc3, 4, device="cpu", timeout=120)
    rec = StateRecorder()
    as_host_model(TensorTwoPhaseSys(3), device="cpu").checker().visitor(rec).spawn_bfs().join()
    for dump in dumps:  # a collective: every rank holds the union
        assert len(dump) == len(set(dump)) == 288
        assert set(dump) == {tuple(s) for s in rec.states}


def test_spawn_cuda_accepts_state_and_path_recorders():
    rec, paths = StateRecorder(), PathRecorder()
    c = TensorTwoPhaseSys(3).checker().visitor(rec).spawn_cuda(
        batch_size=256, table_log2=14, device="cpu").join()
    assert c.unique_state_count() == len(rec.states) == 288
    assert any("working" in repr(s) for s in rec.states)
    c = TensorTwoPhaseSys(3).checker().visitor(paths).spawn_cuda(
        batch_size=64, table_log2=12, device="cpu").join()
    assert len(paths.paths) == 288
    assert max(len(list(p)) for p in paths.paths) == 11  # max_depth golden of 2pc-3


def test_adapter_defaults_to_the_card():
    assert isinstance(as_host_model(TensorTwoPhaseSys(3), device="cpu"), TensorModelAdapter)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        as_host_model(TensorTwoPhaseSys(3))
