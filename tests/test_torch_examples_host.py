"""The port's last package examples (stateright_tpu_torch/examples/
{increment,interaction,lww_register}.py), its example CLIs
(`python -m stateright_tpu_torch.examples`) and the actor sequence diagram
(actor/svg.py, `ActorModel.as_svg`) on the CPU, each held against the JAX
package: the increment, increment-lock, lww and interaction cases of
tests/test_examples.py with their counts and discovery paths equal to the
JAX package's; the device CLIs through `--device cpu` at their goldens; the
USAGE text against the root scripts'; and the SVG of a Paxos path, alone and
in the Explorer's state view, equal to the JAX package's string."""

import contextlib
import io
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import stateright_tpu as jsr
import stateright_tpu_torch as psr
from stateright_tpu.examples import increment as jinc
from stateright_tpu.examples import interaction as jint
from stateright_tpu.examples import lww_register as jlww
from stateright_tpu.examples import paxos as jpaxos
from stateright_tpu.explorer import server as jserver
from stateright_tpu_torch.examples import increment as pinc
from stateright_tpu_torch.examples import interaction as pint
from stateright_tpu_torch.examples import lww_register as plww
from stateright_tpu_torch.examples import paxos as ppaxos
from stateright_tpu_torch.examples.__main__ import EXAMPLES, main
from stateright_tpu_torch.explorer import server as pserver

ROOT = Path(__file__).resolve().parent.parent


def _summary(c):
    paths = {name: [repr(a) for a in p.actions()] for name, p in c.discoveries().items()}
    return c.state_count(), c.unique_state_count(), c.max_depth(), paths


def _full(inc, sr):
    class FullIncrement(inc.IncrementSys):
        def properties(self):
            return super().properties() + [
                sr.Property.sometimes("unreachable", lambda m, s: False)
            ]

    return FullIncrement


def test_increment_goldens():
    # ref: examples/increment.rs:32-105 — the full space is 13 states with 2
    # threads, 8 with symmetry reduction. The checker early-exits once "fin"'s
    # counterexample is found, so full enumeration needs an additional
    # undiscoverable property.
    got = {}
    for side, inc, sr in (("port", pinc, psr), ("jax", jinc, jsr)):
        race = inc.IncrementSys(2).checker().spawn_dfs().join()
        assert race.discovery("fin") is not None  # data race found
        full = _full(inc, sr)(2).checker().spawn_dfs().join()
        sym = _full(inc, sr)(2).checker().symmetry().spawn_dfs().join()
        assert (full.unique_state_count(), sym.unique_state_count()) == (13, 8)
        got[side] = (_summary(race), _summary(full), _summary(sym))
    assert got["port"] == got["jax"]


def test_increment_lock_fixes_race():
    got = {}
    for side, inc in (("port", pinc), ("jax", jinc)):
        checker = inc.IncrementLockSys(2).checker().spawn_dfs().join()
        checker.assert_properties()  # fin + mutex both hold
        sym = inc.IncrementLockSys(2).checker().symmetry().spawn_dfs().join()
        sym.assert_properties()
        assert sym.unique_state_count() <= checker.unique_state_count()
        bfs3 = inc.IncrementLockSys(3).checker().spawn_bfs().join()
        got[side] = (_summary(checker), _summary(sym), _summary(bfs3))
    assert got["port"] == got["jax"]


def test_lww_register_is_eventually_consistent():
    got = {}
    for side, lww in (("port", plww), ("jax", jlww)):
        checker = lww.build_model(2).checker().target_max_depth(6).spawn_dfs().join()
        checker.assert_properties()
        assert checker.unique_state_count() > 10
        bfs = lww.build_model(2).checker().target_max_depth(4).spawn_bfs().join()
        got[side] = (checker.unique_state_count(), _summary(bfs))
    assert got["port"] == got["jax"]


def test_interaction_success_reachable():
    got = {}
    for side, inter in (("port", pint), ("jax", jint)):
        checker = inter.build_model().checker().target_max_depth(12).spawn_bfs().join()
        # Within the bounded depth the client can observe success; the
        # eventually property must not produce a counterexample.
        assert checker.discovery("success") is None
        got[side] = _summary(checker)
    assert got["port"] == got["jax"]


# -- the example CLIs ---------------------------------------------------------


def _cli(*argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(list(argv)) == 0
    return buf.getvalue()


@pytest.mark.parametrize("argv, needle", [
    (("2pc", "check-cuda", "3"), "unique=288"),
    (("increment_lock", "check-cuda-sym", "3"), "unique=13"),
], ids=["2pc_check_cuda", "increment_lock_check_cuda_sym"])
def test_device_subcommands_on_the_cpu(argv, needle):
    out = _cli(*argv, "--device", "cpu")
    assert needle in out, out


def test_device_subcommands_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        _cli("2pc", "check-cuda", "3")
    with pytest.raises(ValueError, match="--device"):
        _cli("2pc", "check-cuda", "3", "--device", "tpu")


def _root_script(*argv) -> str:
    proc = subprocess.run([sys.executable, *argv], cwd=ROOT / "examples",
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


def _header(out: str) -> list:
    """The lines an example prints before the checker's progress."""
    lines = []
    for ln in out.splitlines():
        if ln.startswith(("Checking.", "Done.")):
            break
        lines.append(ln)
    return lines


def _done_line(out: str) -> str:
    """The report's last `Done.` line without its seconds."""
    line = [ln for ln in out.splitlines() if ln.startswith("Done.")][-1]
    return line.rsplit(", sec=", 1)[0]


def test_host_subcommands_report_like_the_root_scripts():
    for argv in (("2pc", "check", "3"), ("increment", "check-sym", "3"),
                 ("single_copy_register", "check", "2"), ("lww_register", "check", "2", "4")):
        script = {"2pc": "2pc.py"}.get(argv[0], argv[0] + ".py")
        ours, theirs = _cli(*argv), _root_script(script, *argv[1:])
        assert _header(ours) == _header(theirs)
        assert _done_line(ours) == _done_line(theirs)
    assert "unique=288" in _done_line(_cli("2pc", "check", "3"))


def test_usage_mirrors_the_root_scripts():
    for name in EXAMPLES:
        theirs = _root_script(f"{name}.py")
        expected = (theirs.replace(f"./{name}.py", f"python -m stateright_tpu_torch.examples {name}")
                    .replace("check-tpu", "check-cuda"))
        assert _cli(name) == expected, name
    assert "EXAMPLE: 2pc | increment" in _cli()


# -- the sequence diagram -------------------------------------------------------


def _paxos_path(paxos, name):
    model = paxos.PaxosModelCfg(client_count=1, server_count=3).into_model()
    c = model.checker().spawn_bfs().join()
    return model, c.discovery(name)


def test_as_svg_and_explorer_view_equal_the_jax_packages():
    model, path = _paxos_path(ppaxos, "value chosen")
    jmodel, jpath = _paxos_path(jpaxos, "value chosen")
    assert path.fingerprints() == jpath.fingerprints()
    svg = model.as_svg(path)
    assert svg is not None and svg.startswith("<svg") and "Deliver" not in svg
    assert svg == jmodel.as_svg(jpath)
    fps = path.fingerprints()
    ours = {v["fingerprint"]: v for v in pserver.states_view(model, fps[:-1])}
    theirs = {v["fingerprint"]: v for v in jserver.states_view(jmodel, fps[:-1])}
    assert ours[str(fps[-1])]["svg"] == theirs[str(fps[-1])]["svg"] == svg
    assert [v["svg"] for v in pserver.states_view(model, [])] == [
        v["svg"] for v in jserver.states_view(jmodel, [])]
