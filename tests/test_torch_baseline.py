"""The port's compiled CPU baseline checker (`stateright_tpu_torch/_native/
baseline_bfs.cpp`, built by `_native.build(..., exe=True)` and run by
`_native/baseline.py`) prints the JAX package's baseline line field for
field, `sec` aside; its build and its run raise on every failure."""

import os
import subprocess
import sys

import pytest

from stateright_tpu_torch import _native
from stateright_tpu_torch._native import baseline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SOURCE = os.path.join(ROOT, "stateright_tpu", "_native", "baseline_bfs.cpp")
#: The JAX package's executable flags (stateright_tpu/_native/__init__.py).
JAX_EXE_FLAGS = ["-std=c++17", "-O3", "-march=native", "-pthread"]

#: (generated, unique): the reference's and bench.py's goldens (bench.py:39-47;
#: 2pc-3 and 2pc-5 from the reference, tests/test_tensor_checker.py), and the
#: port's paxos-1 anchor (chip_smoke.py GOLDEN_PAXOS1).
GOLDEN = {
    ("paxos", 1): (482, 265),
    ("paxos", 2): (32_971, 16_668),
    ("paxos", 3): (2_420_477, 1_194_428),
    ("2pc", 3): (1_146, 288),
    ("2pc", 4): (8_258, 1_568),
    ("2pc", 5): (58_146, 8_832),
    ("increment_lock", 6): (7_825, 7_825),
}

CASES = [
    (model, n, threads)
    for model, ns in (("paxos", (1, 2)), ("2pc", (3, 4, 5)), ("increment_lock", (3, 4, 5, 6)))
    for n in ns
    for threads in (1, 4)
] + [("paxos", 3, 4)]


@pytest.fixture(scope="module")
def exes(tmp_path_factory):
    """(port executable, JAX executable): the JAX source is compiled into a
    temporary directory with the JAX flags, beside the port's build, so
    nothing is written under stateright_tpu/."""
    jax_exe = tmp_path_factory.mktemp("jax_baseline") / "baseline_bfs"
    proc = subprocess.Popen(["g++", *JAX_EXE_FLAGS, "-o", str(jax_exe), JAX_SOURCE],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port_exe = baseline.compile_baseline()
    _out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err
    return port_exe, jax_exe


def _jax_line(jax_exe, model, n, threads):
    proc = subprocess.run([str(jax_exe), model, str(n), str(threads)], capture_output=True,
                          text=True, timeout=300, check=True)
    return baseline.parse_line(proc.stdout, proc.stderr)


@pytest.mark.parametrize("model,n,threads", CASES, ids=lambda v: str(v))
def test_port_prints_the_jax_line(exes, model, n, threads):
    port_exe, jax_exe = exes
    got = baseline.run_baseline(model, n, threads, exe=port_exe)
    want = _jax_line(jax_exe, model, n, threads)
    got.pop("sec"), want.pop("sec")
    assert got == want
    assert got["model"] == model and got["threads"] == threads
    assert got["violations"] == 0
    assert ("max_pool_used" in got) == (model == "paxos")
    if (model, n) in GOLDEN:
        assert (got["states"], got["unique"]) == GOLDEN[(model, n)]


@pytest.mark.parametrize("model,n,golden", [
    ("2pc", 4, (8_258, 1_568)),
    ("increment_lock", 3, None),
])
def test_counts_equal_the_ports_tensor_search(exes, model, n, golden):
    from stateright_tpu_torch.tensor.models import TensorIncrementLock, TensorTwoPhaseSys

    tensor_model = (TensorTwoPhaseSys if model == "2pc" else TensorIncrementLock)(n)
    c = tensor_model.checker().spawn_cuda(batch_size=256, table_log2=14, device="cpu").join()
    got = baseline.run_baseline(model, n, 2, exe=exes[0])
    assert (got["states"], got["unique"], got["depth"]) == (
        c.state_count(), c.unique_state_count(), c.max_depth())
    if golden is not None:
        assert (got["states"], got["unique"]) == golden


def test_default_threads_take_the_hosts_concurrency(exes):
    got = baseline.run_baseline("2pc", 3, exe=exes[0])
    assert got["threads"] == os.cpu_count()
    assert (got["states"], got["unique"]) == GOLDEN[("2pc", 3)]


def test_executable_lives_in_the_ports_build_directory(exes):
    assert exes[0] == _native.build("baseline_bfs", exe=True)
    assert exes[0].parent == _native.BUILD_DIR
    assert exes[0].parent.parent.name == "stateright_tpu_torch"
    assert os.access(exes[0], os.X_OK)


@pytest.mark.parametrize("model,n", [("raft", 3), ("paxos", 4), ("2pc", 17),
                                     ("increment_lock", 8)])
def test_bad_arguments_raise_with_exit_2(exes, model, n):
    with pytest.raises(baseline.BaselineError, match="exited 2") as e:
        baseline.run_baseline(model, n, 1, exe=exes[0])
    assert e.value.returncode == 2


def _fake_exe(tmp_path, body):
    path = tmp_path / "fake_baseline"
    path.write_text(f"#!{sys.executable}\nimport sys, time\n{body}\n")
    path.chmod(0o755)
    return path


def test_pool_overflow_exit_3_is_surfaced(tmp_path):
    exe = _fake_exe(tmp_path, "sys.stderr.write('pool overflow\\n'); sys.exit(3)")
    with pytest.raises(baseline.BaselineError, match="exited 3: pool overflow") as e:
        baseline.run_baseline("paxos", 3, 1, exe=exe)
    assert e.value.returncode == 3


def test_unparseable_line_and_timeout_raise(tmp_path):
    exe = _fake_exe(tmp_path, "print('model=paxos states=oops')")
    with pytest.raises(ValueError, match="no report line"):
        baseline.run_baseline("paxos", 3, 1, exe=exe)
    slow = _fake_exe(tmp_path, "time.sleep(30)")
    with pytest.raises(baseline.BaselineError, match="timed out") as e:
        baseline.run_baseline("paxos", 3, 1, timeout=0.5, exe=slow)
    assert e.value.returncode is None


def test_parse_line_reads_the_pool_from_stderr():
    line = "model=paxos states=10 unique=5 depth=3 sec=0.5 threads=2 violations=1\n"
    got = baseline.parse_line(line, "max_pool_used=7\n")
    assert got == {"model": "paxos", "states": 10, "unique": 5, "depth": 3, "sec": 0.5,
                   "threads": 2, "violations": 1, "max_pool_used": 7}
    assert "max_pool_used" not in baseline.parse_line(line)


def _own_native_dir(monkeypatch, tmp_path, source):
    (tmp_path / "prog.cpp").write_text(source)
    monkeypatch.setattr(_native, "_DIR", tmp_path)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "_build")


def test_failed_exe_build_raises_with_the_compilers_output(monkeypatch, tmp_path):
    _own_native_dir(monkeypatch, tmp_path, "int main( { return 0; }\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build prog.cpp") as e:
        _native.build("prog", exe=True)
    assert "error" in str(e.value)
    assert list((tmp_path / "_build").iterdir()) == []


def test_missing_compiler_raises(monkeypatch, tmp_path):
    _own_native_dir(monkeypatch, tmp_path, "int main() { return 0; }\n")
    monkeypatch.setenv("PATH", str(tmp_path / "nowhere"))
    with pytest.raises(RuntimeError, match="g\\+\\+ could not build prog.cpp"):
        _native.build("prog", exe=True)


def test_second_build_does_not_recompile(monkeypatch, tmp_path):
    _own_native_dir(monkeypatch, tmp_path, "int main() { return 0; }\n")
    first = _native.build("prog", exe=True)
    stamp = first.stat().st_mtime_ns

    def no_compile(*a, **kw):
        raise AssertionError("recompiled")

    monkeypatch.setattr(_native.subprocess, "run", no_compile)
    assert _native.build("prog", exe=True) == first
    assert first.stat().st_mtime_ns == stamp


def test_shared_object_and_executable_of_one_name_do_not_collide(monkeypatch, tmp_path):
    _own_native_dir(monkeypatch, tmp_path,
                    'extern "C" int answer() { return 42; }\nint main() { return answer() - 42; }\n')
    exe = _native.build("prog", exe=True)
    so = _native.build("prog")
    assert exe != so and exe.exists() and so.exists()
    assert so.suffix == ".so" and exe.suffix == ""
    assert sorted(p.name for p in (tmp_path / "_build").iterdir()) == sorted([exe.name, so.name])
    assert subprocess.run([str(exe)]).returncode == 0
    import ctypes

    assert ctypes.CDLL(str(so)).answer() == 42
    # An edited source builds anew under another hash; the old artifacts stay.
    (tmp_path / "prog.cpp").write_text("int main() { return 3; }\n")
    exe2 = _native.build("prog", exe=True)
    assert exe2 != exe and subprocess.run([str(exe2)]).returncode == 3


def test_port_source_differs_from_the_jax_source_only_in_comments():
    def code_lines(path):
        out = []
        for line in open(path):
            line = line.split("//", 1)[0].rstrip()
            if line:
                out.append(line)
        return out

    port_source = os.path.join(ROOT, "stateright_tpu_torch", "_native", "baseline_bfs.cpp")
    assert code_lines(port_source) == code_lines(JAX_SOURCE)


def test_module_cli_prints_one_json_run(exes):
    import json

    proc = subprocess.run([sys.executable, "-m", "stateright_tpu_torch._native.baseline",
                           "2pc", "3", "2"], capture_output=True, text=True, timeout=300,
                          check=True, cwd=ROOT)
    got = json.loads(proc.stdout)
    assert (got["states"], got["unique"], got["threads"]) == GOLDEN[("2pc", 3)] + (2,)
    assert got["states_per_s"] == got["states"] / got["sec"]
    assert got["host_cpu"] == baseline.host_cpu() != ""
    assert got["cpu_count"] == os.cpu_count()
    bad = subprocess.run([sys.executable, "-m", "stateright_tpu_torch._native.baseline"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert bad.returncode == 2 and "usage" in bad.stderr
