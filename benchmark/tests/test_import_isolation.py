"""Nothing the benchmark runs loads JAX or the JAX package (top-level module
names compared whole), and the plain reference loads nothing of the system
under test either."""

import ast
import subprocess
import sys

from benchmark import harness

from .conftest import REPO

BENCH = REPO / "benchmark"


def _imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not _imported_tops(path) & set(harness.FORBIDDEN), path


def test_reference_files_import_nothing_of_the_system():
    for path in (BENCH / "reference").rglob("*.py"):
        assert not {t for t in _imported_tops(path) if t.startswith("stateright")}, path


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "stateright_tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxfake.sub", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "stateright_tpu.fake", sys)
    assert harness.forbidden_modules() == ["stateright_tpu.fake"]


DRY_RUN = """
import json, sys, time
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
from conftest import make_tiny_root, run_tiny
from pathlib import Path
root = make_tiny_root(Path({tmp!r}))
out = run_tiny(root, "2pc10.tiered")
from benchmark import harness
print(json.dumps([out["correct"], harness.forbidden_modules(),
                  sorted(m for m in sys.modules if m.startswith("stateright"))[:3]]))
"""


def test_a_cpu_dry_run_loads_no_jax(tmp_path):
    code = DRY_RUN.format(repo=str(REPO), tests=str(BENCH / "tests"), tmp=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    correct, bad, loaded = __import__("json").loads(proc.stdout.strip().splitlines()[-1])
    assert correct and bad == []
    assert loaded and all(m.split(".")[0] == "stateright_tpu_torch" for m in loaded)


def test_the_reference_alone_loads_nothing_of_the_system():
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r}); "
            "from benchmark.reference import twophase as tp; tp.search(3); "
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('stateright')"
            " or m.split('.')[0] in ('jax', 'jaxlib', 'flax')))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]"
