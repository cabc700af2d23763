"""A copy of the benchmark at a size a CPU test can hold: every cell's
configuration cut to 2pc-4 with a small table, everything else as it is."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

#: sizes that run an exhaustive check in well under a second on the CPU.
TINY = {
    "2pc-10": dict(rm_count=4, batch_size=64, table_log2=12, queue_log2=12),
    "2pc-10-tiered": dict(rm_count=4, batch_size=32, table_log2=11, queue_log2=12,
                          high_water=0.6, low_water=0.35, summary_log2=14),
}


def make_tiny_root(dest: Path) -> Path:
    """A checkout-shaped folder at `dest`: BENCHMARK.json and benchmark/,
    with the configurations cut to TINY's sizes."""
    shutil.copytree(REPO / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    for entry in bench["configs"]:
        path = dest / entry["file"]
        cfg = json.loads(path.read_text())
        over = TINY[entry["name"]]
        cfg.update(over)
        cfg["model"]["args"]["rm_count"] = over["rm_count"]
        path.write_text(json.dumps(cfg))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)


def run_tiny(root: Path, workload: str, seconds: float = 3.0, trace: bool = False,
             seed: int = 4_000_000_007) -> dict:
    import time

    from benchmark import harness, spec

    cell = spec.load_cell(workload, root)
    return harness.run_cell(cell, seed, seconds, trace, "cpu", time.monotonic())
