"""Finding a cell and what it is made of, by name.

`BENCHMARK.json` at the root of the checkout lists the cells (`workloads`),
the configurations and the metrics. Everything that belongs to one of them
lives in a file of its own, found by its name:

    benchmark/configs/<config>.json       a configuration (sizes, model, reference)
    benchmark/reference/<module>.py       the plain reference a configuration names
    benchmark/traffic/<traffic>.json      a traffic mix (parameters of the loop)
    benchmark/metrics/<metric>.py         the reader of one metric: read(run)

so a later change adds a cell, a configuration, a mix or a metric by adding
files and entries, and edits none of these modules.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Metric:
    name: str
    unit: str
    workloads: Optional[list]  # the cells it is read in; None: every cell


@dataclass
class Cell:
    """One workload of BENCHMARK.json with its configuration and traffic
    read from their files."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    run_seconds: int
    root: Path

    def metrics(self, trace: bool) -> list:
        return self.per_layer if trace else self.end_to_end


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _metrics(entries: list) -> list:
    return [Metric(name=e["name"], unit=e["unit"], workloads=e.get("workloads"))
            for e in entries]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json. An end-to-end metric
    applies to a cell when its `workloads` list names the cell, or when it
    has no such list; a per-layer metric has to list the cells it reads
    in."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = dict(load_json(root / configs[w["config"]]["file"]))
    config.setdefault("name", w["config"])
    traffic = load_json(root / "benchmark" / "traffic" / f"{w['traffic']}.json")
    traffic.setdefault("name", w["traffic"])
    e2e = [m for m in _metrics(bench["end_to_end"])
           if m.workloads is None or name in m.workloads]
    unlisted = [e["name"] for e in bench["per_layer"] if "workloads" not in e]
    if unlisted:
        raise ValueError(f"per-layer metrics without `workloads`: {unlisted}")
    layer = [m for m in _metrics(bench["per_layer"]) if name in m.workloads]
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=e2e, per_layer=layer, run_seconds=int(bench["run_seconds"]),
                root=root)


def load_module(path: Path, name: str) -> ModuleType:
    """Import the file `path` as a fresh module called `name` (metric files
    are named after their metric, dots and all, so they are loaded by path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_reader(metric: str, root: Path = ROOT):
    """The `read(run)` function of benchmark/metrics/<metric>.py."""
    return load_module(root / "benchmark" / "metrics" / f"{metric}.py",
                       f"_metric_{metric.replace('.', '_')}").read


def reference_module(config: dict, root: Path = ROOT) -> ModuleType:
    """The plain reference a configuration names (`reference.module`)."""
    mod = config["reference"]["module"]
    return load_module(root / "benchmark" / "reference" / f"{mod}.py", f"_reference_{mod}")
