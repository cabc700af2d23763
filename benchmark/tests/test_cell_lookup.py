"""Cells, configurations, traffic mixes and metrics are found by name, and a
later change adds each of them as new files and entries only."""

import json

import pytest

from benchmark import spec

from .conftest import REPO, run_tiny


def test_both_cells_resolve_to_their_files():
    dev = spec.load_cell("2pc10.device", REPO)
    tiered = spec.load_cell("2pc10.tiered", REPO)
    assert dev.config["name"] == "2pc-10" and dev.config["store"] == "device"
    assert tiered.config["table_log2"] == 25 and tiered.config["store"] == "tiered"
    assert dev.traffic["kind"] == tiered.traffic["kind"] == "closed_loop"
    assert [m.name for m in dev.end_to_end] == ["states_per_s", "peak_mem_gib", "setup_s"]
    assert [m.name for m in tiered.end_to_end] == ["tiered_states_per_s", "peak_mem_gib",
                                                   "setup_s"]
    assert "fingerprint_roofline" in [m.name for m in dev.per_layer]
    assert "fingerprint_roofline" not in [m.name for m in tiered.per_layer]
    assert "tiered.service_pct" in [m.name for m in tiered.per_layer]


def test_every_metric_has_a_reader_and_every_config_a_reference():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"], REPO)), m["name"]
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        ref = spec.reference_module(cfg, REPO)
        assert callable(ref.expected) and callable(ref.judge)


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no.such.cell", REPO)


def test_a_per_layer_metric_without_workloads_is_refused(tiny_root):
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "x.ms", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "x", "moves": "setup_s"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(ValueError, match="x.ms"):
        spec.load_cell("2pc10.device", tiny_root)


def test_a_cell_added_as_files_only_runs(tiny_root):
    """A throwaway configuration, traffic mix, metric and cell, added as new
    files and BENCHMARK.json entries: the harness runs it unedited."""
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    cfg = json.loads((tiny_root / "benchmark/configs/2pc-10.json").read_text())
    cfg.update(name="2pc-3", rm_count=3)
    cfg["model"]["args"]["rm_count"] = 3
    (tiny_root / "benchmark/configs/2pc-3.json").write_text(json.dumps(cfg))
    traffic = {"kind": "closed_loop", "clients": 1, "think_s": 0.01}
    (tiny_root / "benchmark/traffic/paced-loop.json").write_text(json.dumps(traffic))
    (tiny_root / "benchmark/metrics/checks_per_s.py").write_text(
        "def read(run):\n    return len(run.checks) / run.window_s\n")
    bench["configs"].append({"name": "2pc-3", "source": "https://example.org/2pc",
                             "file": "benchmark/configs/2pc-3.json", "reduced": [],
                             "why": "throwaway"})
    bench["workloads"].append({"name": "2pc3.paced", "config": "2pc-3",
                               "traffic": "paced-loop", "chips": 1, "why": "throwaway"})
    bench["end_to_end"].append({"name": "checks_per_s", "unit": "checks/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["2pc3.paced"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("2pc3.paced", tiny_root)
    assert cell.traffic["think_s"] == 0.01
    out = run_tiny(tiny_root, "2pc3.paced", seconds=1.0)
    assert out["correct"], out["compared"]
    assert set(out["metrics"]) == {"checks_per_s", "setup_s"}  # peak_mem_gib: card only
    assert all(c["unique"] == 288 for c in out["checks"] if c["complete"])
