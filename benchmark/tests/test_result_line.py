"""The result line of a run, driven whole on the CPU at a tiny size."""

import json
import subprocess
import sys

import pytest

from .conftest import REPO, run_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", ["2pc10.device", "2pc10.tiered"])
def test_line_has_the_contract_keys_and_compared_last(tiny_root, workload):
    out = run_tiny(tiny_root, workload)
    assert all(k in out for k in KEYS)
    assert list(out)[-1] == "compared"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 2
    for name, v in out["compared"].items():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"], name
    assert out["device"]["platform"] == "cpu"  # never a device metric off the card
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    json.dumps(out)  # one JSON object


def test_tiered_line_compares_the_spill_path(tiny_root):
    out = run_tiny(tiny_root, "2pc10.tiered")
    assert out["compared"]["unspilled_checks"] == {"value": 0, "limit": 0}


def test_traced_line_reads_host_layers_off_the_card(tiny_root):
    out = run_tiny(tiny_root, "2pc10.tiered", trace=True)
    assert out["correct"]
    assert set(out["metrics"]) == {"tiered.service_pct", "tiered.evict_pct"}
    assert "breakdown" not in out  # no device trace off the card


def test_without_a_card_the_command_prints_no_result():
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "2pc10.device",
                           "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run the cell")
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_a_window_with_no_whole_check_is_not_correct(tiny_root):
    """A window too short for one check: the cut check is not finished
    after the window, and the run is not correct."""
    import json

    path = tiny_root / "benchmark/configs/2pc-10.json"
    cfg = json.loads(path.read_text())
    cfg.update(rm_count=6, batch_size=32, table_log2=17, queue_log2=17)
    cfg["model"]["args"]["rm_count"] = 6
    path.write_text(json.dumps(cfg))
    out = run_tiny(tiny_root, "2pc10.device", seconds=0.05)
    assert out["correct"] is False
    assert out["compared"]["no_whole_check"] == {"value": 1, "limit": 0}
    assert out["compared"]["cut_check_over"]["value"] == 0
    assert not out["checks"][-1]["complete"] and out["checks"][-1]["unique"] < 50_816
