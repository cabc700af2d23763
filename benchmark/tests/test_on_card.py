"""On the card (marked `cuda`; skipped without one): a traced run of each
cell at the test size reads its device trace and its layers, and no share of
a roofline passes 100%."""

import pytest

from .conftest import make_tiny_root

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


@pytest.mark.parametrize("workload", ["2pc10.device", "2pc10.tiered"])
def test_traced_run_on_the_card(card, tmp_path, workload):
    import json
    import time

    from benchmark import harness, spec

    root = make_tiny_root(tmp_path)
    # 2pc-5, whose check runs some chunks; the slice starts at once.
    for name in ("2pc-10", "2pc-10-tiered"):
        path = root / "benchmark/configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg.update(rm_count=5, queue_log2=15)
        if cfg["store"] == "device":
            cfg["table_log2"] = 15
        cfg["model"]["args"]["rm_count"] = 5
        cfg["profile_slice"] = {"start_after_s": 0.0, "chunks": 2}
        path.write_text(json.dumps(cfg))
    cell = spec.load_cell(workload, root)
    # The window holds the profiler's start and stop inside the first check.
    out = harness.run_cell(cell, 5, 10.0, True, "cuda", time.monotonic())
    assert out["correct"], ([k for k, v in out["compared"].items() if v["value"] > v["limit"]],
                            out["notes"], out["checks"])
    assert out["profile"]["error"] is None, out["profile"]
    assert out["device"]["platform"] == "gpu" and out["device"]["kind"] == card
    assert out["device"]["busy_s"] > 0 and out["breakdown"]["device_ops"]
    for name, m in out["metrics"].items():
        if name.endswith("_roofline"):
            assert 0 < m["value"] <= 100, (name, m)
