"""The control (the reference with a narrow hashed visited-set key, in the
system's place) comes out as not correct; the exact reference does not."""

import json

from benchmark import control, spec

from .conftest import REPO


def test_control_fails_the_comparison_on_three_seeds(tiny_root):
    cfg = tiny_root / "benchmark/configs/2pc-10.json"
    d = json.loads(cfg.read_text())
    d["rm_count"] = 5
    cfg.write_text(json.dumps(d))
    cell = spec.load_cell("2pc10.device", tiny_root)
    ref = spec.reference_module(cell.config, tiny_root)
    for seed in (11, 12, 2**31 + 5):
        # 8,832 states into 4,096 keys
        r = control.readings(cell, seed, "cpu", key=ref.hashed_key(12, seed))
        assert r["correct"] is False, r
        assert r["compared"]["unique_gap"]["value"] > 0


def test_the_exact_reference_in_the_control_place_is_correct(tiny_root):
    """The control's path through the harness's judge passes the exact
    search: only its key makes the control fail."""
    cell = spec.load_cell("2pc10.tiered", tiny_root)
    r = control.readings(cell, 7, "cpu", key=lambda codes: codes)
    assert r["correct"] is True, r


def test_cell_control_key_is_32_bits():
    cell = spec.load_cell("2pc10.device", REPO)
    ref = spec.reference_module(cell.config, REPO)
    import torch

    keys = ref.control_key(cell.config, 3)(torch.arange(1, 1 << 16, dtype=torch.int64))
    assert int(keys.min()) >= 0 and int(keys.max()) < 1 << 32
    assert int(keys.max()) >= 1 << 31  # the whole 32 bits are used
