"""A run driven whole on the CPU (the harness's look for a card skipped)
with the timed path broken underneath: `correct` comes out false for each
fault a one-card exhaustive check can have. (There is no exchange between
cards in a one-card cell.)"""

import json

import pytest

from .conftest import run_tiny


def _patch_step_unchanged(monkeypatch):
    """A step that returns the search's state unchanged."""
    from stateright_tpu_torch.tensor import resident

    monkeypatch.setattr(resident.ResidentSearch, "_step", lambda self, c, go, tmd: None)


def _patch_half_batch(monkeypatch):
    """Half of each popped batch left out: popped, but never expanded."""
    from stateright_tpu_torch.tensor import resident

    pop = resident.pop_batch

    def half(queue, head, tail, take_ok, arange_k):
        states, keys, ebits, depth, active, new_head = pop(queue, head, tail, take_ok, arange_k)
        keep = arange_k < arange_k.shape[0] // 2
        return states, keys, ebits, depth, active & keep, new_head

    monkeypatch.setattr(resident, "pop_batch", half)


def _patch_count_altered(monkeypatch):
    """One generated state too many counted in each step that expands."""
    from stateright_tpu_torch.tensor import resident

    expand_insert = resident.expand_insert

    def counted(*a, **kw):
        flat, keys, is_new, suspect, gen_rows, has_succ, ovf = expand_insert(*a, **kw)
        return flat, keys, is_new, suspect, gen_rows + (gen_rows[:1] > 0), has_succ, ovf

    monkeypatch.setattr(resident, "expand_insert", counted)


def _patch_parents_altered(monkeypatch):
    """Each successor's parent written as its neighbour's: the counts stay
    right; the path rebuilt from those parents cannot be replayed, and the
    check raises."""
    from stateright_tpu_torch.tensor import resident

    expand_insert = resident.expand_insert

    def shifted(model, insert, t_key, t_parent, states, keys, active, **kw):
        return expand_insert(model, insert, t_key, t_parent, states, keys.roll(1), active, **kw)

    monkeypatch.setattr(resident, "expand_insert", shifted)


def _patch_path_altered(monkeypatch):
    """Each discovery's path handed back with its second state left out."""
    from stateright_tpu_torch.core.path import Path
    from stateright_tpu_torch.tensor import resident

    reconstruct = resident.reconstruct_path

    def shortcut(*a, **kw):
        pairs = reconstruct(*a, **kw).into_pairs()
        return Path(pairs[:1] + pairs[2:]) if len(pairs) > 2 else Path(pairs)

    monkeypatch.setattr(resident, "reconstruct_path", shortcut)


def _patch_suspects_dropped(monkeypatch):
    """The tiered store answers every suspect as already visited."""
    import numpy as np
    from stateright_tpu_torch.store import tiered

    monkeypatch.setattr(tiered.TieredStore, "resolve_suspects",
                        lambda self, keys: np.ones(keys.shape[0], dtype=bool))


FAULTS = {
    "step_unchanged": (_patch_step_unchanged, "no_whole_check"),
    "half_batch": (_patch_half_batch, "unique_gap"),
    "count_altered": (_patch_count_altered, "generated_gap"),
    "parents_altered": (_patch_parents_altered, "check_errors"),
    "path_altered": (_patch_path_altered, "discovery_faults"),
}


@pytest.mark.parametrize("workload", ["2pc10.device", "2pc10.tiered"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(tiny_root, monkeypatch, workload, fault):
    patch, number = FAULTS[fault]
    patch(monkeypatch)
    out = run_tiny(tiny_root, workload)
    assert out["correct"] is False
    v = out["compared"][number]
    assert v["value"] > v["limit"], out["compared"]


def test_dropped_suspects_are_not_correct(tiny_root, monkeypatch):
    # A small summary, so that new states hit it and are suspects.
    cfg = tiny_root / "benchmark/configs/2pc-10-tiered.json"
    d = json.loads(cfg.read_text())
    d["summary_log2"] = 9
    cfg.write_text(json.dumps(d))
    _patch_suspects_dropped(monkeypatch)
    out = run_tiny(tiny_root, "2pc10.tiered")
    assert out["correct"] is False
    assert out["compared"]["unique_gap"]["value"] > 0
