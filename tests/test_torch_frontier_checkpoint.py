"""Checkpoint and resume of the port's host-driven engine
(stateright_tpu_torch/tensor/frontier.py::FrontierSearch) on the CPU: the
JAX package's frontier checkpoint tests (tests/test_checkpoint.py:12, :41,
:70, :79, :85, :102) through the port, files crossing the two packages both
ways (the JAX engine with insert_variant="pallas" in interpret mode, and
with its default "sort", which the port resumes on its own "sort" design,
slot for slot), and the tiered store through a 2^11 hot tier. Every
comparison is exact."""

import numpy as np
import pytest

from stateright_tpu.tensor import models as jm
from stateright_tpu.tensor.frontier import FrontierSearch as JaxFrontier
from stateright_tpu_torch import HasDiscoveries
from stateright_tpu_torch.tensor import models as pm
from stateright_tpu_torch.tensor.frontier import FrontierSearch
from stateright_tpu_torch.tensor.pallas_hashtable import to_jax_table

GOLD_2PC4 = (8_258, 1_568)


def port(model, K, T, **kw):
    return FrontierSearch(model, K, T, device="cpu", **kw)


def load(model, path, K=256):
    return FrontierSearch.load_checkpoint(model, path, batch_size=K, device="cpu")


@pytest.fixture(scope="module")
def full():
    r = port(pm.TensorTwoPhaseSys(4), 256, 14).run()
    assert r.complete and (r.state_count, r.unique_state_count) == GOLD_2PC4
    return r


def assert_full(r, full):
    assert r.complete
    assert (r.state_count, r.unique_state_count, r.max_depth, r.steps) == (
        full.state_count, full.unique_state_count, full.max_depth, full.steps)
    assert r.discoveries == full.discoveries


def test_kill_and_resume_reproduces_exact_counts(tmp_path, full):
    fs = port(pm.TensorTwoPhaseSys(4), 256, 14)
    partial = fs.run(max_steps=2)
    assert not partial.complete and partial.state_count < full.state_count
    ckpt = str(tmp_path / "search.npz")
    fs.checkpoint(ckpt)
    del fs
    resumed = load(pm.TensorTwoPhaseSys(4), ckpt)
    r = resumed.run()
    assert_full(r, full)
    path = resumed.reconstruct_path(r.discoveries["commit agreement"])
    assert path.last_state() is not None
    t = r.detail["telemetry"]
    assert t["steps"] == r.steps and t["dropped_steps"] == partial.steps


def test_multiple_suspensions(tmp_path):
    golden = port(pm.TensorLinearEquation(2, 4, 7), 256, 18).run()
    fs = port(pm.TensorLinearEquation(2, 4, 7), 256, 18)
    ckpt = str(tmp_path / "s.npz")
    for _ in range(6):
        r = fs.run(max_steps=3)
        fs.checkpoint(ckpt)
        fs = load(pm.TensorLinearEquation(2, 4, 7), ckpt)
        if r.complete:
            break
    else:
        r = fs.run()
    assert (r.state_count, r.unique_state_count) == (golden.state_count,
                                                     golden.unique_state_count)


def test_layout_mismatch_rejected(tmp_path):
    fs = port(pm.TensorTwoPhaseSys(4), 64, 12)
    fs.run(max_steps=1)
    ckpt = str(tmp_path / "s.npz")
    fs.checkpoint(ckpt)
    with pytest.raises(ValueError):
        load(pm.TensorTwoPhaseSys(5), ckpt)


def test_checkpoint_before_run_rejected(tmp_path):
    with pytest.raises(RuntimeError):
        port(pm.TensorTwoPhaseSys(3), 64, 12).checkpoint(str(tmp_path / "s.npz"))


def test_early_exit_stays_incomplete_across_runs(tmp_path):
    fs = port(pm.TensorTwoPhaseSys(3), 64, 12)
    r1 = fs.run(finish_when=HasDiscoveries.ANY)
    assert not r1.complete and r1.unique_state_count < 288
    r2 = fs.run()
    assert not r2.complete
    fs.checkpoint(str(tmp_path / "s.npz"))
    assert not load(pm.TensorTwoPhaseSys(3), str(tmp_path / "s.npz"), K=64).run().complete


def test_suspended_result_discoveries_are_snapshots():
    fs = port(pm.TensorTwoPhaseSys(3), 64, 12)
    r1 = fs.run(max_steps=1)
    snapshot = dict(r1.discoveries)
    fs.run()
    assert r1.discoveries == snapshot


# -- files across the two packages ------------------------------------------------


def test_port_checkpoint_resumes_in_the_jax_engine(tmp_path, full):
    fs = port(pm.TensorTwoPhaseSys(4), 256, 14)
    fs.run(max_steps=4)
    ckpt = str(tmp_path / "port.npz")
    fs.checkpoint(ckpt)
    jfs = JaxFrontier.load_checkpoint(jm.TensorTwoPhaseSys(4), ckpt, batch_size=256)
    assert jfs.insert_variant == "pallas"
    assert_full(jfs.run(), full)


@pytest.mark.parametrize("variant", ["pallas", "sort"])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, full, variant):
    jfs = JaxFrontier(jm.TensorTwoPhaseSys(4), 256, 14, insert_variant=variant)
    jfs.run(max_steps=3)
    ckpt = str(tmp_path / f"jax-{variant}.npz")
    jfs.checkpoint(ckpt)
    fs = load(pm.TensorTwoPhaseSys(4), ckpt)
    data = np.load(ckpt)
    # Both resume on the file's variant, the table taken slot for slot.
    assert fs.insert_variant == variant
    for ours, theirs in zip(to_jax_table(fs.table.t_key, fs.table.t_parent),
                            (data["t_lo"], data["t_hi"], data["p_lo"], data["p_hi"])):
        np.testing.assert_array_equal(ours, theirs)
    r = fs.run()
    assert_full(r, full)
    # The witnesses walk the loaded parent pointers, to the uninterrupted
    # run's.
    device = port(pm.TensorTwoPhaseSys(4), 256, 14)
    device.run()
    for fp in r.discoveries.values():
        assert fs.reconstruct_path(fp).actions() == device.reconstruct_path(fp).actions()


# -- the tiered store ------------------------------------------------------------


def test_tiered_through_a_small_hot_tier(tmp_path, full):
    kw = dict(store="tiered", high_water=0.6, summary_log2=14)
    fs = port(pm.TensorTwoPhaseSys(4), 32, 11, **kw)
    r = fs.run()
    assert (r.state_count, r.unique_state_count, r.discoveries) == (
        full.state_count, full.unique_state_count, full.discoveries)
    stats = fs.store_stats()
    assert stats["spill_events"] >= 1 and stats["suspects_checked"] >= 1
    assert r.detail["telemetry"]["suspects_max"] >= 1
    # Spilled parents win over re-claims: the witnesses are the device
    # store's shortest ones.
    device = port(pm.TensorTwoPhaseSys(4), 256, 14)
    device.run()
    for fp in r.discoveries.values():
        assert fs.reconstruct_path(fp).actions() == device.reconstruct_path(fp).actions()

    # Suspended after a spill, checkpointed, resumed in a fresh engine.
    fs = port(pm.TensorTwoPhaseSys(4), 32, 11, **kw)
    fs.run(max_steps=150)
    assert fs.store_stats()["spill_events"] >= 1
    ckpt = str(tmp_path / "tiered.npz")
    fs.checkpoint(ckpt)
    r2 = load(pm.TensorTwoPhaseSys(4), ckpt, K=32).run()
    assert (r2.state_count, r2.unique_state_count, r2.discoveries) == (
        full.state_count, full.unique_state_count, full.discoveries)
