"""`donate_chunks` on the resident engine, on the cases of the JAX package's
tests/test_donate_chunks.py (the donated chunked golden, a resume across
run() calls, the overflow that leaves no recovery carry), and tiered
checkpoints of the XLA designs crossing both ways between the two
packages: each file loads slot for slot on its own variant, the two files
of one run hold the same table, spill tier and counters, and each resumed
run reaches the JAX engine's uninterrupted run counter for counter. The
sharded engine's donated cases are in tests/test_torch_variants_engines.py.
Every comparison is exact."""

import numpy as np
import pytest

from stateright_tpu.tensor import models as jm
from stateright_tpu.tensor.frontier import FrontierSearch as JaxFrontier
from stateright_tpu.tensor.resident import ResidentSearch as JaxResident
from stateright_tpu_torch.tensor import models as pm
from stateright_tpu_torch.tensor.frontier import FrontierSearch
from stateright_tpu_torch.tensor.resident import ResidentSearch
from tests.test_torch_variants_tiered import (
    FRONTIER_TIERED,
    GOLD_2PC3,
    GOLD_2PC4,
    RESIDENT_TIERED,
    _assert_result,
    _assert_same_store,
    _assert_table,
)


@pytest.fixture(scope="module")
def jax_donated():
    """The JAX engine's donated chunked 2pc-4 run on "sort": the oracle."""
    seen = []
    rs = JaxResident(jm.TensorTwoPhaseSys(4), 256, 13, donate_chunks=True)
    r = rs.run(budget=4, progress=lambda sc, uc, md: seen.append(sc))
    return r, seen


@pytest.mark.parametrize("variant", ["pallas", "sort"])
def test_donated_chunked_run_matches_goldens(jax_donated, variant):
    jr, jseen = jax_donated
    seen = []
    rs = ResidentSearch(pm.TensorTwoPhaseSys(4), 256, 13, donate_chunks=True,
                        insert_variant=variant, device="cpu")
    r = rs.run(budget=4, progress=lambda sc, uc, md: seen.append(sc))
    _assert_result(r, jr, GOLD_2PC4)
    assert set(r.discoveries) == {"abort agreement", "commit agreement"}
    assert len(seen) > 1 and rs._snap is None  # chunked, with no undo point
    if variant == "sort":
        assert seen == jseen


@pytest.mark.parametrize("variant", ["pallas", "sort"])
def test_donated_run_resumes_across_run_calls(variant):
    jrs = JaxResident(jm.TensorTwoPhaseSys(4), 256, 13, donate_chunks=True)
    rs = ResidentSearch(pm.TensorTwoPhaseSys(4), 256, 13, donate_chunks=True,
                        insert_variant=variant, device="cpu")
    r1, jr1 = rs.run(budget=3, max_steps=3), jrs.run(budget=3, max_steps=3)
    assert not r1.complete and not jr1.complete
    assert (r1.state_count, r1.unique_state_count) == (jr1.state_count, jr1.unique_state_count)
    # The JAX engine's one long chunk; the port enqueues its steps one by
    # one, so it resumes in its default chunks.
    r2, jr2 = rs.run(), jrs.run(budget=1 << 20)
    _assert_result(r2, jr2, GOLD_2PC4)


def test_donated_overflow_has_no_recovery_carry(tmp_path):
    jrs = JaxResident(jm.TensorTwoPhaseSys(5), 256, 7, donate_chunks=True)
    with pytest.raises(RuntimeError, match="donate_chunks=True"):
        jrs.run(budget=8)
    rs = ResidentSearch(pm.TensorTwoPhaseSys(5), 256, 7, donate_chunks=True,
                        insert_variant="sort", device="cpu")
    with pytest.raises(RuntimeError, match="donate_chunks=True sacrificed the recovery carry"):
        rs.run(budget=8)
    assert rs._c is None and jrs._carry is None
    with pytest.raises(RuntimeError, match="no table snapshot"):
        rs.reconstruct_path(1)
    with pytest.raises(RuntimeError, match="nothing to checkpoint"):
        rs.checkpoint(str(tmp_path / "x.npz"))
    # Without donation the same overflow keeps the chunk boundary's carry.
    kept = ResidentSearch(pm.TensorTwoPhaseSys(5), 256, 7, insert_variant="sort", device="cpu")
    with pytest.raises(RuntimeError, match="checkpoint"):
        kept.run(budget=8)
    assert kept._c is not None


def test_donated_load_checkpoint_takes_the_flag(tmp_path):
    rs = ResidentSearch(pm.TensorTwoPhaseSys(4), 256, 13, insert_variant="sort", device="cpu")
    rs.run(max_steps=3)
    path = str(tmp_path / "c.npz")
    rs.checkpoint(path)
    back = ResidentSearch.load_checkpoint(pm.TensorTwoPhaseSys(4), path, device="cpu",
                                          donate_chunks=True)
    assert back.donate_chunks and back.insert_variant == "sort"
    r = back.run(budget=4)
    assert (r.state_count, r.unique_state_count) == GOLD_2PC4 and r.complete


# -- tiered design checkpoints, both ways -------------------------------------------------


@pytest.mark.parametrize("variant", ["sort", "capped"])
def test_resident_tiered_design_checkpoints_cross_both_ways(variant, tmp_path):
    kw = dict(insert_variant=variant, **RESIDENT_TIERED)
    rs = ResidentSearch(pm.TensorTwoPhaseSys(4), 32, 11, device="cpu", **kw)
    rs.run(max_steps=40)
    jrs = JaxResident(jm.TensorTwoPhaseSys(4), 32, 11, append="scatter", **kw)
    jrs.run(max_steps=40, budget=16)
    assert rs.store_stats()["spill_events"] == jrs.store_stats()["spill_events"] == 1
    port_ckpt, jax_ckpt = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    rs.checkpoint(port_ckpt)
    jrs.checkpoint(jax_ckpt)
    into_jax = JaxResident.load_checkpoint(jm.TensorTwoPhaseSys(4), port_ckpt)
    into_port = ResidentSearch.load_checkpoint(pm.TensorTwoPhaseSys(4), jax_ckpt, device="cpu")
    assert into_jax.insert_variant == into_port.insert_variant == variant
    data = np.load(jax_ckpt)
    _assert_table(into_port._c["t_key"], into_port._c["t_parent"],
                  [data[k] for k in ("t_lo", "t_hi", "p_lo", "p_hi")])
    # Both files hold the same table, spill tier and counters.
    pdata = np.load(port_ckpt)
    for k in ("t_lo", "t_hi", "p_lo", "p_hi", "spill_fps", "spill_parents", "head", "tail",
              "hot_claims"):
        np.testing.assert_array_equal(pdata[k], data[k], err_msg=k)
    full = JaxResident(jm.TensorTwoPhaseSys(4), 32, 11, append="scatter", **kw)
    jr = full.run()
    for r, eng in ((into_jax.run(), into_jax), (into_port.run(), into_port)):
        _assert_result(r, jr, GOLD_2PC4)
        assert eng.store_stats()["spill_events"] >= 1
    _assert_same_store(into_port, into_jax)
    _assert_table(into_port._c["t_key"], into_port._c["t_parent"], full._last_tables)


def test_frontier_tiered_design_checkpoints_cross_both_ways(tmp_path):
    kw = dict(insert_variant="phased", **FRONTIER_TIERED)
    fs = FrontierSearch(pm.TensorTwoPhaseSys(3), 16, 9, device="cpu", **kw)
    jfs = JaxFrontier(jm.TensorTwoPhaseSys(3), 16, 9, **kw)
    for eng in (fs, jfs):
        while eng.store_stats()["spill_events"] == 0:
            assert not eng.run(max_steps=5).complete
    port_ckpt, jax_ckpt = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    fs.checkpoint(port_ckpt)
    jfs.checkpoint(jax_ckpt)
    into_jax = JaxFrontier.load_checkpoint(jm.TensorTwoPhaseSys(3), port_ckpt, batch_size=16)
    into_port = FrontierSearch.load_checkpoint(pm.TensorTwoPhaseSys(3), jax_ckpt,
                                               batch_size=16, device="cpu")
    assert into_jax.insert_variant == into_port.insert_variant == "phased"
    data = np.load(jax_ckpt)
    _assert_table(into_port.table.t_key, into_port.table.t_parent,
                  [data[k] for k in ("t_lo", "t_hi", "p_lo", "p_hi")])
    jr = JaxFrontier(jm.TensorTwoPhaseSys(3), 16, 9, **kw).run()
    for r in (into_jax.run(), into_port.run()):
        _assert_result(r, jr, GOLD_2PC3)
    _assert_same_store(into_port, into_jax)
    t = into_jax.table
    _assert_table(into_port.table.t_key, into_port.table.t_parent,
                  (t.t_lo, t.t_hi, t.p_lo, t.p_hi))
