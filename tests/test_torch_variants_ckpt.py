"""Checkpoint, regrow, undo and host reads of the XLA insert designs on the
port's resident and host-driven engines, held against the JAX package's
engines (CPU): files cross both ways for "sort", "capped" and "phased" and
load slot for slot; both packages refuse to save a kv table; a regrow goes
through the "sort" design, over the occupied slots in slot order, and
equals the JAX regrow slot for slot; the undo of an aborted chunk gives back
the boundary's table under "sort"; and an audited resident step makes
exactly the host reads each design's docstring states. Every comparison is
exact."""

import math

import numpy as np
import pytest

from stateright_tpu.tensor import models as jm
from stateright_tpu.tensor.frontier import FrontierSearch as JaxFrontier
from stateright_tpu.tensor.resident import ResidentSearch as JaxResident
from stateright_tpu_torch.analysis.auditor import audit_fn
from stateright_tpu_torch.tensor import models as pm
from stateright_tpu_torch.tensor.frontier import FrontierSearch
from stateright_tpu_torch.tensor.hashtable import CAP_MAX_TILES, CLAIM_TILE
from stateright_tpu_torch.tensor.pallas_hashtable import to_jax_table
from stateright_tpu_torch.tensor.resident import ResidentSearch
from tests.test_torch_checkpoint import _assert_same_carry

GOLD = (8258, 1568)
DESIGNS = ["sort", "capped", "phased"]


def port(variant, *args, **kw):
    return ResidentSearch(pm.TensorTwoPhaseSys(4), *args, insert_variant=variant,
                          device="cpu", **kw)


def load(path, **kw):
    return ResidentSearch.load_checkpoint(pm.TensorTwoPhaseSys(4), path, device="cpu", **kw)


def _arrays(data):
    return [np.asarray(data[k]) for k in ("t_lo", "t_hi", "p_lo", "p_hi")]


def _assert_table(rs, arrays):
    for ours, theirs in zip(to_jax_table(rs._c["t_key"], rs._c["t_parent"]), arrays):
        np.testing.assert_array_equal(ours, theirs)


@pytest.fixture(scope="module")
def full():
    """The JAX engine's uninterrupted run on each design: the oracle."""
    out = {}
    for v in DESIGNS:
        rs = JaxResident(jm.TensorTwoPhaseSys(4), 256, 14, insert_variant=v, append="scatter")
        out[v] = (rs.run(), [np.asarray(a) for a in rs._last_tables])
    return out


def _assert_full(r, theirs):
    assert r.complete and (r.state_count, r.unique_state_count) == GOLD
    assert (r.max_depth, r.discoveries) == (theirs.max_depth, theirs.discoveries)


@pytest.mark.parametrize("variant", DESIGNS)
def test_checkpoints_cross_both_ways_slot_for_slot(tmp_path, full, variant):
    theirs, final = full[variant]
    # The port's file, resumed by the JAX engine on the same design.
    rs = port(variant, 256, 14)
    rs.run(max_steps=3, budget=1)
    ours_ckpt = str(tmp_path / "port.npz")
    rs.checkpoint(ours_ckpt)
    jax_rs = JaxResident.load_checkpoint(jm.TensorTwoPhaseSys(4), ours_ckpt)
    assert jax_rs.insert_variant == variant
    _assert_full(jax_rs.run(), theirs)
    # The JAX file, loaded slot for slot and run to the uninterrupted
    # run's final table.
    jax_rs = JaxResident(jm.TensorTwoPhaseSys(4), 256, 14, insert_variant=variant,
                         append="scatter")
    jax_rs.run(max_steps=3, budget=1)
    jax_ckpt = str(tmp_path / "jax.npz")
    jax_rs.checkpoint(jax_ckpt)
    loaded = load(jax_ckpt)
    assert loaded.insert_variant == variant
    _assert_table(loaded, _arrays(np.load(jax_ckpt)))
    _assert_full(loaded.run(), theirs)
    _assert_table(loaded, final)


def test_frontier_checkpoint_crosses_to_the_jax_engine(tmp_path):
    fs = FrontierSearch(pm.TensorTwoPhaseSys(4), 256, 14, insert_variant="capped",
                        device="cpu")
    fs.run(max_steps=3)
    ckpt = str(tmp_path / "port.npz")
    fs.checkpoint(ckpt)
    jfs = JaxFrontier.load_checkpoint(jm.TensorTwoPhaseSys(4), ckpt, batch_size=256)
    assert jfs.insert_variant == "capped"
    r = jfs.run()
    assert (r.state_count, r.unique_state_count) == GOLD and r.complete
    back = FrontierSearch.load_checkpoint(pm.TensorTwoPhaseSys(4), ckpt, batch_size=256,
                                          device="cpu")
    assert back.insert_variant == "capped"
    ours = back.run()
    assert (ours.state_count, ours.unique_state_count, ours.discoveries) == (
        r.state_count, r.unique_state_count, r.discoveries)


def test_both_packages_refuse_to_save_a_kv_table(tmp_path):
    jax_rs = JaxResident(jm.TensorTwoPhaseSys(4), 256, 14, table_layout="kv")
    jax_rs.run(max_steps=2, budget=1)
    with pytest.raises(NotImplementedError):
        jax_rs.checkpoint(str(tmp_path / "jax.npz"))
    rs = port("sort", 256, 14, table_layout="kv")
    rs.run(max_steps=2)
    with pytest.raises(NotImplementedError):
        rs.checkpoint(str(tmp_path / "port.npz"))


@pytest.mark.parametrize("variant", ["sort", "phased"])
def test_regrow_equals_the_jax_regrow_slot_for_slot(tmp_path, variant):
    jax_rs = JaxResident(jm.TensorTwoPhaseSys(4), 256, 12, insert_variant=variant,
                         append="scatter")
    jax_rs.run(max_steps=6, budget=1)
    ckpt = str(tmp_path / "jax.npz")
    jax_rs.checkpoint(ckpt)
    grown = JaxResident.load_checkpoint(jm.TensorTwoPhaseSys(4), ckpt, table_log2=13)
    c = grown._carry
    theirs = [np.asarray(a) for a in (c.t_lo, c.t_hi, c.p_lo, c.p_hi)]
    ours = load(ckpt, table_log2=13)
    assert ours.insert_variant == variant and ours.table_log2 == 13
    _assert_table(ours, theirs)
    # A file the port wrote regrows to the same table.
    port_ckpt = str(tmp_path / "port.npz")
    ours.checkpoint(port_ckpt)
    again = load(port_ckpt, table_log2=14)
    jax_again = JaxResident.load_checkpoint(jm.TensorTwoPhaseSys(4), port_ckpt, table_log2=14)
    c = jax_again._carry
    _assert_table(again, [np.asarray(a) for a in (c.t_lo, c.t_hi, c.p_lo, c.p_hi)])
    r = again.run()
    assert (r.state_count, r.unique_state_count) == GOLD and r.complete


@pytest.mark.parametrize("kw", [dict(table_log2=14, queue_log2=8), dict(table_log2=10)],
                         ids=["queue_abort", "table_abort"])
def test_undo_restores_the_chunk_boundary_under_sort(kw):
    aborted = port("sort", 256, **kw)
    with pytest.raises(RuntimeError, match="chunk boundary"):
        aborted.run(budget=2)
    n = int(aborted._c["steps"])
    assert n > 0 and n % 2 == 0
    stopped = port("sort", 256, **kw)
    stopped.run(max_steps=n, budget=2)
    _assert_same_carry(aborted._c, stopped._c)


@pytest.mark.parametrize("variant", ["pallas", "sort", "capped"])
def test_audited_step_makes_the_stated_host_reads(variant):
    rs = port(variant, 256, 14)
    rs.run(max_steps=4)
    fn, args, slots = rs.audit_step()
    before = int(rs._c["gen"])
    report = audit_fn(fn, args, host_slots=slots)
    reads = sum(v.rule == "host-sync" for v in report.violations)
    active = int(report.out["gen"]) - before  # the step's inserted lanes
    B = 256 * rs.model.max_actions
    pow2_b = 1 << max(B - 1, 1).bit_length()
    tile = min(pow2_b, max(CLAIM_TILE, pow2_b // CAP_MAX_TILES))
    # pallas: none; sort: one (no carry round at this load); capped: the
    # compaction and one a tile.
    assert reads == {"pallas": 0, "sort": 1, "capped": 1 + math.ceil(active / tile)}[variant]
    assert active > 0
