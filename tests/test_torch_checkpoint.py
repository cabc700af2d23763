"""Checkpoint, regrow and resume of the port's resident engine
(stateright_tpu_torch/tensor/resident.py, faults/ckptio.py) on the CPU,
held against the JAX package: its resident checkpoint tests
(tests/test_checkpoint.py:113-240) mirrored through the port with the same
goldens, the port's guards, the undo of an aborted chunk, and checkpoints
that cross between the two packages in both directions (the JAX engine with
insert_variant="pallas" in interpret mode, and with its default "sort",
which the port resumes on its own "sort" design, slot for slot).
Every comparison is exact (tolerance 0: integers and bits)."""

import os

import numpy as np
import pytest
import torch

from stateright_tpu.faults import ckptio as jax_ckptio
from stateright_tpu.tensor.models import TensorTwoPhaseSys as JaxTwoPhase
from stateright_tpu.tensor.resident import ResidentSearch as JaxResident
from stateright_tpu_torch.faults import ckptio
from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys
from stateright_tpu_torch.tensor.pallas_hashtable import dump_table, from_jax_table
from stateright_tpu_torch.tensor.resident import (
    ABORT_QUEUE,
    ABORT_TABLE,
    ResidentSearch,
)

GOLD_2PC4 = (8258, 1568)
PIN = dict(high_water=0.6, summary_log2=14)  # test_torch_tiered.py's 2^11 hot tier


def port(*args, **kw):
    return ResidentSearch(TensorTwoPhaseSys(4), *args, device="cpu", **kw)


def load(path, **kw):
    return ResidentSearch.load_checkpoint(TensorTwoPhaseSys(4), path, device="cpu", **kw)


@pytest.fixture(scope="module")
def full():
    """The JAX engine's uninterrupted 2pc-4 run, the oracle of every resume."""
    r = JaxResident(JaxTwoPhase(4), 256, 14).run()
    assert (r.state_count, r.unique_state_count) == GOLD_2PC4
    return r


def assert_full(r, full):
    assert r.complete
    assert (r.state_count, r.unique_state_count) == GOLD_2PC4
    assert r.max_depth == full.max_depth
    assert r.discoveries == full.discoveries


# -- the JAX package's resident checkpoint tests, through the port -------------


def test_chunked_matches_single_dispatch(full):
    single = port(256, 14).run()
    chunked = port(256, 14).run(budget=3)
    assert_full(single, full)
    assert_full(chunked, full)


def test_suspend_and_resume_in_place(full):
    rs = port(256, 14)
    partial = rs.run(max_steps=2, budget=1)
    assert not partial.complete and partial.steps == 2
    assert partial.state_count < GOLD_2PC4[0]
    assert_full(rs.run(), full)  # continues the retained carry


def test_progress_callback_is_monotone():
    seen = []
    ResidentSearch(TensorTwoPhaseSys(3), 128, 12, device="cpu").run(
        budget=2, progress=lambda sc, uc, md: seen.append((sc, uc, md))
    )
    assert len(seen) >= 2
    assert seen[-1][1] == 288
    assert all(a <= b for a, b in zip(seen, seen[1:]))


def test_kill_and_resume_reproduces_exact_counts(tmp_path, full):
    rs = port(256, 14)
    assert not rs.run(max_steps=2, budget=1).complete
    ckpt = str(tmp_path / "resident.npz")
    rs.checkpoint(ckpt)
    del rs
    resumed = load(ckpt)
    r = resumed.run()
    assert_full(r, full)
    path = resumed.reconstruct_path(r.discoveries["commit agreement"])
    assert path.last_state() is not None
    assert len(path) - 1 == 13


def test_overflow_checkpoints_then_regrows(tmp_path, full):
    # 1,568 unique states cannot fit a 2^10-slot table.
    rs = port(256, 10)
    with pytest.raises(RuntimeError, match="checkpoint"):
        rs.run(budget=2)
    assert rs._last_abort == ABORT_TABLE
    ckpt = str(tmp_path / "overflowed.npz")
    rs.checkpoint(ckpt)  # the carry is back at the last chunk boundary
    del rs
    with pytest.raises(ValueError, match="larger table_log2"):
        load(ckpt)
    grown = load(ckpt, table_log2=14)
    assert grown.table_log2 == 14 and grown.queue_log2 == 14  # the queue follows
    assert_full(grown.run(), full)


def test_queue_overflow_abort_reason_preserved(tmp_path):
    rs = port(256, 14, queue_log2=8)
    with pytest.raises(RuntimeError, match="frontier queue full"):
        rs.run(budget=2)
    assert rs._last_abort & ABORT_QUEUE
    assert not rs._last_abort & ABORT_TABLE
    ckpt = str(tmp_path / "queue_overflowed.npz")
    rs.checkpoint(ckpt)
    del rs
    with pytest.raises(ValueError, match="queue"):
        load(ckpt)  # a right-sized queue is kept, and it is what overflowed
    r = load(ckpt, queue_log2=12).run()
    assert r.complete and (r.state_count, r.unique_state_count) == GOLD_2PC4
    assert "commit agreement" in r.discoveries


def test_timeout_suspends_not_raises(full):
    rs = port(64, 14)
    r = rs.run(timeout=0.0, budget=1)
    assert not r.complete and r.steps == 1
    assert_full(rs.run(), full)


def test_reset_starts_afresh(full):
    rs = port(256, 14)
    rs.run(max_steps=2)
    rs.reset()
    r = rs.run()
    assert_full(r, full)
    assert r.steps == port(256, 14).run().steps


# -- the port's guards ------------------------------------------------------------


def test_layout_mismatch_rejected(tmp_path):
    rs = port(64, 12)
    rs.run(max_steps=1)
    ckpt = str(tmp_path / "s.npz")
    rs.checkpoint(ckpt)
    with pytest.raises(ValueError, match="layout"):
        ResidentSearch.load_checkpoint(TensorTwoPhaseSys(5), ckpt, device="cpu")


def test_checkpoint_before_run_rejected(tmp_path):
    with pytest.raises(RuntimeError, match="nothing to checkpoint"):
        port(64, 12).checkpoint(str(tmp_path / "s.npz"))


def test_shrinking_table_rejected(tmp_path):
    rs = port(64, 12)
    rs.run(max_steps=1)
    ckpt = str(tmp_path / "s.npz")
    rs.checkpoint(ckpt)
    with pytest.raises(ValueError, match="cannot shrink"):
        load(ckpt, table_log2=11)


# -- the undo of an aborted chunk --------------------------------------------------


def _assert_same_carry(a, b, tiered=False):
    tail = int(a["tail"])
    names = ["head", "tail", "gen", "unique", "max_depth", "discovered", "steps", "overflow"]
    arrays = {"q_states": tail, "q_keys": tail, "q_ebits": tail, "q_depth": tail}
    if tiered:
        s_tail = int(a["s_tail"])
        names += ["hot", "s_tail"]
        arrays.update(s_states=s_tail, s_keys=s_tail, s_ebits=s_tail, s_depth=s_tail)
    assert [int(a[k]) for k in names] == [int(b[k]) for k in names]
    for k in ("t_key", "t_parent", "disc_keys"):
        assert torch.equal(a[k], b[k]), k
    for k, n in arrays.items():
        assert torch.equal(a[k][:n], b[k][:n]), k
    assert dump_table(a["t_key"], a["t_parent"]) == dump_table(b["t_key"], b["t_parent"])


@pytest.mark.parametrize("kw", [dict(table_log2=14, queue_log2=8), dict(table_log2=10)],
                         ids=["queue_abort", "table_abort"])
def test_undo_restores_the_chunk_boundary(kw):
    aborted = port(256, **kw)
    with pytest.raises(RuntimeError, match="chunk boundary"):
        aborted.run(budget=2)
    n = int(aborted._c["steps"])
    assert n > 0 and n % 2 == 0
    stopped = port(256, **kw)
    stopped.run(max_steps=n, budget=2)
    _assert_same_carry(aborted._c, stopped._c)


def test_undo_restores_a_tiered_boundary_with_suspects():
    # An abort forced at step 40 of 2pc-4 through a 2^11 hot tier, after a
    # spill: the aborted chunk appends rows to the queue and suspects to a
    # buffer that already holds some at the boundary.
    rs = port(32, 11, store="tiered", **PIN)
    boundaries, undone = [], {}
    run_chunk, step, undo = rs._chunk, rs._step, rs._undo_chunk

    def chunk(c, *args):
        boundaries.append({k: v.clone() for k, v in c.items()})
        run_chunk(c, *args)

    def forced_abort_step(c, go, tmd):
        step(c, go, tmd)
        c["overflow"] = c["overflow"] | torch.where(c["steps"] >= 40, ABORT_TABLE, 0)

    def recorded_undo():
        undone.update(tail=int(rs._c["tail"]), s_tail=int(rs._c["s_tail"]))
        undo()

    rs._chunk, rs._step, rs._undo_chunk = chunk, forced_abort_step, recorded_undo
    with pytest.raises(RuntimeError, match="chunk boundary"):
        rs.run(budget=4)
    before = boundaries[-1]
    assert rs.store_stats()["spill_events"] == 1
    assert 0 < int(before["s_tail"]) < undone["s_tail"]
    assert int(before["tail"]) < undone["tail"]
    _assert_same_carry(rs._c, before, tiered=True)


# -- across the two packages ---------------------------------------------------------


def test_port_checkpoint_resumes_in_the_jax_engine(tmp_path, full):
    rs = port(256, 14)
    rs.run(max_steps=2)
    ckpt = str(tmp_path / "port.npz")
    rs.checkpoint(ckpt)
    jax_rs = JaxResident.load_checkpoint(JaxTwoPhase(4), ckpt)
    assert jax_rs.insert_variant == "pallas"
    assert_full(jax_rs.run(), full)


def test_jax_pallas_checkpoint_resumes_slot_for_slot(tmp_path, full):
    jax_rs = JaxResident(JaxTwoPhase(4), 256, 14, insert_variant="pallas")
    jax_rs.run(max_steps=2, budget=1)
    ckpt = str(tmp_path / "jax_pallas.npz")
    jax_rs.checkpoint(ckpt)
    rs = load(ckpt)
    t_key, t_parent = from_jax_table(
        *(np.asarray(getattr(jax_rs._carry, f)) for f in ("t_lo", "t_hi", "p_lo", "p_hi"))
    )
    assert torch.equal(rs._c["t_key"], t_key) and torch.equal(rs._c["t_parent"], t_parent)
    assert_full(rs.run(), full)


def test_jax_sort_checkpoint_resumes_through_the_reinsert(tmp_path, full):
    # The port has the "sort" design now: a JAX "sort" file resumes on it,
    # its table taken slot for slot (no re-insert), and runs to the golden.
    jax_rs = JaxResident(JaxTwoPhase(4), 256, 14)  # the "sort" slot layout
    jax_rs.run(max_steps=2, budget=1)
    ckpt = str(tmp_path / "jax_sort.npz")
    jax_rs.checkpoint(ckpt)
    rs = load(ckpt)
    assert rs.insert_variant == "sort"
    c, data = rs._c, np.load(ckpt)
    t_key, t_parent = from_jax_table(data["t_lo"], data["t_hi"], data["p_lo"], data["p_hi"])
    assert torch.equal(c["t_key"], t_key) and torch.equal(c["t_parent"], t_parent)
    assert dump_table(c["t_key"], c["t_parent"]) == jax_rs.build_parent_map()
    assert_full(rs.run(), full)


def _spilled(store):
    return store.store.to_arrays()


def test_tiered_checkpoint_mid_spill_both_ways(tmp_path, full):
    # Both engines stop at step 40, after the one spill event of the run.
    rs = port(32, 11, store="tiered", **PIN)
    rs.run(max_steps=40)
    jax_rs = JaxResident(JaxTwoPhase(4), 32, 11, insert_variant="pallas",
                         store="tiered", **PIN)
    jax_rs.run(max_steps=40)
    assert rs.store_stats()["spill_events"] == jax_rs.store_stats()["spill_events"] == 1
    for ours, theirs in zip(_spilled(rs._store), _spilled(jax_rs._store)):
        np.testing.assert_array_equal(ours, theirs)
    port_ckpt, jax_ckpt = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    rs.checkpoint(port_ckpt)
    jax_rs.checkpoint(jax_ckpt)

    into_jax = JaxResident.load_checkpoint(JaxTwoPhase(4), port_ckpt)
    into_port = load(jax_ckpt)
    for loaded in (into_jax, into_port):
        for ours, theirs in zip(_spilled(loaded._store), _spilled(rs._store)):
            np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(into_jax._store.summary_np,
                                  into_port._store.summary.numpy().view(np.uint32))
    for r in (into_jax.run(), into_port.run()):
        assert_full(r, full)
        assert r.detail["spill_events"] >= 1
    for fp in full.discoveries.values():
        assert into_port.reconstruct_path(fp).into_pairs() == \
            into_jax.reconstruct_path(fp).into_pairs()


# -- the checkpoint file --------------------------------------------------------------


def test_file_is_read_by_both_packages(tmp_path):
    arrays = {"a": np.arange(5, dtype=np.uint32), "gen": np.asarray([1])}
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    ckptio.atomic_savez(ours, arrays)
    jax_ckptio.atomic_savez(theirs, arrays)  # deflated entries
    for path in (ours, theirs):
        for read in (ckptio.read_verified, jax_ckptio.read_verified):
            data = read(path)
            np.testing.assert_array_equal(data["a"], arrays["a"])
    with open(ours, "rb") as f:
        tail = f.read()[-ckptio._FOOTER.size:]
    assert tail[:8] == jax_ckptio.MAGIC and ckptio._FOOTER.size == jax_ckptio._FOOTER.size


@pytest.mark.parametrize("tear", ["truncate", "flip"])
def test_torn_current_generation_falls_back_to_prev(tmp_path, tear):
    path = str(tmp_path / "ck.npz")
    ckptio.atomic_savez(path, {"gen": np.asarray([1])})
    ckptio.atomic_savez(path, {"gen": np.asarray([2])})  # 1 moves to .prev
    assert os.path.exists(path + ".prev")
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        if tear == "truncate":
            f.truncate(size // 2)
        else:
            f.seek(size // 3)
            b = f.read(1)
            f.seek(size // 3)
            f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(ckptio.CheckpointCorrupt):
        ckptio.read_verified(path)
    for load_latest in (ckptio.load_latest, jax_ckptio.load_latest):
        data, src = load_latest(path)
        assert src == path + ".prev" and int(data["gen"][0]) == 1
    # A new generation must not rotate the torn one into .prev.
    ckptio.atomic_savez(path, {"gen": np.asarray([3])})
    assert int(ckptio.read_verified(path + ".prev")["gen"][0]) == 1
    for p in (path, path + ".prev"):
        with open(p, "r+b") as f:
            f.truncate(10)
    with pytest.raises(ckptio.CheckpointCorrupt, match="no intact checkpoint"):
        ckptio.load_latest(path)
