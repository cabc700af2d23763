"""Checkpoints of the port's sharded search, on gloo ranks on the CPU,
against the JAX package's `ShardedSearch` (its tests/test_sharded.py:150-231):
kill and resume, overflow then regrow, a chip-count mismatch refused, and
the file format both ways — a port file resumes in the JAX engine on a
mesh of the same size, and a JAX pallas-variant file resumes here, each to
the counts and per-shard uniques of an uninterrupted run. Counts are
integers: the tolerance is 0."""

import pytest

import sharded_ranks
from stateright_tpu.parallel import ShardedSearch as JaxSharded
from stateright_tpu.parallel import make_mesh
from stateright_tpu.tensor import models as jm
from stateright_tpu_torch.parallel import run_world


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_ckpt")
    return {k: str(d / f"{k}.npz") for k in ("port", "mismatch", "regrow", "jax")}


@pytest.fixture(scope="module")
def world4(files):
    out = run_world(sharded_ranks.checkpoints_of_4, 4, files["port"], files["mismatch"],
                    files["regrow"], device="cpu", timeout=300)
    assert all(o == out[0] for o in out[1:]), "the ranks disagree"
    return out[0]


@pytest.fixture(scope="module")
def world2(files, world4):
    # A JAX pallas-variant file, suspended after two one-step chunks.
    ss = JaxSharded(jm.TensorTwoPhaseSys(4), mesh=make_mesh(2), batch_size=128,
                    table_log2=13, insert_variant="pallas")
    assert not ss.run(max_steps=2, budget=1).complete
    ss.checkpoint(files["jax"])
    out = run_world(sharded_ranks.checkpoints_of_2, 2, files["jax"], files["mismatch"],
                    device="cpu", timeout=300)
    assert out[0] == out[1], "the ranks disagree"
    return out[0]


def _jax_full(model, n, **kw):
    return sharded_ranks.summary(JaxSharded(model, mesh=make_mesh(n), **kw).run())


def test_kill_and_resume_reproduces_the_full_run(world4):
    full = world4["full"]
    assert full == _jax_full(jm.TensorTwoPhaseSys(4), 4, batch_size=128, table_log2=13)
    assert not world4["partial"]["complete"] and world4["partial"]["steps"] == 2
    assert world4["resumed"] == full
    assert world4["path"][-1][0] is not None


def test_overflow_checkpoints_then_regrows(world4):
    assert "overflow" in world4["overflow"] and "checkpoint" in world4["overflow"]
    assert world4["grown_log2"] == 14
    want = _jax_full(jm.TensorTwoPhaseSys(5), 4, batch_size=128, table_log2=14)
    got = world4["grown"]
    assert got["counts"] == want["counts"] and got["counts"][1] == 8832
    assert got["discoveries"] == want["discoveries"] and got["complete"]
    assert got["per_chip"] == want["per_chip"]


def test_chip_count_mismatch_is_refused(world2):
    assert "chips" in world2["mismatch"]


def test_port_file_resumes_in_jax(files, world4):
    j = JaxSharded.load_checkpoint(jm.TensorTwoPhaseSys(4), files["port"], mesh=make_mesh(4))
    assert j.insert_variant == "pallas" and j.n_chips == 4
    r = j.run()
    got = sharded_ranks.summary(r)
    full = world4["full"]
    assert got["counts"] == full["counts"] == (8258, 1568) and got["complete"]
    assert got["per_chip"] == full["per_chip"]
    assert got["discoveries"] == full["discoveries"]


def test_jax_file_resumes_in_the_port(world2):
    want = _jax_full(jm.TensorTwoPhaseSys(4), 2, batch_size=128, table_log2=13,
                     insert_variant="pallas")
    got = world2["jax"]
    assert got["counts"] == want["counts"] == (8258, 1568)
    assert got["per_chip"] == want["per_chip"] and got["complete"]
    assert got["discoveries"] == want["discoveries"]
