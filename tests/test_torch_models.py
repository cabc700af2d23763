"""The port's tensor models against the JAX package's: `expand`, `valid`,
`within_boundary`, every property mask and `representative` exactly equal
on every reachable state of small configurations and on random rows; the
increment, increment-lock and Raft goldens through the port engine."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.tensor import models as jm
from stateright_tpu_torch.tensor import models as tm


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    several processes at once, and torch's default of a thread per core in
    each of them oversubscribes the cores (the eager searches here then ran
    ~100x slower than alone). Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reachable(tmodel, batch_size=64, table_log2=12):
    """Every reachable state of `tmodel`: the port engine's state-set dump
    (its state set equals the JAX engine's: tests/test_torch_resident.py
    compares the two visited tables)."""
    from stateright_tpu_torch.tensor.resident import ResidentSearch

    rs = ResidentSearch(tmodel, batch_size, table_log2, device="cpu")
    rs.run()
    return np.array(rs.dump_states(decode=False), dtype=np.uint32)


def _reachable_2pc3():
    return reachable(tm.TensorTwoPhaseSys(3))


def _assert_same(jmodel, tmodel, rows, valid_only=False):
    """Successors, valid masks, boundary, property masks, representative
    and display hooks equal. With `valid_only`, successors are compared on
    the valid slots only (the parity contract: what an invalid slot holds
    is never read). Every lane of a valid successor is a uint32 value."""
    assert (jmodel.lanes, jmodel.max_actions) == (tmodel.lanes, tmodel.max_actions)
    # The JAX side jitted: one compile instead of one per op.
    j_s, j_v = jax.jit(jmodel.expand)(jnp.asarray(rows))
    t_s, t_v = tmodel.expand(torch.from_numpy(rows.astype(np.int64)))
    j_s, t_s = np.asarray(j_s).astype(np.int64), t_s.numpy()
    np.testing.assert_array_equal(t_v.numpy(), np.asarray(j_v))
    keep = t_v.numpy() if valid_only else np.ones(t_v.shape, dtype=bool)
    np.testing.assert_array_equal(t_s[keep], j_s[keep])
    assert ((t_s[t_v.numpy()] >= 0) & (t_s[t_v.numpy()] < 1 << 32)).all()
    if jmodel.representative is not None:
        np.testing.assert_array_equal(
            tmodel.representative(torch.from_numpy(rows.astype(np.int64))).numpy(),
            np.asarray(jax.jit(jmodel.representative)(jnp.asarray(rows))).astype(np.int64),
        )
    else:
        assert tmodel.representative is None
    flat = rows.reshape(-1, rows.shape[-1])
    np.testing.assert_array_equal(
        tmodel.within_boundary(torch.from_numpy(flat.astype(np.int64))).numpy(),
        np.asarray(jmodel.within_boundary(jnp.asarray(flat))),
    )
    jprops, tprops = jmodel.properties(), tmodel.properties()
    assert [(p.name, p.expectation.value) for p in jprops] == [
        (p.name, p.expectation.value) for p in tprops
    ]
    for jp, tp in zip(jprops, tprops):
        np.testing.assert_array_equal(
            tp.condition(tmodel, torch.from_numpy(rows.astype(np.int64))).numpy(),
            np.asarray(jax.jit(lambda s, c=jp.condition: c(jmodel, s))(jnp.asarray(rows))),
        )
    for r in rows[:16]:
        assert tmodel.decode(r) == jmodel.decode(r)
        for a in range(jmodel.max_actions):
            assert tmodel.action_label(r, a) == jmodel.action_label(r, a)


def test_2pc3_every_reachable_state():
    rows = _reachable_2pc3()
    assert len(rows) == 288
    _assert_same(jm.TensorTwoPhaseSys(3), tm.TensorTwoPhaseSys(3), rows)


def test_2pc_random_rows_wider_models():
    # Rows outside the reachable set too: the encodings must agree on any
    # input, not only on the states a search happens to reach.
    rng = np.random.default_rng(5)
    for n in (4, 10):
        rows = np.concatenate(
            [
                rng.integers(0, 4, (512, n)),
                rng.integers(0, 3, (512, 1)),
                rng.integers(0, 1 << n, (512, 1)),
                rng.integers(0, 1 << (n + 2), (512, 1)),
            ],
            axis=1,
        ).astype(np.uint32)
        _assert_same(jm.TensorTwoPhaseSys(n), tm.TensorTwoPhaseSys(n), rows)


@pytest.mark.parametrize("abc", [(2, 10, 14), (2, 4, 7), (1, 1, 0)])
def test_linear_equation_random_rows(abc):
    rng = np.random.default_rng(sum(abc))
    rows = rng.integers(0, 256, (2048, 2), dtype=np.uint32)
    rows[:4] = [[0, 0], [255, 255], [255, 0], [0, 255]]
    _assert_same(jm.TensorLinearEquation(*abc), tm.TensorLinearEquation(*abc), rows)


@pytest.mark.parametrize("symmetry", [True, "value"])
def test_2pc3_symmetric_every_reachable_state(symmetry):
    rows = _reachable_2pc3()
    _assert_same(
        jm.TensorTwoPhaseSys(3, symmetry=symmetry),
        tm.TensorTwoPhaseSys(3, symmetry=symmetry),
        rows,
    )


def _pairs_rows(rng, n_rows, head, n, t_max, pc_max):
    """Random increment-style rows: `head` lanes in [0, 8), then n (t, pc)
    pairs."""
    return np.concatenate(
        [rng.integers(0, 8, (n_rows, head))]
        + [
            np.stack([rng.integers(0, t_max, n_rows), rng.integers(0, pc_max, n_rows)], 1)
            for _ in range(n)
        ],
        axis=1,
    ).astype(np.uint32)


@pytest.mark.parametrize("symmetry", [False, True])
@pytest.mark.parametrize("n", [2, 3])
def test_increment_every_reachable_state_and_random_rows(n, symmetry):
    jmodel = jm.TensorIncrement(n, symmetry=symmetry, full_enumeration=True)
    tmodel = tm.TensorIncrement(n, symmetry=symmetry, full_enumeration=True)
    _assert_same(jmodel, tmodel, reachable(tmodel))
    rows = _pairs_rows(np.random.default_rng(n), 1024, 1, n, 6, 4)
    rows[:2, 1] = 0xFFFFFFFF  # t + 1 wraps as uint32
    _assert_same(jmodel, tmodel, rows)


@pytest.mark.parametrize("symmetry", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_increment_lock_every_reachable_state_and_random_rows(n, symmetry):
    jmodel = jm.TensorIncrementLock(n, symmetry=symmetry)
    tmodel = tm.TensorIncrementLock(n, symmetry=symmetry)
    _assert_same(jmodel, tmodel, reachable(tmodel, 256, 14))
    rows = _pairs_rows(np.random.default_rng(10 + n), 1024, 2, n, 6, 5)
    rows[:, 1] &= 1
    _assert_same(jmodel, tmodel, rows)


@pytest.mark.parametrize("n", [3, 4])
def test_raft_every_reachable_state_and_random_rows(n):
    jmodel, tmodel = jm.TensorRaft(n, max_term=2), tm.TensorRaft(n, max_term=2)
    _assert_same(jmodel, tmodel, reachable(tmodel, 1024, 16))
    rng = np.random.default_rng(20 + n)
    rows = np.concatenate(
        [rng.integers(0, 4, (1024, n)), rng.integers(0, 3, (1024, n)),
         rng.integers(0, n + 1, (1024, n))],
        axis=1,
    ).astype(np.uint32)
    rows[:2, 0] = 0xFFFFFFFF  # term + 1 wraps as uint32
    _assert_same(jm.TensorRaft(n, max_term=3), tm.TensorRaft(n, max_term=3), rows)


def test_raft3_goldens_and_eventually_counterexample():
    # The JAX package pins (2050, 601) at tests/test_device_simulation.py.
    c = tm.TensorRaft(3, max_term=3).checker().spawn_cuda(
        batch_size=1024, table_log2=14, device="cpu"
    ).join()
    assert (c.state_count(), c.unique_state_count()) == (2050, 601)
    assert c.result().complete
    paths = c.discoveries()
    assert set(paths) == {"leader elected", "can elect"}
    c.assert_no_discovery("election safety")
    # The split-vote walk: a terminal state with no leader ever (the
    # eventually bit survived to a state with no successors).
    for name, path in paths.items():
        c.assert_discovery(name, path.actions())
    last = paths["leader elected"].last_state()
    assert all(role != "L" for _, role, _ in last), last
