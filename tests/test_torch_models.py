"""The port's tensor models against the JAX package's: `expand`, `valid`,
`within_boundary` and every property mask exactly equal on every reachable
2pc-3 state and on random LinearEquation rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.tensor import models as jm
from stateright_tpu_torch.tensor import models as tm


def _reachable_2pc3():
    """Every reachable 2pc-3 state (288): the port engine's state-set dump
    (its state set equals the JAX engine's: tests/test_torch_resident.py
    compares the two visited tables)."""
    from stateright_tpu_torch.tensor.resident import ResidentSearch

    rs = ResidentSearch(tm.TensorTwoPhaseSys(3), 64, 12, device="cpu")
    rs.run()
    return np.array(rs.dump_states(decode=False), dtype=np.uint32)


def _assert_same(jmodel, tmodel, rows):
    assert (jmodel.lanes, jmodel.max_actions) == (tmodel.lanes, tmodel.max_actions)
    j_s, j_v = jmodel.expand(jnp.asarray(rows))
    t_s, t_v = tmodel.expand(torch.from_numpy(rows.astype(np.int64)))
    np.testing.assert_array_equal(t_s.numpy(), np.asarray(j_s).astype(np.int64))
    np.testing.assert_array_equal(t_v.numpy(), np.asarray(j_v))
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
            np.asarray(jp.condition(jmodel, jnp.asarray(rows))),
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


def test_symmetry_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="A7"):
        tm.TensorTwoPhaseSys(3, symmetry=True)
