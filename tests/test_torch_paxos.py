"""The port's Paxos (stateright_tpu_torch/tensor/paxos.py) against the JAX
package's TensorPaxos: the vocabulary and linearizability tables, `expand`
and every property mask on every reachable paxos-2 state and on random
rows, and the pool-overflow poison row. Whole searches are in
test_torch_paxos_search.py. Integers and bits: the tolerance is 0."""

import numpy as np
import pytest

from stateright_tpu.tensor.paxos import TensorPaxos as JaxPaxos
from stateright_tpu_torch.tensor import TensorPaxos
from test_torch_models import _assert_same, one_torch_thread, reachable  # noqa: F401 (autouse)

TABLES = ("_TYP", "_DST", "_BAL", "_PROP", "_LA", "_SRC", "_VAL", "_PACKED",
          "_lin_phase", "_lin_ret", "_lin_maxf")


@pytest.mark.parametrize("clients", [1, 2, 3])
def test_vocabulary_and_tables_equal_jax(clients):
    j, t = JaxPaxos(clients), TensorPaxos(clients)
    assert (t.V, t.lanes, t.max_actions, t._field_off) == (
        j.V, j.lanes, j.max_actions, j._field_off
    )
    for name in TABLES:
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)
    np.testing.assert_array_equal(t.init_states().numpy(), np.asarray(j.init_states()))


@pytest.mark.parametrize("clients,server_count", [(4, 3), (2, 5)])
def test_unsupported_configurations_raise(clients, server_count):
    with pytest.raises(ValueError, match="supports"):
        TensorPaxos(clients, server_count=server_count)


@pytest.fixture(scope="module")
def paxos2_rows():
    rows = reachable(TensorPaxos(2), 2048, 16)
    assert len(rows) == 16_668
    return rows


def test_paxos2_every_reachable_state(paxos2_rows):
    """expand on every valid slot, the valid masks and all three property
    masks equal the JAX model's on all 16,668 reachable states."""
    _assert_same(JaxPaxos(2), TensorPaxos(2), paxos2_rows, valid_only=True)


@pytest.mark.parametrize("clients", [3])
def test_random_rows_valid_slots(clients):
    # Rows no search reaches (garbage server fields, random pools): the
    # uint32 arithmetic must still agree wherever a slot is valid.
    rng = np.random.default_rng(clients)
    m = TensorPaxos(clients)
    B = 2048
    srv = rng.integers(0, 1 << 12, (B, 6))
    srv[: B // 4] = rng.integers(0, 1 << 32, (B // 4, 6))
    pool = np.where(rng.random((B, m.pool_size)) < 0.5,
                    rng.integers(0, m.V, (B, m.pool_size)), 0xFFFFFFFF)
    pool.sort(axis=1)
    rows = np.concatenate([srv, rng.integers(0, 1 << 24, (B, 1)), pool], axis=1)
    _assert_same(JaxPaxos(clients), m, rows.astype(np.uint32), valid_only=True)


def test_pool_overflow_becomes_the_poison_row():
    """A pool too small for the protocol: the successor that would
    overflow becomes the all-EMPTY row, "pool capacity" reports it, and
    the search equals the JAX engine's."""
    p = TensorPaxos(1, pool_size=3).checker().spawn_cuda(
        batch_size=256, table_log2=12, device="cpu"
    ).join()
    j = JaxPaxos(1, pool_size=3).checker().spawn_tpu(batch_size=256, table_log2=12).join()
    assert (p.state_count(), p.unique_state_count()) == (j.state_count(), j.unique_state_count())
    assert p.result().discoveries == j._result.discoveries
    path = p.discoveries()["pool capacity"]
    assert path.last_state()["network"] == []  # the poison row decodes empty
    p.assert_discovery("pool capacity", path.actions())
