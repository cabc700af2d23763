"""Whole Paxos searches through the port (`spawn_cuda(device="cpu")`)
against the JAX package's engines: paxos-1 against the JAX Pallas insert in
interpret mode (counts, depth, discoveries, the parent map and the witness
path), paxos-2 against the JAX default engine (counts, depth and
discoveries). The goldens are the JAX package's (tests/test_tensor_paxos.py)."""

from stateright_tpu.tensor.paxos import TensorPaxos as JaxPaxos
from stateright_tpu_torch.tensor import TensorPaxos
from test_torch_models import one_torch_thread  # noqa: F401 (autouse)


def test_paxos1_search_equals_the_jax_pallas_engine():
    j = JaxPaxos(1).checker().spawn_tpu(insert_variant="pallas", table_log2=10).join()
    p = TensorPaxos(1).checker().spawn_cuda(table_log2=10, device="cpu").join()
    assert (p.state_count(), p.unique_state_count()) == (482, 265)
    assert (j.state_count(), j.unique_state_count()) == (482, 265)
    assert p.max_depth() == j.max_depth()
    assert p.result().discoveries == j._result.discoveries
    assert set(p.result().discoveries) == {"value chosen"}
    assert p._search.build_parent_map() == j._search.build_parent_map()
    path = j.discoveries()["value chosen"]
    assert p.discoveries()["value chosen"].into_pairs() == path.into_pairs()
    p.assert_discovery("value chosen", path.actions())
    p.assert_no_discovery("linearizable")


def test_paxos2_search_equals_the_jax_default_engine():
    j = JaxPaxos(2).checker().spawn_tpu(batch_size=2048, table_log2=16).join()
    p = TensorPaxos(2).checker().spawn_cuda(batch_size=2048, table_log2=16, device="cpu").join()
    assert (p.state_count(), p.unique_state_count()) == (32_971, 16_668)
    assert (j.state_count(), j.unique_state_count()) == (32_971, 16_668)
    assert p.max_depth() == j.max_depth()
    assert set(p.result().discoveries) == set(j._result.discoveries) == {"value chosen"}
