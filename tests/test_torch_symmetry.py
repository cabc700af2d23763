"""The port's symmetry reduction (stateright_tpu_torch/tensor/symmetry.py
and the symmetric models) against the JAX package's: the helpers, every
symmetric model's `representative` on random rows, the reduced goldens
through the port engine, and a symmetric witness equal to the JAX
engine's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.tensor import models as jm
from stateright_tpu.tensor import symmetry as js
from stateright_tpu_torch.tensor import models as tm
from stateright_tpu_torch.tensor import symmetry as ts
from stateright_tpu_torch.tensor.paxos import TensorPaxos
from stateright_tpu_torch.tensor.resident import ResidentSearch
from test_torch_models import one_torch_thread  # noqa: F401 (autouse)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_symmetry_helpers_equal_jax():
    # The cases of the JAX package's test_symmetry_helpers.
    keys = np.array([[3, 1, 2], [2, 2, 1]], dtype=np.uint32)
    perm = ts.stable_argsort(_t(keys))
    np.testing.assert_array_equal(perm.numpy(), [[1, 2, 0], [2, 0, 1]])
    np.testing.assert_array_equal(perm.numpy(), np.asarray(js.stable_argsort(jnp.asarray(keys))))
    lanes = np.array([[30, 10, 20], [20, 21, 10]], dtype=np.uint32)
    got = ts.gather_entities(_t(lanes), perm)
    np.testing.assert_array_equal(got.numpy(), [[10, 20, 30], [10, 20, 21]])
    mask = np.array([0b001, 0b011], dtype=np.uint32)
    out = ts.permute_mask_bits(_t(mask), perm)
    np.testing.assert_array_equal(out.numpy(), [0b100, 0b110])
    jperm = js.stable_argsort(jnp.asarray(keys))
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(js.permute_mask_bits(jnp.asarray(mask), jperm))
    )


def _rows_2pc(rng, n, B=2048):
    return np.concatenate(
        [rng.integers(0, 4, (B, n)), rng.integers(0, 3, (B, 1)),
         rng.integers(0, 1 << n, (B, 1)), rng.integers(0, 1 << (n + 2), (B, 1))],
        axis=1,
    ).astype(np.uint32)


def _rows_pairs(rng, head, n, B=2048):
    pairs = np.stack([rng.integers(0, 4, (B, n)), rng.integers(0, 5, (B, n))], axis=2)
    return np.concatenate([rng.integers(0, 4, (B, head)), pairs.reshape(B, 2 * n)],
                          axis=1).astype(np.uint32)


CASES = (
    [(f"2pc{n}-{s}", lambda mod, n=n, s=s: mod.TensorTwoPhaseSys(n, symmetry=s),
      lambda rng, n=n: _rows_2pc(rng, n)) for n in (3, 5, 7) for s in (True, "value")]
    + [(f"increment{n}", lambda mod, n=n: mod.TensorIncrement(n, symmetry=True),
        lambda rng, n=n: _rows_pairs(rng, 1, n)) for n in (2, 3, 5)]
    + [(f"increment-lock{n}", lambda mod, n=n: mod.TensorIncrementLock(n, symmetry=True),
        lambda rng, n=n: _rows_pairs(rng, 2, n)) for n in (2, 3, 6)]
)


@pytest.mark.parametrize("make,rows", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_representative_equals_jax_and_is_idempotent(make, rows):
    jmodel, tmodel = make(jm), make(tm)
    x = rows(np.random.default_rng(tmodel.lanes))
    rep = tmodel.representative(_t(x))
    np.testing.assert_array_equal(
        rep.numpy(), np.asarray(jmodel.representative(jnp.asarray(x))).astype(np.int64)
    )
    np.testing.assert_array_equal(tmodel.representative(rep).numpy(), rep.numpy())


def test_2pc_representative_is_orbit_stable():
    m = tm.TensorTwoPhaseSys(3, symmetry=True)
    # Two states in one orbit: RM states permuted with their prepared and
    # message bits.
    a = m.representative(_t([[1, 0, 2, 0, 0b001, 0b001]]))
    b = m.representative(_t([[0, 2, 1, 0, 0b100, 0b100]]))
    assert torch.equal(a, b)


def test_symmetry_off_keeps_the_identity_hook():
    assert tm.TensorTwoPhaseSys(3).representative is None
    assert TensorPaxos(1).representative is None


@pytest.fixture(scope="module")
def tpc5():
    full = ResidentSearch(tm.TensorTwoPhaseSys(5), 2048, 16, device="cpu").run()
    sym = ResidentSearch(tm.TensorTwoPhaseSys(5, symmetry=True), 1024, 16, device="cpu").run()
    return full, sym


def test_2pc5_symmetric_golden_with_the_unreduced_verdicts(tpc5):
    full, sym = tpc5
    assert full.unique_state_count == 8832
    assert sym.unique_state_count == 314
    assert sym.complete
    # Reduction changes which orbit member is stored, never the verdicts.
    assert set(full.discoveries) == set(sym.discoveries) == {
        "abort agreement", "commit agreement"
    }


def test_2pc5_value_sort_in_the_engine_keeps_the_verdicts(tpc5):
    # Value-sort has no golden in a batched BFS (symmetry.py COUNT
    # CONTRACT): only its verdicts are held.
    full, _ = tpc5
    r = ResidentSearch(tm.TensorTwoPhaseSys(5, symmetry="value"), 1024, 16, device="cpu").run()
    assert r.complete and 314 <= r.unique_state_count < 8832
    assert set(r.discoveries) == set(full.discoveries)


def test_device_dfs_reproduces_the_reference_value_sort_golden():
    assert ts.device_dfs_unique_count(tm.TensorTwoPhaseSys(5, symmetry="value")) == 665
    assert ts.device_dfs_unique_count(tm.TensorTwoPhaseSys(5, symmetry=True)) == 314


def test_2pc7_symmetric_golden():
    r = ResidentSearch(tm.TensorTwoPhaseSys(7, symmetry=True), 2048, 16, device="cpu").run()
    assert r.unique_state_count == 920
    assert r.complete
    assert set(r.discoveries) == {"abort agreement", "commit agreement"}


@pytest.mark.parametrize(
    "symmetry,unique,generated", [(False, 13, 15), (True, 8, 10)], ids=["full", "sym"]
)
def test_increment2_goldens(symmetry, unique, generated):
    c = tm.TensorIncrement(2, symmetry=symmetry, full_enumeration=True).checker().spawn_cuda(
        batch_size=64, table_log2=10, device="cpu"
    ).join()
    assert (c.state_count(), c.unique_state_count()) == (generated, unique)
    # The lost-update race is found either way.
    assert "fin" in c.result().discoveries
    c.assert_discovery("fin", c.discoveries()["fin"].actions())


@pytest.mark.parametrize(
    "n,full,sym",
    # (generated, unique); None: the golden pins the unique count only.
    [(2, (17, 17), (None, 9)), (3, (61, 61), (None, 13)), (6, (7825, 7825), (40, 25))],
)
def test_increment_lock_goldens(n, full, sym):
    for symmetry, (generated, unique) in ((False, full), (True, sym)):
        r = ResidentSearch(
            tm.TensorIncrementLock(n, symmetry=symmetry), 1024, 14, device="cpu"
        ).run()
        assert r.unique_state_count == unique
        assert generated in (None, r.state_count)
        assert r.complete and not r.discoveries  # fin and mutex hold


@pytest.mark.parametrize(
    "make", [lambda mod: mod.TensorIncrement(2, symmetry=True),
             lambda mod: mod.TensorTwoPhaseSys(4, symmetry=True)],
    ids=["increment2", "2pc4"],
)
def test_symmetric_witness_paths_equal_jax(make):
    """Canonical fingerprints in the table, original states on the path:
    the port's discoveries, parent map and witnesses equal the JAX engine's
    (its Pallas insert in interpret mode: the same lowest-lane attribution)."""
    j = make(jm).checker().spawn_tpu(insert_variant="pallas", table_log2=12).join()
    p = make(tm).checker().spawn_cuda(table_log2=12, device="cpu").join()
    assert (p.state_count(), p.unique_state_count(), p.max_depth()) == (
        j.state_count(), j.unique_state_count(), j.max_depth()
    )
    assert p.result().discoveries == j._result.discoveries
    assert p._search.build_parent_map() == j._search.build_parent_map()
    for name, path in j.discoveries().items():
        assert p.discoveries()[name].into_pairs() == path.into_pairs()
        p.assert_discovery(name, path.actions())
