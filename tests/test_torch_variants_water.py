"""A design on the tiered store at the default high water mark 0.85, held
against the JAX package (CPU). A design's sweep is the reference's (no
partition pass), so at this water mark the buckets the hand has not
reached can fill into a run longer than the insert's probe rounds: the
search then aborts table-full, in both packages at the same step. Every
comparison is exact."""

import numpy as np
import pytest

from stateright_tpu.tensor import models as jm
from stateright_tpu.tensor.resident import ResidentSearch as JaxResident
from stateright_tpu_torch.tensor import models as pm
from stateright_tpu_torch.tensor.pallas_hashtable import to_jax_table
from stateright_tpu_torch.tensor.resident import ResidentSearch

STORE_KEYS = ("spilled_states", "spill_events", "suspects_checked", "suspects_dup")


def _assert_same_store(ours, theirs):
    for k in STORE_KEYS:
        assert ours.store_stats()[k] == theirs.store_stats()[k], k
    po, pt = ours._store, theirs._store
    assert po.sweep == pt.sweep
    np.testing.assert_array_equal(po.summary.numpy().view(np.uint32), pt.summary_np)
    fps, parents = po.store.to_arrays()
    jfps, jparents = pt.store.to_arrays()
    assert set(zip(fps.tolist(), parents.tolist())) == set(zip(jfps.tolist(),
                                                                jparents.tolist()))


def _assert_table(t_key, t_par, arrays):
    for ours, theirs in zip(to_jax_table(t_key, t_par), arrays):
        np.testing.assert_array_equal(ours, np.asarray(theirs))


@pytest.mark.parametrize("variant, aborts", [("phased", True), ("sort", False)])
def test_resident_tiered_2pc5_at_high_water_085_equals_jax(variant, aborts):
    """Tiered 2pc-5 in a 2^12-slot hot tier at the default high water 0.85
    (batch 32): the JAX engine and the port abort table-full at the same
    step through "phased", with the same unique count, store counters,
    sweep hand and table at the kept chunk boundary; through "sort" both
    reach the golden with the same counters. A design's sweep has no
    partition pass, so at this water mark it may run out of probe rounds,
    in both packages alike."""
    kw = dict(store="tiered", high_water=0.85, summary_log2=16, insert_variant=variant)
    jrs = JaxResident(jm.TensorTwoPhaseSys(5), 32, 12, **kw)
    rs = ResidentSearch(pm.TensorTwoPhaseSys(5), 32, 12, device="cpu", **kw)
    reasons = []
    for eng in (jrs, rs):
        try:
            r = eng.run()
        except RuntimeError as e:
            reasons.append(str(e).split(";")[0])
        else:
            assert (r.state_count, r.unique_state_count) == (58_146, 8_832) and r.complete
            reasons.append(None)
    if aborts:
        assert reasons == ["hash table or queue full — hash table full (raise table_log2)"] * 2
    else:
        assert reasons == [None, None]
    jc = jrs._carry
    assert (int(rs._c["steps"]), int(rs._c["unique"])) == (int(jc.steps), int(jc.unique_count))
    assert rs.store_stats()["spill_events"] >= 1
    _assert_same_store(rs, jrs)
    _assert_table(rs._c["t_key"], rs._c["t_parent"], (jc.t_lo, jc.t_hi, jc.p_lo, jc.p_hi))
