"""The port's cost model ranks the insert designs and predicts walk rates as
the JAX module does (`stateright_tpu/tensor/costmodel.py`:
`pallas_partition_count`, `sim_walks_per_sec`, `predict_ranking`), priced
for the port's step on the H100; and `TensorModel.format_step` answers None
as the JAX base class does."""

import pytest

from stateright_tpu.tensor import costmodel as jcm
from stateright_tpu.tensor import pallas_hashtable as jph
from stateright_tpu_torch.tensor import costmodel as cm
from stateright_tpu_torch.tensor import pallas_hashtable as ph

#: A paxos-3 step at the north star's width (21 lanes, 14 actions, batch
#: 8192, 2^22 slots), the anchor of the JAX module's tests.
ANCHOR = dict(lanes=21, max_actions=14, batch=8192, table_log2=22)


@pytest.mark.parametrize("log2", range(7, 29))
def test_partition_count_equals_the_kernels(log2):
    slots = 1 << log2
    assert cm.pallas_partition_count(slots) == ph.partitions(slots)
    if log2 >= 10:  # the JAX kernel takes 2^10 slots or more
        assert cm.pallas_partition_count(slots) == jcm.pallas_partition_count(slots)
        assert cm.pallas_partition_count(slots) == jph.pallas_partitions(slots)


def test_partition_mirror_constants_pin_the_kernels():
    assert cm.PALLAS_ROW_ALIGN == ph.PARTITION_ALIGN == jcm.PALLAS_ROW_ALIGN
    assert cm.PALLAS_DEFAULT_PARTITIONS == ph.DEFAULT_PARTITIONS
    assert cm.PALLAS_DEFAULT_PARTITIONS == jcm.PALLAS_DEFAULT_PARTITIONS


@pytest.mark.parametrize("spill", [None, {"summary_hashes": 4, "evict_per_step": 1000.0}],
                         ids=["device", "tiered"])
@pytest.mark.parametrize("new_frac", [0.35, 0.5])
def test_ranking_is_sorted_and_agrees_with_step_cost(new_frac, spill):
    r = cm.predict_ranking(**ANCHOR, new_frac=new_frac, spill=spill)
    assert {x["variant"] for x in r} == set(cm.INSERT_VARIANTS)
    assert [x["total_ms"] for x in r] == sorted(x["total_ms"] for x in r)
    # The JAX module's record format, key for key.
    j = jcm.predict_ranking(**ANCHOR, new_frac=new_frac)
    assert all(set(x) == set(j[0]) for x in r)
    for x in r:
        sc = cm.step_cost(**ANCHOR, variant=x["variant"], new_frac=new_frac, spill=spill)
        assert x["total_ms"] == round(sc.total_ms, 3)
        assert x["insert_ms"] == round(
            sum(o.ms for o in sc.ops if o.name.startswith("insert_")), 3)
        assert x["bytes"] == int(sc.total_bytes)
        assert x["insert_ms"] <= x["total_ms"]


def test_ranking_defaults_to_the_h100_and_takes_a_subset():
    assert cm.predict_ranking(**ANCHOR) == cm.predict_ranking(**ANCHOR, device=cm.H100)
    assert cm.predict_ranking(**ANCHOR) != cm.predict_ranking(**ANCHOR, device=cm.CPU1)
    sub = cm.predict_ranking(**ANCHOR, variants=("capped", "pallas"))
    assert [x["variant"] for x in sub] == ["pallas", "capped"]


def test_sim_walks_per_sec_is_the_jax_formula_and_monotone():
    # Every lane completes a walk every mean_walk_len steps: traces /
    # (mean_walk_len x step time), as in the JAX module.
    for traces, dedup in ((4096, "trace"), (8192, "shared")):
        sc = cm.sim_step_cost(21, 14, traces, dedup=dedup)
        assert cm.sim_walks_per_sec(21, 14, traces, 40.0, dedup=dedup) == pytest.approx(
            traces / (40.0 * sc.total_ms * 1e-3))
    # The port's device terms are linear in the lanes, so walks/s never
    # falls with more lanes; the counted launches, a cost a step whatever
    # its width, make it grow (JAX tests/test_costmodel.py:226).
    assert cm.sim_walks_per_sec(21, 14, 8192, 40.0) >= cm.sim_walks_per_sec(
        21, 14, 4096, 40.0)
    assert cm.sim_walks_per_sec(21, 14, 8192, 40.0, launches=300.0) > cm.sim_walks_per_sec(
        21, 14, 4096, 40.0, launches=300.0)
    # Longer walks complete fewer a second; a walk is at least one step.
    assert cm.sim_walks_per_sec(21, 14, 4096, 80.0) < cm.sim_walks_per_sec(21, 14, 4096, 40.0)
    assert cm.sim_walks_per_sec(21, 14, 4096, 0.5) == cm.sim_walks_per_sec(21, 14, 4096, 1.0)
    with pytest.raises(ValueError):
        cm.sim_walks_per_sec(21, 14, 4096, 40.0, dedup="global")


def test_format_step_answers_none_as_in_jax():
    from stateright_tpu.tensor.models import TensorTwoPhaseSys as JaxTwoPhase
    from stateright_tpu_torch.tensor.models import TensorTwoPhaseSys

    m, jm = TensorTwoPhaseSys(3), JaxTwoPhase(3)
    row = tuple(int(x) for x in m.init_states()[0])
    assert m.format_step(row, 0) is None
    assert jm.format_step(row, 0) is None
