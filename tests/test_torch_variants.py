"""The XLA insert designs, the kv layout and the append on the port's two
single-card search engines, held against the JAX package's engines on the
same variant (CPU): `ResidentSearch` for every (table_layout,
insert_variant) and for each append, and `FrontierSearch` for every
split-layout variant, at 2pc-4 (8,258 / 1,568) here and paxos-1 (482 /
265) in tests/test_torch_variants_paxos.py. Each run equals the JAX run in
counts, max depth and discoveries, and its final table equals the JAX
table array for array. Also: the JAX package's
capped golden-parity cases (tests/test_batch_monotonicity.py) and append
cases (tests/test_donate_chunks.py, the append half), the port's "scatter"
default pinned against the JAX package's platform default, the kv layout's
refusal with the tiered store (the JAX engine's too), and the registry
probe. The designs on the tiered store and the other engines are in
tests/test_torch_variants_tiered.py and tests/test_torch_variants_engines.py."""

import numpy as np
import pytest
import torch

from stateright_tpu.tensor import frontier as jfrontier
from stateright_tpu.tensor import models as jm
from stateright_tpu.tensor.frontier import FrontierSearch as JaxFrontier
from stateright_tpu.tensor.paxos import TensorPaxos as JaxPaxos
from stateright_tpu.tensor.resident import ResidentSearch as JaxResident
from stateright_tpu_torch import knobs
from stateright_tpu_torch.tensor import models as pm
from stateright_tpu_torch.tensor.frontier import (
    FrontierSearch,
    append_new,
    append_new_dus,
    resolve_append,
)
from stateright_tpu_torch.tensor.hashtable import to_jax_kv
from stateright_tpu_torch.tensor.pallas_hashtable import to_jax_table
from stateright_tpu_torch.tensor.paxos import TensorPaxos
from stateright_tpu_torch.tensor.resident import ResidentSearch

MODELS = {
    # name: (JAX model, port model, batch, table_log2, golden)
    "2pc-4": (lambda: jm.TensorTwoPhaseSys(4), lambda: pm.TensorTwoPhaseSys(4), 256, 14,
              (8258, 1568)),
    "paxos-1": (lambda: JaxPaxos(1), lambda: TensorPaxos(1), 256, 12, (482, 265)),
}
RESIDENT = [("split", "sort"), ("split", "phased"), ("split", "capped"),
            ("split", "capped-phased"), ("kv", "sort"), ("kv", "capped")]
FRONTIER = ["sort", "phased", "capped", "capped-phased"]


def _same_run(ours, theirs, golden):
    assert (ours.state_count, ours.unique_state_count) == golden
    assert (ours.state_count, ours.unique_state_count, ours.max_depth, ours.complete) == (
        theirs.state_count, theirs.unique_state_count, theirs.max_depth, theirs.complete)
    assert ours.discoveries == theirs.discoveries


def _port_arrays(t_key, t_parent, layout):
    if layout == "kv":
        t_kv, p_lo, p_hi = to_jax_kv(t_key, t_parent)
        return t_kv, p_lo, p_hi
    return to_jax_table(t_key, t_parent)


def check_resident(model, layout, variant):
    jmodel, pmodel, K, T, golden = MODELS[model]
    jax_rs = JaxResident(jmodel(), K, T, insert_variant=variant, table_layout=layout,
                         append="scatter")
    theirs = jax_rs.run()
    rs = ResidentSearch(pmodel(), K, T, insert_variant=variant, table_layout=layout,
                        device="cpu")
    _same_run(rs.run(), theirs, golden)
    jt = [np.asarray(a) for a in jax_rs._last_tables]
    if layout == "kv":
        jt = [jt[0], jt[2], jt[3]]  # t_kv, (placeholder), p_lo, p_hi
    for ours, t in zip(_port_arrays(rs._c["t_key"], rs._c["t_parent"], layout), jt):
        np.testing.assert_array_equal(ours, t)
    assert rs.build_parent_map() == jax_rs.build_parent_map()
    for fp in theirs.discoveries.values():
        assert rs.reconstruct_path(fp).into_pairs() == jax_rs.reconstruct_path(fp).into_pairs()


def check_frontier(model, variant):
    jmodel, pmodel, K, T, golden = MODELS[model]
    jfs = JaxFrontier(jmodel(), K, T, insert_variant=variant)
    theirs = jfs.run()
    fs = FrontierSearch(pmodel(), K, T, insert_variant=variant, device="cpu")
    _same_run(fs.run(), theirs, golden)
    jt = (jfs.table.t_lo, jfs.table.t_hi, jfs.table.p_lo, jfs.table.p_hi)
    for ours, t in zip(to_jax_table(fs.table.t_key, fs.table.t_parent), jt):
        np.testing.assert_array_equal(ours, np.asarray(t))
    for fp in theirs.discoveries.values():
        assert fs.reconstruct_path(fp).into_pairs() == jfs.reconstruct_path(fp).into_pairs()


@pytest.mark.parametrize("layout,variant", RESIDENT)
def test_resident_equals_the_jax_engine_and_its_table(layout, variant):
    check_resident("2pc-4", layout, variant)


@pytest.mark.parametrize("variant", FRONTIER)
def test_frontier_equals_the_jax_engine_and_its_table(variant):
    check_frontier("2pc-4", variant)


# -- the JAX package's capped and append cases -------------------------------------


@pytest.mark.parametrize("layout,variant", [("split", "capped"), ("kv", "capped"),
                                            ("split", "capped-phased")])
def test_capped_variants_golden_parity_2pc4(layout, variant):
    # tests/test_batch_monotonicity.py's parity cases (its CPU speed
    # assertions are the JAX package's own and are not ported).
    r = ResidentSearch(pm.TensorTwoPhaseSys(4), batch_size=512, table_log2=14,
                       table_layout=layout, insert_variant=variant, device="cpu").run()
    assert (r.state_count, r.unique_state_count) == (8258, 1568) and r.complete
    f = FrontierSearch(pm.TensorTwoPhaseSys(4), batch_size=512, table_log2=14,
                       insert_variant="capped", device="cpu").run()
    assert (f.state_count, f.unique_state_count) == (8258, 1568) and f.complete


def test_append_variants_agree():
    # tests/test_donate_chunks.py::test_append_variants_agree: rows [0, tail)
    # after any sequence of appends are the same for both appends.
    Q, L, M = 64, 3, 8

    def run(append, rng):
        queue = (torch.zeros((Q, L), dtype=torch.int64), torch.zeros(Q, dtype=torch.int64),
                 torch.zeros(Q, dtype=torch.int64), torch.zeros(Q, dtype=torch.int64))
        tail = torch.zeros((), dtype=torch.int64)
        for _ in range(4):
            rows = (torch.from_numpy(rng.integers(1, 99, (M, L))),
                    torch.from_numpy(rng.integers(1, 99, M)), torch.zeros(M, dtype=torch.int64),
                    torch.ones(M, dtype=torch.int64))
            tail = append(queue, tail, rows, torch.from_numpy(rng.random(M) < 0.5))
        return [q[:int(tail)] for q in queue], int(tail)

    a, ta = run(append_new, np.random.default_rng(3))
    b, tb = run(append_new_dus, np.random.default_rng(3))
    assert ta == tb > 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_append_variants_identical_results():
    # tests/test_donate_chunks.py::test_append_variants_identical_results,
    # held against the JAX engine's "dus" run.
    theirs = JaxResident(jm.TensorTwoPhaseSys(4), 256, 14, append="dus").run()
    for append in ("scatter", "dus"):
        rs = ResidentSearch(pm.TensorTwoPhaseSys(4), 256, 14, append=append,
                            insert_variant="sort", device="cpu")
        assert rs.append == append
        _same_run(rs.run(), theirs, (8258, 1568))
    rs = ResidentSearch(pm.TensorTwoPhaseSys(4), 256, 14, append="dus", device="cpu")
    _same_run(rs.run(), theirs, (8258, 1568))


def test_append_default_is_scatter_on_every_device():
    # A deliberate difference (ROADMAP §C): the JAX package defaults to
    # "dus" off the CPU, for the TPU's column-major queue; the port keeps
    # "scatter", the append the card has measured, on every device.
    assert jfrontier.resolve_append(None, "cpu") == "scatter"
    assert jfrontier.resolve_append(None, "gpu") == "dus"
    for device in ("cpu", "cuda", None):
        assert resolve_append(None, device) == "scatter"
    assert ResidentSearch(pm.TensorTwoPhaseSys(3), 64, 12, device="cpu").append == "scatter"
    with pytest.raises(ValueError):
        resolve_append("dynamic")


# -- the knobs ----------------------------------------------------------------------


def test_tiered_store_refuses_the_kv_layout():
    # The JAX engine refuses kv with the tiered store too: the store sweeps
    # a split table's buckets.
    with pytest.raises(ValueError, match="split"):
        JaxResident(jm.TensorTwoPhaseSys(3), 64, 12, table_layout="kv", store="tiered")
    with pytest.raises(ValueError, match="split"):
        ResidentSearch(pm.TensorTwoPhaseSys(3), 64, 12, table_layout="kv", store="tiered",
                       device="cpu")


@pytest.mark.parametrize("kw", [dict(insert_variant="phased", table_layout="kv"),
                                dict(insert_variant="capped-phased", table_layout="kv"),
                                dict(insert_variant="pallas", table_layout="kv"),
                                dict(insert_variant="radix"), dict(table_layout="rows"),
                                dict(append="dynamic")])
def test_resident_refuses_what_the_jax_engine_refuses(kw):
    with pytest.raises(ValueError):
        JaxResident(jm.TensorTwoPhaseSys(3), 64, 12, **kw)
    with pytest.raises(ValueError):
        ResidentSearch(pm.TensorTwoPhaseSys(3), 64, 12, device="cpu", **kw)


def test_spawn_cuda_passes_the_knobs_through():
    c = pm.TensorTwoPhaseSys(3).checker().spawn_cuda(
        batch_size=64, table_log2=12, insert_variant="capped", table_layout="kv",
        append="dus", device="cpu").join()
    assert (c.state_count(), c.unique_state_count()) == (1146, 288)
    eng = c._search
    assert (eng.insert_variant, eng.table_layout, eng.append) == ("capped", "kv", "dus")
    f = pm.TensorTwoPhaseSys(3).checker().spawn_cuda(
        batch_size=64, table_log2=12, resident=False, insert_variant="phased",
        device="cpu").join()
    assert (f.state_count(), f.unique_state_count()) == (1146, 288)
    assert f._search.insert_variant == "phased"


def test_registry_matches_the_jax_package():
    from stateright_tpu import knobs as jknobs
    from stateright_tpu_torch.tensor import costmodel, inserts

    for name in ("INSERT_VARIANTS", "PHASED_VARIANTS", "TABLE_LAYOUTS", "APPEND_KINDS",
                 "COST_VARIANTS"):
        assert getattr(knobs, name) == getattr(jknobs, name)
    assert knobs.check_registry() == []
    assert list(inserts.INSERT_TABLE) == list(knobs.INSERT_VARIANTS)
    assert FrontierSearch.INSERT_VARIANTS is inserts.INSERT_TABLE
    assert costmodel.INSERT_VARIANTS is knobs.COST_VARIANTS
    for (layout, variant), cost in costmodel.ENGINE_VARIANTS.items():
        est = costmodel.step_cost(21, 14, 8192, 22, variant=cost)
        assert est.total_ms > 0
