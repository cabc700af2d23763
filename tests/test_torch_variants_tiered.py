"""The XLA insert designs on the tiered store, held against the JAX package
(CPU): the step helpers the design path adds (`compact_flags`, `count_add`,
`count_ge`, the design's insert-then-probe), the store's sweep over a
design's table, resident tiered 2pc-4 and frontier tiered 2pc-3 (the
configs of the JAX package's tests/test_tiered_store.py:160 and :204) for
each split design and, resident, each append (the checkpoints are in
tests/test_torch_variants_donate.py). A design is deterministic, so every run
equals the JAX run on the same variant counter for counter: counts,
discoveries, the store's counters, the sweep hand, the Bloom summary word
for word, the spill tier as a set of (key, parent), and the table slot for
slot. Inputs are made from a seed with numpy; every comparison is exact."""

import numpy as np
import pytest
import torch

from stateright_tpu.store import tiered as jtiered
from stateright_tpu.tensor import frontier as jfrontier
from stateright_tpu.tensor import hashtable as jhashtable
from stateright_tpu.tensor import models as jm
from stateright_tpu.tensor.frontier import FrontierSearch as JaxFrontier
from stateright_tpu.tensor.inserts import INSERT_TABLE as JAX_INSERTS
from stateright_tpu.tensor.resident import ResidentSearch as JaxResident
from stateright_tpu_torch.store.tiered import TieredConfig, TieredStore
from stateright_tpu_torch.tensor import frontier as pfrontier
from stateright_tpu_torch.tensor import models as pm
from stateright_tpu_torch.tensor.frontier import FrontierSearch
from stateright_tpu_torch.tensor.inserts import resolve_insert
from stateright_tpu_torch.tensor.pallas_hashtable import from_jax_table, to_jax_table
from stateright_tpu_torch.tensor.resident import ResidentSearch

DESIGNS = ["sort", "phased", "capped", "capped-phased"]
GOLD_2PC3 = (1146, 288)
GOLD_2PC4 = (8258, 1568)
# The JAX package's tests/test_tiered_store.py:204 (resident 2pc-4) and :160
# (frontier 2pc-3).
RESIDENT_TIERED = dict(store="tiered", high_water=0.6, summary_log2=14)
FRONTIER_TIERED = dict(store="tiered", high_water=0.5, summary_log2=12)
STORE_KEYS = ("spilled_states", "spill_events", "suspects_checked", "suspects_dup")


def _u32(rng, n):
    return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)


# -- the step helpers ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_flags_equals_jax(seed):
    rng = np.random.default_rng(seed)
    n = 257
    is_new, flags = rng.random(n) < 0.4, rng.random(n) < 0.3
    want = np.asarray(jfrontier.compact_flags(flags, is_new))
    got = pfrontier.compact_flags(torch.from_numpy(flags), torch.from_numpy(is_new))
    np.testing.assert_array_equal(got.numpy(), want)
    # Flag i annotates compacted row i, as compact_new orders the rows.
    rows = torch.arange(n)
    (order,) = pfrontier.compact_new(torch.from_numpy(is_new), rows)
    k = int(is_new.sum())
    np.testing.assert_array_equal(got.numpy()[:k], flags[order[:k].numpy()])


@pytest.mark.parametrize("seed", [0, 1])
def test_count_add_and_count_ge_equal_jax_across_the_carry(seed):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    n = 512
    lo, hi, x = _u32(rng, n), _u32(rng, n), _u32(rng, n)
    lo[:64] = 0xFFFFFFFF - x[:64] // 2  # a low word that wraps: the carry crosses 2^32
    hi[:8] = 0xFFFFFFFF  # and a high word that wraps too
    jlo, jhi = jfrontier.count_add(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(x))
    t = [torch.from_numpy(a.astype(np.int64)) for a in (lo, hi, x)]
    plo, phi = pfrontier.count_add(*t)
    np.testing.assert_array_equal(plo.numpy(), np.asarray(jlo).astype(np.int64))
    np.testing.assert_array_equal(phi.numpy(), np.asarray(jhi).astype(np.int64))
    assert (phi.numpy()[:64] != hi[:64].astype(np.int64)).any()  # some carries landed
    tlo, thi = _u32(rng, n), hi.copy()
    thi[::2] = _u32(rng, n // 2)
    want = np.asarray(jfrontier.count_ge(*(jnp.asarray(a) for a in (lo, hi, tlo, thi))))
    got = pfrontier.count_ge(*(torch.from_numpy(a.astype(np.int64))
                               for a in (lo, hi, tlo, thi)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("variant", DESIGNS)
def test_design_insert_then_probe_equals_jax_expand_insert(variant):
    """A design's step core with a summary: the plain insert, then the
    probe of the new keys (JAX frontier.py:155-166), salted keys and all."""
    import jax.numpy as jnp

    from stateright_tpu.store.summary import host_insert
    from stateright_tpu.tensor.fingerprint import salt_fp

    rng = np.random.default_rng(7)
    K = 64
    jmodel, pmodel = jm.TensorTwoPhaseSys(3), pm.TensorTwoPhaseSys(3)
    reach = ResidentSearch(pmodel, 64, 12, device="cpu")
    reach.run()
    states = reach.dump_states(raw=True)
    states = states[rng.choice(len(states), K, replace=False)]
    slog2, k = 12, 4
    summary = np.zeros(1 << (slog2 - 5), np.uint32)
    spilled = _u32(rng, 300) | 1
    host_insert(summary, spilled, _u32(rng, 300), slog2, k)
    # Spill the successors of a quarter of the batch, so that suspects appear.
    succ, _ = jmodel.expand(jnp.asarray(states[:K // 4]))
    slo, shi = (np.asarray(a) for a in jfrontier.state_fingerprint(
        jmodel, succ.reshape(-1, jmodel.lanes)))
    salt_lo, salt_hi = np.full(K, 0x1234, np.uint32), np.full(K, 0x9, np.uint32)
    tlo, thi = (np.asarray(a) for a in salt_fp(slo, shi, salt_lo[0], salt_hi[0]))
    host_insert(summary, tlo, thi, slog2, k)

    S = 1 << 10
    z = jnp.zeros(S, jnp.uint32)
    lo, hi = (np.asarray(a) for a in jfrontier.state_fingerprint(jmodel, jnp.asarray(states)))
    out = jfrontier.expand_insert(
        jmodel, z, z, z, z, jnp.asarray(states), jnp.asarray(lo), jnp.asarray(hi),
        jnp.ones(K, bool), insert=JAX_INSERTS[variant], salt_lo=jnp.asarray(salt_lo),
        salt_hi=jnp.asarray(salt_hi), summary=jnp.asarray(summary), summary_cfg=(slog2, k))
    j_tables, j_new, j_sus = [np.asarray(a) for a in out[:4]], out[7], out[8]

    t_key = torch.zeros(S, dtype=torch.int64)
    t_par = torch.zeros(S, dtype=torch.int64)
    keys = (torch.from_numpy(hi.astype(np.int64)) << 32) | torch.from_numpy(lo.astype(np.int64))
    salts = torch.full((K,), (0x9 << 32) | 0x1234, dtype=torch.int64)
    insert = resolve_insert(variant, summary_cfg=(slog2, k))
    _, _, is_new, sus, _, _, _ = pfrontier.expand_insert(
        pmodel, insert, t_key, t_par, torch.from_numpy(states.astype(np.int64)), keys,
        torch.ones(K, dtype=torch.bool), summary=torch.from_numpy(summary.view(np.int32)),
        summary_cfg=(slog2, k), salts=salts)
    np.testing.assert_array_equal(is_new.numpy(), np.asarray(j_new))
    np.testing.assert_array_equal(sus.numpy(), np.asarray(j_sus))
    assert sus.any() and (is_new & ~sus).any()
    for ours, theirs in zip(to_jax_table(t_key, t_par), j_tables):
        np.testing.assert_array_equal(ours, theirs)


# -- the store's sweep over a design's table -------------------------------------------


def test_design_table_eviction_equals_jax_evict_host():
    """A 2^10-slot "sort" table filled by the JAX design, swept by both
    stores from the same hand: the same slots freed, the same spill tier,
    the same summary words and the same hand; full buckets untouched."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    S = 1 << 10
    n = 700
    lo, hi = _u32(rng, n) | 1, _u32(rng, n)
    hi[:200] = 3  # 200 keys homed on bucket 3: it fills and overflows into 4
    z = jnp.zeros(S, jnp.uint32)
    tl, th, pl, ph, _, ovf = jhashtable._insert_impl(
        z, z, z, z, jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(_u32(rng, n)),
        jnp.asarray(_u32(rng, n)), jnp.ones(n, bool))
    assert not bool(ovf)
    tables = [np.asarray(a).copy() for a in (tl, th, pl, ph)]
    cfg = dict(high_water=0.6, low_water=0.3, summary_log2=14)
    js = jtiered.TieredStore(S, jtiered.TieredConfig(**cfg), background=False)
    js.sweep = 5
    j_freed = js.evict_host(*tables, hot_claims=n)
    ps = TieredStore(S, TieredConfig(**cfg), background=False, device="cpu",
                     insert_variant="sort")
    ps.sweep = 5
    t_key, t_par = from_jax_table(tl, th, pl, ph)
    p_freed = ps.evict_host(t_key.numpy(), t_par.numpy(), hot_claims=n)
    assert p_freed == j_freed > 0 and not ps.partitioned and ps.bucket == 128
    assert ps.sweep == js.sweep and ps.spill_events == js.spill_events == 1
    for ours, theirs in zip(to_jax_table(t_key, t_par), tables):
        np.testing.assert_array_equal(ours, theirs)
    assert (tables[0].reshape(-1, 128)[3] != 0).all()  # the full bucket stays
    for ours, theirs in zip(ps.store.to_arrays(), js.store.to_arrays()):
        np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ps.summary.numpy().view(np.uint32), js.summary_np)
    assert ps.partition_spills == 0 and not ps.at_risk(t_key)


# -- the engines --------------------------------------------------------------------------


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


def _assert_result(r, jr, gold):
    assert (r.state_count, r.unique_state_count) == gold and r.complete
    assert (r.state_count, r.unique_state_count, r.max_depth, r.discoveries) == (
        jr.state_count, jr.unique_state_count, jr.max_depth, jr.discoveries)


@pytest.mark.parametrize("append", ["scatter", "dus"])
@pytest.mark.parametrize("variant", DESIGNS)
def test_resident_tiered_2pc4_equals_jax(variant, append):
    jrs = JaxResident(jm.TensorTwoPhaseSys(4), 32, 11, insert_variant=variant, append=append,
                      **RESIDENT_TIERED)
    jr = jrs.run()
    rs = ResidentSearch(pm.TensorTwoPhaseSys(4), 32, 11, insert_variant=variant,
                        append=append, device="cpu", **RESIDENT_TIERED)
    r = rs.run()
    _assert_result(r, jr, GOLD_2PC4)
    assert rs.store_stats()["spill_events"] >= 1
    _assert_same_store(rs, jrs)
    _assert_table(rs._c["t_key"], rs._c["t_parent"], jrs._last_tables)
    fp = r.discoveries["commit agreement"]
    assert rs.reconstruct_path(fp).into_pairs() == jrs.reconstruct_path(fp).into_pairs()


@pytest.mark.parametrize("variant", DESIGNS)
def test_frontier_tiered_2pc3_equals_jax(variant):
    jfs = JaxFrontier(jm.TensorTwoPhaseSys(3), 16, 9, insert_variant=variant,
                      **FRONTIER_TIERED)
    jr = jfs.run()
    fs = FrontierSearch(pm.TensorTwoPhaseSys(3), 16, 9, insert_variant=variant, device="cpu",
                        **FRONTIER_TIERED)
    r = fs.run()
    _assert_result(r, jr, GOLD_2PC3)
    assert fs.store_stats()["spill_events"] >= 1
    _assert_same_store(fs, jfs)
    t = jfs.table
    _assert_table(fs.table.t_key, fs.table.t_parent, (t.t_lo, t.t_hi, t.p_lo, t.p_hi))
    fp = r.discoveries["commit agreement"]
    assert fs.reconstruct_path(fp).into_pairs() == jfs.reconstruct_path(fp).into_pairs()

