"""The port's tiered state store (stateright_tpu_torch/store/) and the
resident engine's tiered mode against the JAX package's
(stateright_tpu/store/, ResidentSearch(store="tiered",
insert_variant="pallas")): the spill tier, eviction slot for slot, the
insert's verdicts after an eviction, and the whole 2pc-4 search through a
2^11 hot tier — counts, discoveries, store counters and witnesses. Every
comparison is exact (tolerance 0: integers and bits)."""

import os
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.store import HostSpillStore as JaxSpill
from stateright_tpu.store import TieredConfig as JaxConfig
from stateright_tpu.store import TieredStore as JaxStore
from stateright_tpu.store.summary import maybe_contains as _jax_maybe_contains
from stateright_tpu.tensor import models as jm
from stateright_tpu.tensor.pallas_hashtable import PallasHashTable as JaxTable
from stateright_tpu.tensor.pallas_hashtable import make_engine_insert
from stateright_tpu.tensor.resident import ResidentSearch as JaxResident
from stateright_tpu_torch.store.host import HostSpillStore
from stateright_tpu_torch.store.tiered import TieredConfig, TieredStore
from stateright_tpu_torch.tensor import models as tm
from stateright_tpu_torch.tensor import pallas_hashtable as ph
from stateright_tpu_torch.tensor.fingerprint import pack_fp, to_host_fp
from stateright_tpu_torch.tensor.frontier import compact_queue, inject_rows
from stateright_tpu_torch.tensor.resident import ResidentSearch, _TableParents

GOLD_2PC4 = (8258, 1568)
PIN = dict(high_water=0.6, summary_log2=14)  # tests/test_pallas_hashtable.py:338


# -- the spill tier ------------------------------------------------------------


def _spill_batches(seed):
    rng = np.random.default_rng(seed)
    pool = rng.integers(1, 2**64, 300, dtype=np.uint64)
    for _ in range(6):
        fps = pool[rng.integers(0, pool.size, 120)]
        yield fps, rng.integers(1, 2**64, fps.size, dtype=np.uint64)


@pytest.mark.parametrize("threshold", [1, 200, 1 << 20])
def test_spill_store_equals_jax_first_writer(threshold):
    # threshold 1 compacts at every append, 1 << 20 never: parents() must
    # read pending chunks in append order as the compacted zone would.
    ours = HostSpillStore(compact_threshold=threshold, background=False)
    ref = JaxSpill(background=False)
    for fps, parents in _spill_batches(5):
        ours.append(fps, parents)
        ref.append(fps, parents)
    rng = np.random.default_rng(6)
    probe = np.concatenate([next(_spill_batches(5))[0],
                            rng.integers(1, 2**64, 50, dtype=np.uint64)])
    want_map = ref.parent_map()
    found, parent = ours.parents(probe)
    np.testing.assert_array_equal(found, [int(f) in want_map for f in probe])
    np.testing.assert_array_equal(
        parent, [want_map.get(int(f), 0) for f in probe])
    np.testing.assert_array_equal(ours.contains(probe), ref.contains(probe))
    assert len(ours) == len(ref)
    for got, want in zip(ours.to_arrays(), ref.to_arrays()):
        np.testing.assert_array_equal(got, want)
    assert ours.parent_map() == want_map


def test_spill_store_keeps_the_first_parent():
    s = HostSpillStore(background=False)
    s.append(np.array([5, 7], np.uint64), np.array([1, 2], np.uint64))
    s.append(np.array([7, 9], np.uint64), np.array([99, 3], np.uint64))
    found, parent = s.parents(np.array([5, 7, 9, 11], np.uint64))
    assert found.tolist() == [True, True, True, False]
    assert parent.tolist() == [1, 2, 3, 0]
    assert len(s) == 3 and s.parent_map()[7] == 2
    s.close()


def test_spill_store_under_concurrent_appends_and_lookups():
    # More threads than cores append disjoint keys (each key twice, the
    # second time with another parent) and look them up while the
    # background compactor merges every few appends. A lost chunk or a
    # lookup between a merge and its publication would show as a missing
    # key or a second parent.
    n_threads = (os.cpu_count() or 4) + 4
    s = HostSpillStore(compact_threshold=64, background=True)
    errors = []

    def worker(t):
        try:
            rng = np.random.default_rng(t)
            base = np.uint64(t) << np.uint64(40)
            for r in range(6):
                fps = base + np.arange(r * 50 + 1, r * 50 + 51, dtype=np.uint64)
                s.append(fps, fps + np.uint64(7))
                s.append(fps[rng.permutation(50)[:20]], np.full(20, 3, np.uint64))
                found, parent = s.parents(base + np.arange(1, r * 50 + 51, dtype=np.uint64))
                if not found.all() or (parent != base + np.arange(8, r * 50 + 58, dtype=np.uint64)).any():
                    errors.append(t)
        except Exception as e:  # reported by the assertion below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    fps, parents = s.to_arrays()
    assert fps.size == len(s) == n_threads * 300
    np.testing.assert_array_equal(parents, fps + np.uint64(7))
    s.close()


# -- eviction -----------------------------------------------------------------


def js_maybe_contains(words, fps):
    return np.asarray(_jax_maybe_contains(
        words, (fps & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        (fps >> np.uint64(32)).astype(np.uint32), 12))


def _jax_table(seed):
    """A 2^12-slot, 4-partition table built by the JAX kernel: row 0 of
    partition 0 overflows into row 1 (150 keys homed there), row 3 of
    partition 2 is filled exactly, and ~900 keys spread at random."""
    rng = np.random.default_rng(seed)
    P = 4
    n_rand = 900
    hi = np.concatenate([
        np.zeros(150, np.uint32),  # partition 0, row 0
        np.full(128, 3 * P + 2, np.uint32),  # partition 2, row 3
        rng.integers(0, 2**32, n_rand, dtype=np.uint32),
    ])
    lo = rng.permutation(np.arange(1, 2**20, dtype=np.uint32))[: hi.size]
    par = rng.integers(1, 2**31, hi.size, dtype=np.uint32)
    jt = JaxTable(12, n_partitions=P, interpret=True)
    for s in range(0, hi.size, 400):
        sl = slice(s, s + 400)
        jt.insert(*(jnp.asarray(a[sl]) for a in (lo, hi, par, par)),
                  jnp.ones(lo[sl].size, bool))
    return jt, lo, hi


def _cfg():
    return dict(high_water=0.5, low_water=0.12, summary_log2=12)


def test_eviction_equals_jax_slot_for_slot():
    jt, _, _ = _jax_table(8)
    arrays = [np.asarray(a).copy() for a in (jt.t_lo, jt.t_hi, jt.p_lo, jt.p_hi)]
    hot = int((arrays[0] != 0).sum())
    t_key, t_par = ph.from_jax_table(*arrays)
    ref = JaxStore(4096, JaxConfig(**_cfg()), background=False)
    ours = TieredStore(4096, TieredConfig(**_cfg()), background=False, device="cpu")
    host = TieredStore(4096, TieredConfig(**_cfg()), background=False, device="cpu")
    k_np, p_np = t_key.numpy().copy(), t_par.numpy().copy()

    want = ref.evict_host(*arrays, hot_claims=hot)
    got = ours.evict(t_key, t_par, hot)
    got_host = host.evict_host(k_np, p_np, hot)
    assert got == got_host == want > 0
    for table in (ph.to_jax_table(t_key, t_par),
                  ph.to_jax_table(torch.from_numpy(k_np), torch.from_numpy(p_np))):
        for a, b in zip(table, arrays):
            np.testing.assert_array_equal(a, b)  # the same zeroed slots
    for st in (ours, host):
        np.testing.assert_array_equal(st.summary.numpy().view(np.uint32), ref.summary_np)
        for a, b in zip(st.store.to_arrays(), ref.store.to_arrays()):
            np.testing.assert_array_equal(a, b)  # the same spill contents
        assert (st.sweep, st.spill_events) == (ref.sweep, ref.spill_events)
    # Full rows are never touched: row 0 of partition 0 and row 3 of
    # partition 2 keep all 128 keys.
    rows = t_key.view(-1, 128)
    V_rows = 1024 // 128
    assert bool((rows[0] != 0).all()) and bool((rows[2 * V_rows + 3] != 0).all())
    st = ours.stats(hot - got)
    assert st["evict_bytes_pcie"] < st["evict_bytes_unfiltered"]


def test_tiered_store_defaults_to_the_card(monkeypatch):
    # As PallasHashTable: the summary lives on the CUDA card unless the
    # caller asks for the CPU, and the bare constructor raises without one.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TieredStore(4096, TieredConfig(**_cfg()), background=False)
    ts = TieredStore(4096, TieredConfig(**_cfg()), background=False, device="cpu")
    assert ts.summary.device.type == "cpu"
    ts.close()


def test_eviction_buckets_are_the_kernels_rows():
    # Every home slot is a row start, a partition is a whole number of rows,
    # and no eviction bucket straddles two partitions.
    rng = np.random.default_rng(9)
    keys = torch.from_numpy(rng.integers(-(2**63), 2**63 - 1, 5000, dtype=np.int64) | 1)
    for log2 in (10, 11, 12, 16, 20):
        S = 1 << log2
        ts = TieredStore(S, TieredConfig(summary_log2=10), background=False, device="cpu")
        assert ts.bucket == ph.LANES and ts.n_buckets * ts.bucket == S
        base, start, V = ph._locate(torch.zeros(S, dtype=torch.int64), keys, None)
        assert V % ts.bucket == 0
        assert bool(((base + start) % ts.bucket == 0).all())
        first = torch.arange(ts.n_buckets) * ts.bucket
        assert bool((first // V == (first + ts.bucket - 1) // V).all())
        ts.close()


def test_verdicts_after_eviction_equal_jax_kernel():
    # Trap of a scan that stops at the first empty slot: after rows are
    # emptied, re-offered spilled keys must come back as new AND suspect,
    # resident keys as present — as the JAX kernel says, lane for lane.
    jt, lo, hi = _jax_table(10)
    arrays = [np.asarray(a).copy() for a in (jt.t_lo, jt.t_hi, jt.p_lo, jt.p_hi)]
    hot = int((arrays[0] != 0).sum())
    t_key, t_par = ph.from_jax_table(*arrays)
    ref = JaxStore(4096, JaxConfig(**_cfg()), background=False)
    ours = TieredStore(4096, TieredConfig(**_cfg()), background=False, device="cpu")
    assert ref.evict_host(*arrays, hot_claims=hot) == ours.evict(t_key, t_par, hot) > 0

    rng = np.random.default_rng(11)
    spilled = to_host_fp(torch.from_numpy(ours.store.to_arrays()[0].view(np.int64)))
    resident = to_host_fp(t_key[t_key != 0])
    fresh_lo = rng.integers(2**20, 2**32, 200, dtype=np.uint32)
    fresh_hi = rng.integers(0, 2**32, 200, dtype=np.uint32)
    fps = np.concatenate([
        rng.choice(spilled, 200), rng.choice(resident, 200),
        fresh_lo.astype(np.uint64) | (fresh_hi.astype(np.uint64) << np.uint64(32)),
    ])
    fps = fps[rng.permutation(fps.size)]
    b_lo = (fps & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b_hi = (fps >> np.uint64(32)).astype(np.uint32)
    par = rng.integers(1, 2**31, fps.size, dtype=np.uint32)
    cfg = (12, 4)
    insert = make_engine_insert(summary_cfg=cfg, n_partitions=4, interpret=True)
    tl, th, pl_, ph_, new_j, sus_j, ovf_j = insert(
        *(jnp.asarray(a) for a in arrays),
        jnp.asarray(b_lo), jnp.asarray(b_hi), jnp.asarray(par), jnp.asarray(par),
        jnp.ones(fps.size, bool), jnp.asarray(ref.summary_np),
    )
    key = pack_fp(torch.from_numpy(b_lo.astype(np.int64)), torch.from_numpy(b_hi.astype(np.int64)))
    parent = pack_fp(torch.from_numpy(par.astype(np.int64)), torch.from_numpy(par.astype(np.int64)))
    _, _, is_new, suspect, ovf = ph.insert_plain(
        t_key, t_par, key, parent, torch.ones(fps.size, dtype=torch.bool),
        n_partitions=4, summary=ours.summary, summary_cfg=cfg,
    )
    assert not bool(ovf) and not bool(ovf_j)
    np.testing.assert_array_equal(is_new.numpy(), np.asarray(new_j))
    np.testing.assert_array_equal(suspect.numpy(), np.asarray(sus_j))
    was_spilled = np.isin(fps, spilled)
    # First offer of each spilled key: new and suspect; resident: present.
    _, first = np.unique(fps, return_index=True)
    first_mask = np.zeros(fps.size, bool)
    first_mask[first] = True
    assert (suspect.numpy()[was_spilled & first_mask]).all()
    assert not is_new.numpy()[np.isin(fps, resident)].any()
    for a, b in zip(ph.to_jax_table(t_key, t_par), (tl, th, pl_, ph_)):
        np.testing.assert_array_equal(a, np.asarray(b))
    # The spill tier confirms exactly the spilled suspects as duplicates.
    sus_fps = fps[suspect.numpy()]
    np.testing.assert_array_equal(ours.resolve_suspects(sus_fps), np.isin(sus_fps, spilled))
    assert ours.suspects_checked == sus_fps.size


def test_partition_near_full_is_emptied_whole():
    # Partition 1 of four (1024 slots each) past 7/8 full, with a full home
    # row overflowing into the next: the partition pass empties it whole,
    # full rows included, and leaves the others alone. Re-offered keys then
    # get the JAX kernel's verdicts on the same table and summary.
    rng = np.random.default_rng(12)
    P, S = 4, 4096
    hi = np.concatenate([
        np.full(160, 1, np.uint32),  # partition 1, row 0: 128 + 32 overflow
        (rng.integers(0, 2**30, 760, dtype=np.uint32) * P + 1).astype(np.uint32),
        (rng.integers(0, 2**30, 300, dtype=np.uint32) * P).astype(np.uint32),
    ])
    lo = rng.permutation(np.arange(1, 2**20, dtype=np.uint32))[: hi.size]
    par = rng.integers(1, 2**31, hi.size, dtype=np.uint32)
    key = pack_fp(torch.from_numpy(lo.astype(np.int64)), torch.from_numpy(hi.astype(np.int64)))
    parent = torch.from_numpy(par.astype(np.int64))
    t_key = torch.zeros(S, dtype=torch.int64)
    t_par = torch.zeros(S, dtype=torch.int64)
    _, _, is_new, ovf = ph.insert_plain(t_key, t_par, key, parent,
                                        torch.ones(hi.size, dtype=torch.bool), n_partitions=P)
    assert not bool(ovf) and bool(is_new.all())
    ts = TieredStore(S, TieredConfig(**_cfg()), background=False, device="cpu")
    fill = ts.partition_fill(t_key)
    assert int(fill[1]) == 920 and ts.risk_slots == 896
    assert int(fill[[0, 2, 3]].max()) < ts.risk_slots
    before = t_key.clone()
    part1 = before.view(P, -1)[1]
    want = dict(zip(to_host_fp(part1[part1 != 0]).tolist(),
                    to_host_fp(t_par.view(P, -1)[1][part1 != 0]).tolist()))

    # hot_claims at low water: the reference's sweep has nothing to do.
    assert ts.evict(t_key, t_par, ts.low_slots) == 920
    assert (ts.spill_events, ts.partition_spills) == (1, 1)
    assert not bool(t_key.view(P, -1)[1].any()) and not bool(t_par.view(P, -1)[1].any())
    others = [0, 2, 3]
    assert torch.equal(t_key.view(P, -1)[others], before.view(P, -1)[others])
    assert ts.store.parent_map() == want
    spilled = np.array(sorted(want), dtype=np.uint64)
    words = ts.summary.numpy().view(np.uint32)
    assert js_maybe_contains(words, spilled).all()  # no false negatives

    resident = to_host_fp(t_key[t_key != 0])
    fps = np.concatenate([rng.choice(spilled, 300), rng.choice(resident, 100)])
    b_lo = (fps & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b_hi = (fps >> np.uint64(32)).astype(np.uint32)
    arrays = ph.to_jax_table(t_key, t_par)
    insert = make_engine_insert(summary_cfg=(12, 4), n_partitions=P, interpret=True)
    *_, new_j, sus_j, ovf_j = insert(
        *(jnp.asarray(a) for a in arrays), jnp.asarray(b_lo), jnp.asarray(b_hi),
        jnp.asarray(b_lo), jnp.asarray(b_lo), jnp.ones(fps.size, bool),
        jnp.asarray(words),
    )
    k = torch.from_numpy(fps.view(np.int64))
    _, _, is_new, suspect, ovf = ph.insert_plain(
        t_key, t_par, k, k & 0xFFFFFFFF, torch.ones(fps.size, dtype=torch.bool),
        n_partitions=P, summary=ts.summary, summary_cfg=(12, 4),
    )
    assert not bool(ovf) and not bool(ovf_j)
    np.testing.assert_array_equal(is_new.numpy(), np.asarray(new_j))
    np.testing.assert_array_equal(suspect.numpy(), np.asarray(sus_j))
    # Each spilled key comes back once, new and suspect; residents present.
    assert int(suspect.sum()) == np.unique(fps[:300]).size == int(is_new.sum())
    ts.close()


def test_partition_pass_completes_where_the_reference_aborts():
    # 2pc-5 through a 2^12 hot tier at high water 0.95: partitions fill up
    # before the table does. The JAX engine aborts (table full); the port's
    # partition pass empties them and the search reaches its golden.
    kw = dict(high_water=0.95, summary_log2=16)
    with pytest.raises(RuntimeError, match="hash table full"):
        JaxResident(jm.TensorTwoPhaseSys(5), 32, 12, insert_variant="pallas",
                    store="tiered", **kw).run()
    rs = ResidentSearch(tm.TensorTwoPhaseSys(5), 32, 12, store="tiered", device="cpu", **kw)
    r = rs.run()
    assert (r.state_count, r.unique_state_count) == (58146, 8832)
    assert r.detail["partition_spills"] >= 1 and r.detail["suspects_dup"] > 0
    for fp in r.discoveries.values():
        rs.reconstruct_path(fp)  # replays through spilled states
    assert set(r.discoveries) == {"abort agreement", "commit agreement"}


def test_tiered_config_validation():
    with pytest.raises(ValueError):
        TieredConfig(high_water=1.5).validate()
    with pytest.raises(ValueError):
        TieredConfig(high_water=0.5, low_water=0.6).validate()
    with pytest.raises(ValueError):
        TieredConfig(summary_log2=4).validate()


# -- queue helpers --------------------------------------------------------------


def test_compact_queue_and_inject_rows_overlap():
    q = (torch.arange(40).view(20, 2).clone(), torch.arange(20))
    tail = compact_queue(q, 3, 15)  # source and destination overlap
    assert tail == 12
    assert q[1][:12].tolist() == list(range(3, 15))
    assert q[0][:12].tolist() == [[2 * i, 2 * i + 1] for i in range(3, 15)]
    tail = inject_rows(q, tail, (torch.full((2, 2), -1), torch.tensor([-5, -6])))
    assert tail == 14 and q[1][:14].tolist() == list(range(3, 15)) + [-5, -6]


# -- the engine: 2pc-4 through a 2^11 hot tier ------------------------------------


@pytest.fixture(scope="module")
def twopc4_tiered():
    """The JAX engine at its pin and the port on the CPU, once."""
    jrs = JaxResident(jm.TensorTwoPhaseSys(4), 32, 11, insert_variant="pallas",
                      store="tiered", **PIN)
    jr = jrs.run()
    prs = ResidentSearch(tm.TensorTwoPhaseSys(4), 32, 11, store="tiered",
                         device="cpu", **PIN)
    pr = prs.run()
    return jrs, jr, prs, pr


def test_tiered_counts_and_discoveries_equal_jax(twopc4_tiered):
    _, jr, _, pr = twopc4_tiered
    assert (pr.state_count, pr.unique_state_count) == GOLD_2PC4
    assert (jr.state_count, jr.unique_state_count) == GOLD_2PC4
    assert (pr.max_depth, pr.steps, pr.complete) == (jr.max_depth, jr.steps, jr.complete)
    assert set(pr.discoveries) == {"abort agreement", "commit agreement"}
    assert pr.discoveries == jr.discoveries


def test_tiered_store_counters_equal_jax(twopc4_tiered):
    _, jr, _, pr = twopc4_tiered
    keys = ("spill_events", "spilled_states", "suspects_checked", "suspects_dup",
            "hot_fill", "evict_bytes_unfiltered")
    assert {k: pr.detail[k] for k in keys} == {k: jr.detail[k] for k in keys}
    assert pr.detail["spill_events"] >= 1 and pr.detail["suspects_checked"] > 0
    assert pr.detail["service_seconds"]["calls"] >= pr.detail["spill_events"]


def test_tiered_witnesses_cross_tiers_and_replay(twopc4_tiered):
    jrs, jr, prs, pr = twopc4_tiered
    spilled = set(prs._store.store.to_arrays()[0].tolist())
    parents = _TableParents(prs._c["t_key"], prs._c["t_parent"], prs._store)
    through_spill = False
    for name, fp in pr.discoveries.items():
        path = prs.reconstruct_path(fp)
        assert path.into_pairs() == jrs.reconstruct_path(fp).into_pairs()
        cur = fp
        while cur:
            through_spill |= cur in spilled
            cur = parents.get(cur)
    assert through_spill  # some witness walks through a spilled state
    # The spill tier wins on keys in both tiers, as the JAX parent map does.
    assert prs.build_parent_map() == jrs.build_parent_map()


def test_spawn_cuda_tiered_on_the_cpu():
    c = tm.TensorTwoPhaseSys(4).checker().spawn_cuda(
        batch_size=32, table_log2=11, store="tiered", device="cpu", **PIN
    ).join()
    assert (c.state_count(), c.unique_state_count()) == GOLD_2PC4
    stats = c.store_stats()
    assert stats["store"] == "tiered" and stats["spill_events"] >= 1
    paths = c.discoveries()
    assert len(paths["abort agreement"]) - 1 == 4
    assert len(paths["commit agreement"]) - 1 == 13
    for name, path in paths.items():
        c.assert_discovery(name, path.actions())
    c.assert_no_discovery("consistent")
    with pytest.raises(RuntimeError, match="compacted"):
        c._search.dump_states()


def test_tiered_engine_argument_errors():
    with pytest.raises(ValueError, match="store must be"):
        ResidentSearch(tm.TensorTwoPhaseSys(3), 32, 11, store="bogus", device="cpu")
    with pytest.raises(ValueError, match="too small"):
        # 2^10 slots minus one step of claims (64 x 17) is under low water.
        ResidentSearch(tm.TensorTwoPhaseSys(3), 64, 10, store="tiered", device="cpu")
    assert ResidentSearch(tm.TensorTwoPhaseSys(3), 32, 12, device="cpu").store_stats() is None
