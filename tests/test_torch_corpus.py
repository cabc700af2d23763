"""The port's warm-start corpus (stateright_tpu_torch/store/{corpus,warm}.py
and the warm ladder of service/scheduler.py) on the CPU: the mirrors of the
23 tests of tests/test_corpus.py, each running the JAX package and the port
on the same inputs and holding them equal, and an interop test of the entry
file.

Compared exactly, per job and per engine: counts, depth, steps, the rung
served, `detail["corpus"]` (its content-key prefix aside: the port's keys
live in their own namespace), discoveries, witness actions, the corpus
counters (the port's extra `untraceable` aside), and the published entry's
fingerprints, parents, summary words, counts, discoveries and journal
planes. The JAX side runs as its own tests run it, its services with the
"pallas" insert in interpret mode (the variant the port's kernel is).

The JAX module's slow marks are kept: the paxos-2 and register-model cases
(`test_corpus.py:260, :632`)."""

import glob
import json
import os
import shutil

import numpy as np
import pytest

from stateright_tpu.core.discovery import HasDiscoveries as JaxHasDiscoveries
from stateright_tpu.faults import FaultPlan as JaxFaultPlan
from stateright_tpu.faults import active as jax_active
from stateright_tpu.faults.ckptio import corrupt_one_byte as jax_corrupt
from stateright_tpu.service import CheckService as JaxService
from stateright_tpu.service import ServiceFleet as JaxFleet
from stateright_tpu.store import corpus as jcorpus
from stateright_tpu.tensor import models as jm
from stateright_tpu.tensor.frontier import FrontierSearch as JaxFrontier
from stateright_tpu_torch import HasDiscoveries
from stateright_tpu_torch.faults import FaultPlan, active
from stateright_tpu_torch.faults.ckptio import corrupt_one_byte
from stateright_tpu_torch.service import CheckService, ServiceFleet
from stateright_tpu_torch.store import corpus as pcorpus
from stateright_tpu_torch.store import warm as pwarm
from stateright_tpu_torch.tensor import models as pm
from stateright_tpu_torch.tensor.frontier import FrontierSearch

GOLD_2PC3 = (1_146, 288)

# Module-level instances on both sides: same-instance jobs share a group.
J3, P3 = jm.TensorTwoPhaseSys(3), pm.TensorTwoPhaseSys(3)

SVC_KW = dict(batch_size=128, table_log2=14, store="tiered", high_water=0.85,
              summary_log2=16, background=False)
JAX_KW = dict(SVC_KW, insert_variant="pallas")
PORT_KW = dict(SVC_KW, device="cpu")
FLEET_KW = dict(batch_size=128, table_log2=14, summary_log2=16)
ENGINE_KW = dict(batch_size=128, table_log2=14, store="tiered", summary_log2=16)


def _run(svc, model, **opts):
    h = svc.submit(model, **opts)
    svc.drain(timeout=600)
    return h


def _outcome(r):
    return (r.state_count, r.unique_state_count, r.max_depth, r.steps, r.complete,
            r.discoveries)


def _corpus_detail(r):
    """detail["corpus"] without the content-key prefix (namespaced)."""
    return {k: v for k, v in (r.detail.get("corpus") or {}).items() if k != "key"}


def _stats(svc):
    """The corpus counters the two packages share."""
    return {k: v for k, v in svc.stats()["corpus"].items() if k != "untraceable"}


def _clear_verdict_caches():
    """Empty both packages' process-wide canonical verdict caches. A corpus
    entry publishes the cache's most recently used verdicts (its
    `verdicts_published` counter counts them), whichever job computed them,
    so a test that ran earlier in the same worker process would otherwise
    leak into the entries and counters compared here."""
    from stateright_tpu.semantics import clear_serialization_caches as jax_clear
    from stateright_tpu_torch.semantics import clear_serialization_caches

    jax_clear()
    clear_serialization_caches()


@pytest.fixture(autouse=True)
def _fresh_verdict_caches():
    _clear_verdict_caches()


def _actions(handle) -> dict:
    return {name: path.actions() for name, path in handle.discoveries().items()}


def _entry_files(corpus_dir):
    """Entry generations (complete and partial), not the index records."""
    return [p for p in glob.glob(os.path.join(corpus_dir, "corpus-*.npz"))
            if "-family-" not in os.path.basename(p) and "-spec-" not in os.path.basename(p)]


def _same_entry(a, b):
    """Two packages' decoded entries of one run hold the same visited set."""
    np.testing.assert_array_equal(a.fps, b.fps)
    np.testing.assert_array_equal(a.parents, b.parents)
    np.testing.assert_array_equal(a.summary, b.summary)
    assert (a.summary_log2, a.summary_hashes, a.meta, a.complete) == (
        b.summary_log2, b.summary_hashes, b.meta, b.complete)
    for plane in ("journal_states", "journal_depths", "journal_bound"):
        x, y = getattr(a, plane), getattr(b, plane)
        assert (x is None) == (y is None), plane
        if x is not None:
            np.testing.assert_array_equal(x, y)
    assert (a.frontier is None) == (b.frontier is None)
    if a.frontier is not None:
        for k in a.frontier:
            np.testing.assert_array_equal(a.frontier[k], b.frontier[k])


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    """ONE cold 2pc-3 submission through a corpus service on each side: the
    publishers every warm test reads from."""
    out = {}
    _clear_verdict_caches()
    for side, cls, model, kw in (("jax", JaxService, J3, JAX_KW),
                                 ("port", CheckService, P3, PORT_KW)):
        d = str(tmp_path_factory.mktemp(f"corpus_{side}"))
        svc = cls(corpus_dir=d, **kw)
        try:
            h = _run(svc, model)
            r = h.result()
            out[side] = {"dir": d, "cold": r, "paths": _actions(h),
                         "key": h._job.content_key}
        finally:
            svc.close()
        assert (r.state_count, r.unique_state_count) == GOLD_2PC3
        assert r.detail["corpus"]["published"] is True
        assert r.detail["corpus"]["warm_start"] is False
    j, p = out["jax"], out["port"]
    assert _outcome(p["cold"]) == _outcome(j["cold"]) and p["paths"] == j["paths"]
    assert _corpus_detail(p["cold"]) == _corpus_detail(j["cold"])
    _same_entry(pcorpus.CorpusStore(p["dir"]).lookup(p["key"]),
                jcorpus.CorpusStore(j["dir"]).lookup(j["key"]))
    return out


# -- content addressing --------------------------------------------------------


def test_content_key_stable_across_equal_models_and_sensitive_to_config():
    assert pcorpus.model_def_hash(pm.TensorTwoPhaseSys(3)) == pcorpus.model_def_hash(
        pm.TensorTwoPhaseSys(3))
    assert pcorpus.model_def_hash(pm.TensorTwoPhaseSys(3)) != pcorpus.model_def_hash(
        pm.TensorTwoPhaseSys(4))
    low = dict(batch_size=128, table_log2=14, finish=("all", (), None, None))
    k = pcorpus.content_key(P3, low)
    assert k == pcorpus.content_key(pm.TensorTwoPhaseSys(3), low)
    assert k != pcorpus.content_key(P3, dict(low, table_log2=15))
    assert k != pcorpus.content_key(P3, dict(low, finish=("all", (), 100, None)))
    # Every lowering knob moves the key, as in the JAX package.
    for knob, value in (("batch_size", 256), ("insert_variant", "sort"), ("store", "device"),
                        ("summary_log2", 18), ("summary_hashes", 3)):
        assert k != pcorpus.content_key(P3, dict(low, **{knob: value})), knob
    # The port's keys are its own namespace: never the JAX key of the model.
    assert k != jcorpus.content_key(J3, low)
    assert pcorpus.model_def_hash(P3) != jcorpus.model_def_hash(J3)


def test_finish_signature_distinguishes_policies():
    sigs = []
    for ours, theirs in ((HasDiscoveries.ALL, JaxHasDiscoveries.ALL),
                         (HasDiscoveries.ANY, JaxHasDiscoveries.ANY),
                         (HasDiscoveries.all_of(["x"]), JaxHasDiscoveries.all_of(["x"]))):
        a = pcorpus.finish_signature(ours, None, None)
        assert a == jcorpus.finish_signature(theirs, None, None)
        sigs.append(a)
    assert len(set(sigs)) == 3


# -- the corpus store (no device work) -----------------------------------------


def _store_pair(tmp_path, **kw):
    return (pcorpus.CorpusStore(str(tmp_path / "port"), **kw),
            jcorpus.CorpusStore(str(tmp_path / "jax"), **kw))


def test_publish_lookup_roundtrip_and_content_addressed_skip(tmp_path):
    fps = np.arange(1, 100, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    parents = np.zeros(99, dtype=np.uint64)
    parents[1:] = fps[:-1]
    meta = {"state_count": 400, "unique_count": 99, "max_depth": 7,
            "discoveries": {"prop a": int(fps[42])}}
    ours, theirs = _store_pair(tmp_path, summary_log2=12)
    for store in (ours, theirs):
        assert store.publish("ab12" * 8, fps, parents, meta) is True
        assert store.publish("ab12" * 8, fps, parents, meta) is False  # shared address
        assert store.lookup("cd34" * 8) is None
    a, b = ours.lookup("ab12" * 8), theirs.lookup("ab12" * 8)
    assert (a.fps == fps).all() and (a.parents == parents).all() and a.meta == meta
    assert a.summary_log2 == 12 and a.summary.any()
    _same_entry(a, b)  # the Bloom words too: one bit layout
    m = ours.metrics()
    assert m["publishes"] == 1 and m["publish_skipped"] == 1 and m["hits"] == 1
    assert m["misses"] == 1
    assert {k: v for k, v in m.items() if k != "untraceable"} == theirs.metrics()


def test_corrupt_entry_detected_counted_and_ignored(tmp_path):
    fps = np.arange(1, 50, dtype=np.uint64)
    meta = {"state_count": 49, "unique_count": 49, "max_depth": 3, "discoveries": {}}
    for store, corrupt in zip(_store_pair(tmp_path, summary_log2=12),
                              (corrupt_one_byte, jax_corrupt)):
        store.publish("ef56" * 8, fps, np.zeros(49, np.uint64), meta)
        (path,) = glob.glob(os.path.join(store.root, "corpus-*.npz"))
        corrupt(path)
        assert store.lookup("ef56" * 8) is None
        m = store.metrics()
        assert m["corrupt_entries"] == 1 and m["hits"] == 0
    for store in _store_pair(tmp_path / "t2", summary_log2=12):
        store.publish("ef56" * 8, fps, np.zeros(49, np.uint64), meta)
        (p2,) = glob.glob(os.path.join(store.root, "corpus-*.npz"))
        with open(p2, "r+b") as f:
            f.truncate(os.path.getsize(p2) // 2)
        assert store.lookup("ef56" * 8) is None
        assert store.metrics()["corrupt_entries"] == 1


def test_tiered_preload_salted_membership_and_chains():
    from stateright_tpu.store.tiered import TieredConfig as JaxConfig
    from stateright_tpu.store.tiered import TieredStore as JaxTiered
    from stateright_tpu.tensor.fingerprint import job_salt as jax_job_salt
    from stateright_tpu.tensor.fingerprint import pack_fp as jax_pack_fp
    from stateright_tpu.tensor.fingerprint import salt_fp as jax_salt_fp
    from stateright_tpu_torch.store.summary import maybe_contains
    from stateright_tpu_torch.store.tiered import TieredConfig, TieredStore
    from stateright_tpu_torch.tensor.fingerprint import job_salt, pack_salt

    rng = np.random.default_rng(5)
    lo = rng.integers(1, 2**32, 200, dtype=np.uint32)
    hi = rng.integers(0, 2**32, 200, dtype=np.uint32)
    fps = jax_pack_fp(lo, hi)
    parents = np.zeros(200, dtype=np.uint64)
    parents[1:] = fps[:-1]
    ts = TieredStore(1 << 10, TieredConfig(summary_log2=12), background=False, device="cpu")
    ref = JaxTiered(1 << 10, JaxConfig(summary_log2=12), background=False)
    sl, sh = job_salt(9)
    assert (sl, sh) == jax_job_salt(9)
    assert ts.preload(fps, parents, salt=pack_salt(sl, sh)) == 200
    assert ref.preload(fps, parents, salt_lo=sl, salt_hi=sh) == 200
    klo, khi = jax_salt_fp(lo, hi, sl, sh)
    keys = jax_pack_fp(klo, khi)
    assert ts.resolve_suspects(keys).all()
    words = ts.summary.numpy().view(np.uint32)
    assert maybe_contains(words, klo, khi, 12).all()
    np.testing.assert_array_equal(words, ref.summary_np)
    pm_ = ts.parent_map()
    assert pm_ == ref.parent_map()
    assert pm_[int(keys[0])] == 0
    assert pm_[int(keys[5])] == int(jax_pack_fp(*jax_salt_fp(lo[4], hi[4], sl, sh)))
    ts.close()
    ref.close()


# -- the acceptance bar: warm second submission, bit-identical -----------------


def test_service_warm_start_bit_identical_2pc3(published, tmp_path):
    got = {}
    for side, cls, model, kw in (("jax", JaxService, J3, JAX_KW),
                                 ("port", CheckService, P3, PORT_KW)):
        events_path = str(tmp_path / f"{side}.jsonl")
        svc = cls(corpus_dir=published[side]["dir"], events_out=events_path, **kw)
        try:
            h = _run(svc, model)
            r = h.result()
            got[side] = (r, _actions(h), _stats(svc), h.id)
        finally:
            svc.close()
        cold = published[side]["cold"]
        assert (r.state_count, r.unique_state_count, r.max_depth, r.discoveries) == (
            cold.state_count, cold.unique_state_count, cold.max_depth, cold.discoveries)
        assert got[side][1] == published[side]["paths"] and r.complete
        assert r.detail["corpus"]["warm_start"] is True
        assert r.detail["corpus"]["preloaded_states"] == GOLD_2PC3[1]
        assert r.steps < cold.steps
        events = [json.loads(line) for line in open(events_path, encoding="utf-8")
                  if line.strip()]
        warm = [e for e in events if e["event"] == "job.warm_start"]
        assert len(warm) == 1 and warm[0]["job"] == h.id
        assert warm[0]["states"] == GOLD_2PC3[1] and warm[0]["kind"] == "exact"
    (r, paths, stats, _), (rj, paths_j, stats_j, _) = got["port"], got["jax"]
    assert _outcome(r) == _outcome(rj) and paths == paths_j
    assert _corpus_detail(r) == _corpus_detail(rj)
    assert stats == stats_j and stats["hits"] == 1
    assert stats["preload_states"] == GOLD_2PC3[1]
    from stateright_tpu_torch.obs.schema import validate_detail

    assert validate_detail(r.detail) == []


@pytest.mark.slow
def test_service_warm_start_bit_identical_paxos2(tmp_path):
    from stateright_tpu.tensor.paxos import TensorPaxos as JaxPaxos
    from stateright_tpu_torch.tensor import TensorPaxos

    kw = dict(batch_size=2048, table_log2=17, store="tiered", high_water=0.9,
              summary_log2=18, background=False)
    out = {}
    for side, cls, mp, extra in (("jax", JaxService, JaxPaxos(client_count=2),
                                  dict(insert_variant="pallas")),
                                 ("port", CheckService, TensorPaxos(2), dict(device="cpu"))):
        d = str(tmp_path / side)
        svc = cls(corpus_dir=d, **kw, **extra)
        try:
            r_cold = _run(svc, mp).result()
            r_warm = _run(svc, mp).result()
        finally:
            svc.close()
        assert r_cold.unique_state_count == 16_668
        assert _outcome(r_warm)[:3] == _outcome(r_cold)[:3]
        assert r_warm.discoveries == r_cold.discoveries
        assert r_warm.detail["corpus"]["warm_start"] is True
        assert r_warm.steps < r_cold.steps / 2
        fleet_cls = JaxFleet if side == "jax" else ServiceFleet
        fleet = fleet_cls(n_replicas=2, background=False, corpus_dir=d,
                          service_kwargs=dict(batch_size=2048, table_log2=17, high_water=0.9,
                                              summary_log2=18, **extra))
        try:
            rf = _run(fleet, mp).result()
        finally:
            fleet.close()
        assert _outcome(rf)[:3] == _outcome(r_cold)[:3]
        assert rf.discoveries == r_cold.discoveries
        assert rf.detail["corpus"]["warm_start"] is True
        out[side] = (_outcome(r_cold), _outcome(r_warm), _outcome(rf))
    assert out["port"] == out["jax"]


# -- standalone engine: frontier seeding against a pre-warmed summary ----------


def test_frontier_warm_start_from_service_published_entry(published):
    entry = pcorpus.CorpusStore(published["port"]["dir"], summary_log2=16).lookup(
        published["port"]["key"])
    ref_entry = jcorpus.CorpusStore(published["jax"]["dir"], summary_log2=16).lookup(
        published["jax"]["key"])
    assert entry is not None and entry.states == GOLD_2PC3[1]
    cold = FrontierSearch(P3, device="cpu", **ENGINE_KW)
    r_cold = cold.run()
    warm = FrontierSearch(P3, device="cpu", **ENGINE_KW)
    assert warm.warm_start(entry) == GOLD_2PC3[1]
    r_warm = warm.run()
    ref = JaxFrontier(J3, insert_variant="pallas", **ENGINE_KW)
    assert ref.warm_start(ref_entry) == GOLD_2PC3[1]
    r_ref = ref.run()
    assert _outcome(r_warm)[:3] == _outcome(r_cold)[:3]
    assert r_warm.discoveries == r_cold.discoveries and r_warm.steps < r_cold.steps
    assert _outcome(r_warm) == _outcome(r_ref)
    assert r_warm.detail["corpus"] == r_ref.detail["corpus"]
    assert r_warm.detail["corpus"]["warm_start"] is True
    for name, fp in r_warm.discoveries.items():
        assert (warm.reconstruct_path(fp).actions() == cold.reconstruct_path(fp).actions()
                == ref.reconstruct_path(fp).actions())


def test_frontier_warm_start_requires_tiered_store():
    fs = FrontierSearch(P3, batch_size=128, table_log2=14, device="cpu")
    with pytest.raises(ValueError, match="tiered"):
        fs.warm_start(object())
    with pytest.raises(ValueError, match="tiered"):
        JaxFrontier(J3, batch_size=128, table_log2=14).warm_start(object())


# -- degraded modes: every failure falls back to a correct cold run ------------


def _fault_sequence(cls, model, kw, plan_cls, act, corpus_dir, resume_cls, hd):
    """The JAX test's five acts on one service: a faulted publish, a cold
    publish, a faulted load, a warm run, and a warm-marked resume that
    cannot re-warm. Returns what each act showed."""
    out = []
    svc = cls(corpus_dir=corpus_dir, **kw)
    try:
        plan = plan_cls().rule("corpus.publish", "io", times=1)
        with act(plan):
            r1 = _run(svc, model).result()
        out.append((plan.injected_total(), _outcome(r1), _corpus_detail(r1),
                    glob.glob(os.path.join(corpus_dir, "corpus-*.npz")),
                    svc.stats()["corpus"]["publish_faults"]))
        r2 = _run(svc, model).result()
        out.append((_outcome(r2), _corpus_detail(r2)))
        plan = plan_cls().rule("corpus.load", "io", times=1)
        with act(plan):
            r3 = _run(svc, model).result()
        out.append((plan.injected_total(), _outcome(r3), _corpus_detail(r3),
                    svc.stats()["corpus"]["load_faults"]))
        r4 = _run(svc, model).result()
        out.append((_outcome(r4), _corpus_detail(r4)))
        rz = resume_cls(
            chunks=[],
            journal=(np.asarray([123], np.uint32), np.asarray([456], np.uint32),
                     np.zeros(1, np.uint32), np.zeros(1, np.uint32)),
            state_count=1, unique_count=1, max_depth=1, discoveries={}, was_warm=True)
        h5 = svc.submit(model, resume=rz, journal=True, finish_when=hd.ALL_FAILURES)
        svc.drain(timeout=600)
        r5 = h5.result()
        out.append((_outcome(r5), _corpus_detail(r5)))
        out.append(_stats(svc))
    finally:
        svc.close()
    return out


def test_corpus_fault_points_degrade_to_correct_cold_runs(tmp_path):
    from stateright_tpu.service.queue import JobResume as JaxResume
    from stateright_tpu_torch.service.queue import JobResume

    ours = _fault_sequence(CheckService, P3, PORT_KW, FaultPlan, active,
                           str(tmp_path / "port"), JobResume, HasDiscoveries)
    theirs = _fault_sequence(JaxService, J3, JAX_KW, JaxFaultPlan, jax_active,
                             str(tmp_path / "jax"), JaxResume, JaxHasDiscoveries)
    (inj1, o1, d1, files1, pf), (o2, d2), (inj3, o3, d3, lf), (o4, d4), (o5, d5), _ = ours
    assert inj1 == 1 and o1[:2] == GOLD_2PC3 and d1["published"] is False
    assert files1 == [] and pf == 1
    assert d2["warm_start"] is False and d2["published"] is True
    assert inj3 == 1 and o3[:2] == GOLD_2PC3 and d3["warm_start"] is False and lf == 1
    assert d4["warm_start"] is True and o4[:2] == GOLD_2PC3 and o4[5] == o2[5]
    # The warm-marked payload was discarded and the job ran cold.
    assert o5[:2] == GOLD_2PC3 and o5[4] and d5["warm_start"] is False
    assert ours[1:-1] == theirs[1:-1]
    assert ours[-1] == theirs[-1], f"port corpus counters {ours[-1]}\njax corpus counters {theirs[-1]}"
    assert ours[0][:3] == theirs[0][:3] and ours[0][4] == theirs[0][4]


def test_warm_marker_round_trips_through_checkpoint_arrays():
    from stateright_tpu.service.queue import Job as JaxJob
    from stateright_tpu_torch.service.queue import Job, JobResume

    class _M:
        lanes = 2

        def properties(self):
            return []

    for cls in (Job, JaxJob):
        warm_job = cls(7, _M(), journal=True)
        warm_job.warm = {"state_count": 0}
        assert int(warm_job.fleet_snapshot()["w_warm"][0]) == 1
        cold_job = cls(8, _M(), journal=True)
        assert int(cold_job.fleet_snapshot()["w_warm"][0]) == 0
    legacy = {k: v for k, v in Job(8, _M(), journal=True).fleet_snapshot().items()
              if k != "w_warm"}
    assert JobResume.from_npz(legacy).was_warm is False


# -- fleet: shared corpus directory across replicas ----------------------------


def _fleet_acts(fleet_cls, model, corpus_dir, extra, plan_cls, act):
    fleet = fleet_cls(n_replicas=2, background=False, service_kwargs=dict(FLEET_KW, **extra),
                      corpus_dir=corpus_dir)
    out = []
    try:
        h1 = fleet.submit(model)
        owner = h1._job.replica
        fleet.drain(timeout=600)
        r1 = h1.result()
        out.append((_outcome(r1), _corpus_detail(r1), owner))
        other = next(f"k{i}" for i in range(64) if fleet.router.ring.lookup(f"k{i}") != owner)
        h2 = fleet.submit(model, route_key=other)
        assert h2._job.replica != owner
        fleet.drain(timeout=600)
        r2 = h2.result()
        out.append((_outcome(r2), _corpus_detail(r2), len(_entry_files(corpus_dir))))
        h3 = fleet.submit(model)
        victim = h3._job.replica
        plan = plan_cls().rule("fleet.replica_crash", "crash", times=1,
                               match={"replica": victim})
        with act(plan):
            fleet.drain(timeout=600)
        r3 = h3.result()
        s = fleet.stats()
        out.append((plan.injected_total(), r3.state_count, r3.unique_state_count,
                    r3.discoveries, r3.detail["corpus"]["warm_start"],
                    h3._job.requeues >= 1, h3._job.replica != victim,
                    s["replica_crashes"], s["requeued_jobs"] >= 1))
    finally:
        fleet.close()
    return out


def test_fleet_warm_start_cross_replica_and_crash_requeue(tmp_path):
    ours = _fleet_acts(ServiceFleet, P3, str(tmp_path / "port"), dict(device="cpu"),
                       FaultPlan, active)
    theirs = _fleet_acts(JaxFleet, J3, str(tmp_path / "jax"), dict(insert_variant="pallas"),
                         JaxFaultPlan, jax_active)
    (o1, d1, _), (o2, d2, n_files), act3 = ours
    assert o1[:2] == GOLD_2PC3 and d1["published"] is True
    assert o2[:3] == o1[:3] and o2[5] == o1[5] and d2["warm_start"] is True
    assert n_files == 1  # one shared generation, no private copies
    assert act3 == (1, *GOLD_2PC3, o1[5], True, True, True, 1, True)
    assert ours == theirs


# -- guardrails / schema -------------------------------------------------------


def test_corpus_requires_tiered_store(tmp_path):
    with pytest.raises(ValueError, match="tiered"):
        CheckService(batch_size=64, table_log2=12, corpus_dir=str(tmp_path),
                     background=False, device="cpu")
    with pytest.raises(ValueError, match="tiered"):
        JaxService(batch_size=64, table_log2=12, corpus_dir=str(tmp_path), background=False)


def test_corpus_schema_registered():
    from stateright_tpu.obs import schema as jschema
    from stateright_tpu_torch.obs.schema import (
        CORPUS_DELTA_COUNTERS,
        CORPUS_DETAIL_KEYS,
        CORPUS_V2_COUNTERS,
        DETAIL_KEYS,
        EVENT_TYPES,
        REGISTRY_SOURCES,
        validate_detail,
    )

    assert "corpus" in DETAIL_KEYS and "corpus" in REGISTRY_SOURCES
    assert "job.warm_start" in EVENT_TYPES and "job" in EVENT_TYPES["job.warm_start"]
    assert set(CORPUS_DETAIL_KEYS) == set(jschema.CORPUS_DETAIL_KEYS)
    assert CORPUS_V2_COUNTERS == jschema.CORPUS_V2_COUNTERS
    assert CORPUS_DELTA_COUNTERS == jschema.CORPUS_DELTA_COUNTERS
    detail = {"corpus": {"warm_start": True, "preloaded_states": 288, "published": False,
                         "key": "ab12cd34ef56ab12"}}
    assert validate_detail(detail) == [] == jschema.validate_detail(detail)
    detail["corpus"]["renamed"] = 1
    assert validate_detail(detail) == ["corpus.renamed"] == jschema.validate_detail(detail)


# -- dedup-first semantics: GC + verdict warm-start ----------------------------


def _gc_sequence(store, plan_cls, act):
    n = 64
    metas = {"state_count": 1, "unique_count": 1, "max_depth": 1, "discoveries": {}}
    keys = []
    for i in range(3):
        key = f"{i:032x}"
        assert store.publish(key, np.arange(1, n + 1, dtype=np.uint64) + i,
                             np.zeros(n, np.uint64), metas)
        os.utime(store.path_for(key), (1_000_000 + i * 100, 1_000_000 + i * 100))
        keys.append(key)
    out = []
    plan = plan_cls().rule("corpus.gc", "io", times=1)
    with act(plan):
        evicted = store.gc(max_bytes=0)["evicted"]
    out.append((plan.injected_total(), evicted))
    out.append(len(glob.glob(os.path.join(store.root, "corpus-*.npz"))))
    store.pin(keys[0])
    total = sum(os.path.getsize(p)
                for p in glob.glob(os.path.join(store.root, "corpus-*.npz*")))
    swept = store.gc(max_bytes=total - 1)
    out.append((swept["pinned_skips"] >= 1, swept["evicted"],
                os.path.exists(store.path_for(keys[0])),
                os.path.exists(store.path_for(keys[1])),
                store.lookup(keys[0]) is not None))
    store.unpin(keys[0])
    out.append((store.gc(max_bytes=0)["evicted"],
                glob.glob(os.path.join(store.root, "corpus-*.npz"))))
    m = store.metrics()
    out.append({k: m[k] for k in ("gc_faults", "gc_evicted", "gc_pinned_skips", "gc_sweeps")})
    out.append(m["gc_bytes_freed"] > 0)
    return out


def test_corpus_gc_mtime_lru_respects_pins(tmp_path):
    ours = _gc_sequence(pcorpus.CorpusStore(str(tmp_path / "p"), summary_log2=16),
                        FaultPlan, active)
    theirs = _gc_sequence(jcorpus.CorpusStore(str(tmp_path / "j"), summary_log2=16),
                          JaxFaultPlan, jax_active)
    assert ours[0] == (1, 0) and ours[1] == 3
    assert ours[2] == (True, 1, True, False, True)
    assert ours[3] == (2, []) and ours[4]["gc_faults"] == 1 and ours[5]
    assert ours == theirs


def _jax_register_model():
    from stateright_tpu.actor.register import GetOk
    from stateright_tpu.examples.single_copy_register import NULL_VALUE, SingleCopyModelCfg
    from stateright_tpu.tensor.lowering import lower_actor_model
    from stateright_tpu.tensor.model import TensorProperty

    def properties(view):
        lin = view.history_pred(lambda h: h.is_consistent())
        chosen = view.any_env(lambda env: isinstance(env.msg, GetOk)
                              and env.msg.value != NULL_VALUE)
        return [TensorProperty.always("linearizable", lambda m, s: lin(s)),
                TensorProperty.sometimes("value chosen", lambda m, s: chosen(s))]

    cfg = SingleCopyModelCfg(client_count=2, server_count=1)
    return lower_actor_model(cfg.into_model(), properties=properties)


def _port_register_model():
    from stateright_tpu_torch.actor.register import GetOk
    from stateright_tpu_torch.examples.single_copy_register import (
        NULL_VALUE,
        SingleCopyModelCfg,
    )
    from stateright_tpu_torch.tensor.lowering import lower_actor_model
    from stateright_tpu_torch.tensor.model import TensorProperty

    def properties(view):
        lin = view.history_pred(lambda h: h.is_consistent())
        chosen = view.any_env(lambda env: isinstance(env.msg, GetOk)
                              and env.msg.value != NULL_VALUE)
        return [TensorProperty.always("linearizable", lambda m, s: lin(s)),
                TensorProperty.sometimes("value chosen", lambda m, s: chosen(s))]

    cfg = SingleCopyModelCfg(client_count=2, server_count=1)
    return lower_actor_model(cfg.into_model(), properties=properties)


@pytest.mark.slow
def test_service_verdict_warm_start_register_model(tmp_path):
    """The verdict table rides the entry, and a repeat submission seeds the
    canonical verdict cache from it, on both sides alike."""
    from stateright_tpu.semantics import clear_serialization_caches as jax_clear
    from stateright_tpu_torch.semantics import clear_serialization_caches

    out = {}
    for side, cls, build, clear, kw in (
            ("jax", JaxService, _jax_register_model, jax_clear, JAX_KW),
            ("port", CheckService, _port_register_model, clear_serialization_caches, PORT_KW)):
        d = str(tmp_path / side)
        clear()
        svc = cls(corpus_dir=d, **kw)
        try:
            model = build()
            cold = _run(svc, model).result()
            assert cold.detail["corpus"]["published"] is True
            assert cold.unique_state_count == 93
            (path,) = _entry_files(d)
            with np.load(path) as data:
                assert len(data["sem_fps"]) == len(data["sem_verdicts"]) > 0
            clear()
            warm = _run(svc, model).result()
            assert warm.detail["corpus"]["warm_start"] is True
            assert warm.detail["corpus"]["verdict_preloads"] > 0
            assert _outcome(warm)[:3] == _outcome(cold)[:3]
            assert warm.discoveries == cold.discoveries
        finally:
            svc.close()
        out[side] = (_outcome(cold), _outcome(warm))
    assert out["port"] == out["jax"]


# -- corpus v2: the warm ladder (exact | near | partial) on every engine ------


@pytest.fixture(scope="module")
def partial_published(tmp_path_factory):
    """ONE mid-run cancel through a corpus service on each side: the shared
    PARTIAL entry every continuation test warm-starts from."""
    out = {}
    for side, cls, model, kw, store_cls in (
            ("jax", JaxService, J3, JAX_KW, jcorpus.CorpusStore),
            ("port", CheckService, P3, PORT_KW, pcorpus.CorpusStore)):
        d = str(tmp_path_factory.mktemp(f"corpus_partial_{side}"))
        svc = cls(corpus_dir=d, **kw)
        try:
            h = svc.submit(model)
            for _ in range(3):
                svc.pump()
            key = h._job.content_key
            h.cancel()
        finally:
            svc.close()
        entry = store_cls(d).lookup_partial(key)
        assert entry is not None and not entry.complete
        assert entry.frontier is not None and entry.frontier["lo"].size > 0
        out[side] = {"dir": d, "key": key, "entry": entry}
    _same_entry(out["port"]["entry"], out["jax"]["entry"])
    return out


def _warm_gate(entry):
    if entry.complete:
        assert pwarm.can_replay(entry, 128,
                                pcorpus.finish_signature(HasDiscoveries.ALL, None, None))
    else:
        assert pwarm.can_continue(entry, 128, HasDiscoveries.ALL, P3.properties())


def test_frontier_warm_from_partial_bit_identical(published, partial_published):
    entry = partial_published["port"]["entry"]
    _warm_gate(entry)
    cold = published["port"]["cold"]
    eng = FrontierSearch(P3, device="cpu", **ENGINE_KW)
    assert eng.warm_start(entry) == entry.states
    r = eng.run()
    ref = JaxFrontier(J3, insert_variant="pallas", **ENGINE_KW)
    assert ref.warm_start(partial_published["jax"]["entry"]) == entry.states
    rj = ref.run()
    assert (r.state_count, r.unique_state_count, r.max_depth) == (
        cold.state_count, cold.unique_state_count, cold.max_depth)
    assert r.discoveries == cold.discoveries
    assert r.detail["corpus"]["warm_kind"] == "partial"
    assert r.detail["corpus"]["preloaded_states"] == entry.states
    assert _outcome(r) == _outcome(rj) and r.detail["corpus"] == rj.detail["corpus"]


def test_resident_warm_ladder_bit_identical(published, partial_published):
    from stateright_tpu.tensor.resident import ResidentSearch as JaxResident
    from stateright_tpu_torch.tensor.resident import ResidentSearch

    complete = pcorpus.CorpusStore(published["port"]["dir"]).lookup(published["port"]["key"])
    ref_complete = jcorpus.CorpusStore(published["jax"]["dir"]).lookup(published["jax"]["key"])
    cold = published["port"]["cold"]
    _warm_gate(complete)
    for entry, ref_entry, kind in ((complete, ref_complete, "exact"),
                                   (partial_published["port"]["entry"],
                                    partial_published["jax"]["entry"], "partial")):
        eng = ResidentSearch(P3, device="cpu", **ENGINE_KW)
        eng.warm_start(entry)
        r = eng.run()
        ref = JaxResident(J3, insert_variant="pallas", **ENGINE_KW)
        ref.warm_start(ref_entry)
        rj = ref.run()
        assert (r.state_count, r.unique_state_count, r.max_depth) == (
            cold.state_count, cold.unique_state_count, cold.max_depth)
        assert r.discoveries == cold.discoveries
        assert r.detail["corpus"]["warm_kind"] == kind
        if kind == "exact":
            assert r.steps < cold.steps
        assert _outcome(r) == _outcome(rj) and r.detail["corpus"] == rj.detail["corpus"]


def test_sharded_warm_ladder_bit_identical(published, partial_published):
    from stateright_tpu.parallel.sharded import ShardedSearch as JaxSharded
    from stateright_tpu.parallel.sharded import make_mesh
    from stateright_tpu_torch.parallel import run_world
    from tests import sharded_ranks

    ours = run_world(sharded_ranks.warm_ladder, 2, published["port"]["dir"],
                     published["port"]["key"], partial_published["port"]["dir"],
                     partial_published["port"]["key"], device="cpu", timeout=300)
    assert ours[0] == ours[1]  # every rank returns the same result
    cold = published["port"]["cold"]
    refs = {}
    for kind, entry in (("exact", jcorpus.CorpusStore(published["jax"]["dir"]).lookup(
            published["jax"]["key"])), ("partial", partial_published["jax"]["entry"])):
        eng = JaxSharded(J3, insert_variant="pallas", mesh=make_mesh(2), **ENGINE_KW)
        eng.warm_start(entry)
        refs[kind] = eng.run()
    for kind, got in ours[0].items():
        rj = refs[kind]
        assert got["counts"] == (cold.state_count, cold.unique_state_count)
        assert got["max_depth"] == cold.max_depth and got["discoveries"] == cold.discoveries
        assert got["corpus"]["warm_kind"] == kind
        if kind == "exact":
            assert got["steps"] < cold.steps
        assert (got["counts"], got["steps"], got["max_depth"], got["discoveries"],
                got["corpus"]) == ((rj.state_count, rj.unique_state_count), rj.steps,
                                   rj.max_depth, rj.discoveries, rj.detail["corpus"])


def test_simulation_warm_preload_shared_table(published):
    from stateright_tpu.tensor.simulation import DeviceSimulation as JaxSimulation
    from stateright_tpu_torch.tensor.simulation import DeviceSimulation

    entry = pcorpus.CorpusStore(published["port"]["dir"]).lookup(published["port"]["key"])
    ref_entry = jcorpus.CorpusStore(published["jax"]["dir"]).lookup(published["jax"]["key"])
    kw = dict(dedup="shared", max_depth=64, traces=256, salt=7)
    sim = DeviceSimulation(P3, device="cpu", **kw)
    ref = JaxSimulation(J3, insert_variant="pallas", **kw)
    assert sim.warm_start(entry) == entry.states == ref.warm_start(ref_entry)
    r, rj = sim.run(), ref.run()
    t = sim.telemetry_summary()
    assert t["dedup_hit_rate"] > 0
    assert r.detail["corpus"]["warm_start"] is True
    assert r.detail["corpus"]["preloaded_states"] == entry.states
    assert r.unique_state_count < entry.states
    assert (r.state_count, r.unique_state_count, r.discoveries) == (
        rj.state_count, rj.unique_state_count, rj.discoveries)
    assert r.detail["corpus"] == rj.detail["corpus"] and sim.metrics() == ref.metrics()


def test_warm_knob_defined_in_exactly_one_seam():
    from stateright_tpu import knobs as jknobs
    from stateright_tpu_torch import knobs
    from stateright_tpu_torch.parallel.sharded import ShardedSearch
    from stateright_tpu_torch.service.scheduler import ServiceEngine
    from stateright_tpu_torch.tensor.resident import ResidentSearch
    from stateright_tpu_torch.tensor.simulation import DeviceSimulation

    assert knobs.check_registry() == []
    assert knobs.WARM_KINDS == jknobs.WARM_KINDS
    for cls in (FrontierSearch, ResidentSearch, ShardedSearch, DeviceSimulation,
                ServiceEngine):
        assert cls.WARM_KINDS is knobs.WARM_KINDS
        assert cls.WARM_SEAM is pwarm


def test_partial_and_family_corruption_degrade_not_wrong(tmp_path, published):
    out = {}
    for side, store_cls, corrupt in (("port", pcorpus.CorpusStore, corrupt_one_byte),
                                     ("jax", jcorpus.CorpusStore, jax_corrupt)):
        corpus_dir = str(tmp_path / side)
        shutil.copytree(published[side]["dir"], corpus_dir)
        key = published[side]["key"]
        store = store_cls(corpus_dir)
        entry = store.lookup(key)
        comp = dict(entry.components or {})
        pkey = "f" * len(key)
        assert store.publish(pkey, entry.fps[:50], entry.parents[:50],
                             {"state_count": 50, "unique_count": 50, "max_depth": 3,
                              "discoveries": {}}, complete=False, components=comp)
        corrupt(store.partial_path_for(pkey))
        assert store.lookup_partial(pkey) is None
        assert store.metrics()["corrupt_entries"] >= 1
        fam = glob.glob(os.path.join(corpus_dir, "corpus-family-*.npz*"))
        assert fam
        for f in fam:
            corrupt(f)
        assert store.family_members(comp.get("def", "")) == []
        assert store.lookup_near(comp) is None
        out[side] = {k: v for k, v in store.metrics().items() if k != "untraceable"}
    assert out["port"] == out["jax"]


def test_gc_evicts_partials_before_complete_and_supersede(tmp_path):
    fps = np.arange(1, 101, dtype=np.uint64)
    parents = np.zeros(100, dtype=np.uint64)
    meta = {"state_count": 100, "unique_count": 100, "max_depth": 5, "discoveries": {}}
    out = {}
    for side, store in zip(("port", "jax"), _store_pair(tmp_path)):
        assert store.publish("a" * 32, fps, parents, meta, complete=True)
        assert store.publish("b" * 32, fps, parents, meta, complete=False)
        m = os.path.getmtime(store.path_for("a" * 32))
        os.utime(store.partial_path_for("b" * 32), (m, m))
        total = store.gc(max_bytes=1 << 40)["bytes_total"]
        swept = store.gc(max_bytes=total - 1)
        assert swept["evicted"] == 1
        assert store.lookup_partial("b" * 32) is None
        assert store.lookup("a" * 32) is not None
        assert store.publish("c" * 32, fps, parents, meta, complete=False)
        assert os.path.exists(store.partial_path_for("c" * 32))
        before = store.metrics()["superseded_entries"]
        assert store.publish("c" * 32, fps, parents, meta, complete=True)
        assert store.metrics()["superseded_entries"] == before + 1
        assert store.lookup_partial("c" * 32) is None
        assert store.lookup("c" * 32) is not None
        out[side] = {k: v for k, v in store.metrics().items()
                     if k not in ("untraceable", "gc_bytes_freed")}
    assert out["port"] == out["jax"]


def test_near_rung_serves_another_table_packing(published, tmp_path):
    """An exact miss under another table size (same batch and finish) is
    served from the definition's family: the near rung, on both sides."""
    got = {}
    for side, cls, model, kw in (("jax", JaxService, J3, JAX_KW),
                                 ("port", CheckService, P3, PORT_KW)):
        corpus_dir = str(tmp_path / side)
        shutil.copytree(published[side]["dir"], corpus_dir)
        svc = cls(corpus_dir=corpus_dir, **dict(kw, table_log2=15))
        try:
            r = _run(svc, model).result()
            stats = _stats(svc)
        finally:
            svc.close()
        cold = published[side]["cold"]
        assert r.detail["corpus"]["warm_kind"] == "near"
        assert _outcome(r)[:3] == _outcome(cold)[:3] and r.discoveries == cold.discoveries
        assert stats["near_match_hits"] == 1
        got[side] = (_outcome(r), _corpus_detail(r), stats)
    assert got["port"] == got["jax"]


# -- interop: one entry format ---------------------------------------------------


def test_entry_files_decode_in_both_packages(published, tmp_path):
    """Each package reads the other's entry file, byte for byte the same
    visited set; the keys differ, so neither package ever serves the other's
    entry on a warm rung."""
    for src, dst_cls in (("port", jcorpus.CorpusStore), ("jax", pcorpus.CorpusStore)):
        (path,) = _entry_files(published[src]["dir"])
        d = tmp_path / src
        d.mkdir()
        shutil.copy(path, d)
        entry = dst_cls(str(d)).lookup(published[src]["key"])
        assert entry is not None and entry.complete and entry.states == GOLD_2PC3[1]
        own = (pcorpus if src == "port" else jcorpus).CorpusStore(
            published[src]["dir"]).lookup(published[src]["key"])
        _same_entry(entry, own)
        assert entry.components == own.components
    assert published["port"]["key"] != published["jax"]["key"]
    # A port service over (a copy of) the JAX corpus finds nothing to warm
    # from.
    shared = str(tmp_path / "shared")
    shutil.copytree(published["jax"]["dir"], shared)
    svc = CheckService(corpus_dir=shared, **PORT_KW)
    try:
        r = _run(svc, P3).result()
        assert r.detail["corpus"]["warm_start"] is False
    finally:
        svc.close()
