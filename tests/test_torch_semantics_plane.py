"""The verdict plane's switch, trim and upkeep on the port
(stateright_tpu_torch/semantics/): `canonical.set_enabled` / `enabled` and
the SR_TPU_SEMANTICS=legacy switch, `VerdictCache.trim`,
`serialized_from_steps`, `cached_steps` and `semantics.maintain_caches`,
held against the JAX package's on the same seeded testers: the mirrors of
tests/test_semantics_plane.py's switch and trim cases, plus the check
service calling `maintain_caches` whenever a job retires or fails, as the
JAX service does."""

import importlib
import os
import random
import subprocess
import sys

import pytest

ROOTS = {"jax": "stateright_tpu", "torch": "stateright_tpu_torch"}
SIDES = ("jax", "torch")
#: Counters the plane keeps that these tests compare between the packages
#: (the timing counters aside).
COUNTERS = ("canonical_hits", "canonical_misses", "witness_guided_hits",
            "witness_guided_misses", "full_searches", "trims", "trimmed_entries",
            "legacy_clears")


def mod(side, name=None):
    return importlib.import_module(ROOTS[side] + ("" if name is None else "." + name))


def counters(side) -> dict:
    stats = mod(side, "semantics.linearizability").verdict_cache_stats()
    return {k: stats[k] for k in COUNTERS}


@pytest.fixture(autouse=True)
def _fresh_caches():
    """Every test starts and ends with empty caches, the plane on and zeroed
    counters, in both packages."""

    def reset():
        for side in SIDES:
            mod(side, "semantics").clear_serialization_caches()
            canon = mod(side, "semantics.canonical")
            canon.set_enabled(True)
            for k in COUNTERS:
                canon.CACHE.counters[k] = 0

    reset()
    yield
    reset()


# -- seeded testers, the same in both packages -----------------------------------


def random_script(rng, n_threads, n_events, vec):
    """Recorder events (("inv", tid, op) / ("ret", tid, ret)) as
    (kind, tid, class name, args), package-free, under recorder discipline;
    a draw that records nothing is ("same", tid, None, ()), as JAX's
    `_random_chain` repeats its tester then."""
    script, inflight = [], {}
    vals = ["A", "B", "C"]
    for _ in range(n_events):
        tid = rng.randrange(n_threads)
        if tid in inflight and rng.random() < 0.7:
            op = inflight.pop(tid)
            if op == "Write":
                ret = ("WriteOk", ()) if rng.random() < 0.9 else ("WriteFail", ())
            elif op == "Read":
                ret = ("ReadOk", (rng.choice(vals + [None, "\x00"]),))
            elif op == "Push":
                ret = ("PushOk", ())
            elif op == "Pop":
                ret = ("PopOk", (rng.choice(vals + [None]),))
            else:
                ret = ("LenOk", (rng.randrange(3),))
            script.append(("ret", tid) + ret)
        elif tid not in inflight:
            if vec:
                op = rng.choice([("Push", (rng.choice(vals),)), ("Pop", ()), ("Len", ())])
            else:
                op = rng.choice([("Write", (rng.choice(vals),)), ("Read", ())])
            inflight[tid] = op[0]
            script.append(("inv", tid) + op)
        else:
            script.append(("same", tid, None, ()))
    return script


def random_cases(seed, n):
    """(tester kind, spec, script) cases, as JAX's `_random_chain` draws them."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        kind = rng.choice(["LinearizabilityTester", "SequentialConsistencyTester"])
        spec = rng.choice([("Register", ("\x00",)), ("WORegister", ()), ("VecSpec", ())])
        script = random_script(rng, rng.randrange(2, 5), rng.randrange(3, 11),
                               spec[0] == "VecSpec")
        out.append((kind, spec, script))
    return out


def chain(side, kind, spec, script):
    """The tester after each recording of `script`, the first the empty one."""
    sem = mod(side, "semantics")
    t = getattr(sem, kind)(getattr(sem, spec[0])(*spec[1]))
    out = [t]
    for rec, tid, name, args in script:
        if rec != "same":
            value = getattr(sem, name)(*args)
            t = t.on_invoke(tid, value) if rec == "inv" else t.on_return(tid, value)
        out.append(t)
    return out


def write_chain(side, n, tester="LinearizabilityTester"):
    """`n` one-write histories on threads 0..n-1: the written values keep
    their canonical classes apart (thread labels alone would collapse)."""
    sem = mod(side, "semantics")
    return [getattr(sem, tester)(sem.Register("\x00")).on_invret(i, sem.Write(f"v{i}"),
                                                                  sem.WriteOk())
            for i in range(n)]


# -- the switch ------------------------------------------------------------------


def test_witness_guided_parity_on_randomized_histories():
    """JAX test_semantics_plane.py :165-192 on both packages: every chain
    extension's plane verdict equals the raw uncached search's (taken with
    the plane off), every cached positive witness validates and rebuilds to
    a spec-valid order, and the two packages agree verdict for verdict,
    witness for witness and counter for counter."""
    verdicts = {}
    for side in SIDES:
        canon = mod(side, "semantics.canonical")
        got, checked = [], 0
        for kind, spec, script in random_cases(0xC0FFEE, 120):
            for t in chain(side, kind, spec, script):
                prev = canon.set_enabled(False)
                raw = t._serialized_uncached() is not None if t.is_valid_history else False
                canon.set_enabled(prev)
                v = canon.verdict(t)
                assert v == raw
                steps = canon.cached_steps(t)
                rebuilt = None
                if raw and t.is_valid_history and steps is not None:
                    assert canon.validate_steps(canon.canonical_form(t), steps)
                    rebuilt = canon.serialized_from_steps(t, steps)
                    assert rebuilt is not None
                got.append((v, steps is not None, None if rebuilt is None else len(rebuilt)))
                checked += 1
        assert checked > 800
        verdicts[side] = (got, counters(side))
    assert verdicts["torch"][0] == verdicts["jax"][0]
    assert verdicts["torch"][1] == verdicts["jax"][1]
    # The chains exercised guidance, not only searches.
    assert verdicts["torch"][1]["witness_guided_hits"] > 0


def test_serialized_from_steps_and_cached_steps_equal_jax():
    out = {}
    for side in SIDES:
        sem = mod(side, "semantics")
        canon = mod(side, "semantics.canonical")
        t = (sem.LinearizabilityTester(sem.Register("\x00"))
             .on_invret(0, sem.Write("B"), sem.WriteOk())
             .on_invoke(1, sem.Read())
             .on_return(1, sem.ReadOk("B")))
        assert canon.cached_steps(t) is None  # nothing cached yet
        assert canon.verdict(t) is True
        steps = canon.cached_steps(t)
        order = canon.serialized_from_steps(t, steps)
        bad = tuple(reversed(steps))
        out[side] = (steps, [(repr(op), repr(ret)) for op, ret in order],
                     canon.serialized_from_steps(t, bad))
        invalid = t.on_return(1, sem.ReadOk("B"))  # no op in flight: invalid
        assert canon.cached_steps(invalid) is None
    assert out["torch"] == out["jax"]
    assert out["torch"][2] is None  # reversed steps read before the write


@pytest.mark.parametrize("tester", ["LinearizabilityTester", "SequentialConsistencyTester"])
def test_disabled_plane_is_pure_legacy(tester):
    """JAX :340-349 on both packages, for both tester kinds: with the plane
    off no verdict enters the canonical cache, recorders stamp no
    guidance, batches take the legacy memo, and the verdicts stay."""
    out = {}
    for side in SIDES:
        sem = mod(side, "semantics")
        canon = mod(side, "semantics.canonical")
        batch = mod(side, "semantics.batch")
        assert canon.set_enabled(False) is True
        assert canon.enabled() is False
        try:
            good = getattr(sem, tester)(sem.Register("A")).on_invret(0, sem.Read(), sem.ReadOk("A"))
            bad = getattr(sem, tester)(sem.Register("A")).on_invret(0, sem.Read(), sem.ReadOk("B"))
            assert getattr(good, "_parent", None) is None
            assert getattr(good, "_delta", None) is None
            got = [good.is_consistent(), bad.is_consistent(), canon.verdict(good),
                   canon.probe_verdict(good), canon.probe_cached_negative(bad),
                   batch.evaluate_batch(write_chain(side, 3, tester) + [bad]),
                   batch.prefetch_verdicts(write_chain(side, 3, tester))]
            canon.note_verdict(bad, False)
            assert len(canon.CACHE) == 0  # the plane never engaged
        finally:
            assert canon.set_enabled(True) is False
        # Re-enabled: the same verdicts through the plane, and guidance again.
        again = getattr(sem, tester)(sem.Register("A")).on_invret(0, sem.Read(), sem.ReadOk("A"))
        assert again._parent is not None
        assert [again.is_consistent(), canon.verdict(bad)] == got[:2]
        assert len(canon.CACHE) >= 1
        out[side] = (got, counters(side))
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == [True, False, True, None, False, [True, True, True, False], 0]


def test_legacy_switch_is_read_from_the_environment():
    code = ("import sys, importlib; "
            "print(importlib.import_module(sys.argv[1] + '.semantics.canonical').enabled())")
    for side in SIDES:
        for value, want in (("legacy", "False"), ("", "True"), ("canonical", "True")):
            env = dict(os.environ, SR_TPU_SEMANTICS=value, JAX_PLATFORMS="cpu")
            proc = subprocess.run([sys.executable, "-c", code, ROOTS[side]], env=env,
                                  capture_output=True, text=True, timeout=120, check=True)
            assert proc.stdout.strip() == want, (side, value)


# -- trim and maintain_caches ----------------------------------------------------


def test_maintain_caches_bounds_long_lived_services():
    """JAX :380-395 on both packages: the canonical cache trims under the
    bound and counts it through the "semantics" REGISTRY source."""
    out = {}
    for side in SIDES:
        sem = mod(side, "semantics")
        canon = mod(side, "semantics.canonical")
        for t in write_chain(side, 40):
            assert canon.verdict(t) is True
        entries = len(canon.CACHE)
        assert entries >= 40
        res = sem.maintain_caches(max_entries=10)
        assert res["trimmed"] >= 30 and len(canon.CACHE) <= 10
        stats = mod(side, "semantics.linearizability").verdict_cache_stats()
        assert stats["trims"] >= 1 and stats["trimmed_entries"] >= 30
        assert stats["canonical_entries"] == len(canon.CACHE)
        registry = mod(side, "obs").REGISTRY
        assert any(s.startswith("semantics") for s in registry.sources())
        # Under the bound, nothing is trimmed again.
        assert sem.maintain_caches(max_entries=10) == {"trimmed": 0, "legacy_cleared": 0}
        out[side] = (entries, res, len(canon.CACHE), counters(side))
    assert out["torch"] == out["jax"]
    assert "maintain_caches" in mod("torch", "semantics").__all__
    assert mod("torch", "semantics").MAINTAIN_MAX_ENTRIES == mod("jax", "semantics").MAINTAIN_MAX_ENTRIES


def test_maintain_caches_clears_an_oversized_legacy_memo():
    """With the plane off the verdicts fill the legacy lru memos; one that
    crossed the bar is cleared whole and counted in `legacy_clears`."""
    out = {}
    for side in SIDES:
        sem = mod(side, "semantics")
        canon = mod(side, "semantics.canonical")
        lin = mod(side, "semantics.linearizability")
        sc = mod(side, "semantics.sequential_consistency")
        canon.set_enabled(False)
        for t in write_chain(side, 12) + write_chain(side, 3, "SequentialConsistencyTester"):
            assert t.is_consistent() is True
        canon.set_enabled(True)
        sizes = (lin._serialized_cached.cache_info().currsize,
                 sc._serialized_cached.cache_info().currsize)
        res = sem.maintain_caches(max_entries=8)
        after = (lin._serialized_cached.cache_info().currsize,
                 sc._serialized_cached.cache_info().currsize)
        out[side] = (sizes, res, after, counters(side))
    assert out["torch"] == out["jax"]
    assert out["torch"][:3] == ((12, 3), {"trimmed": 0, "legacy_cleared": 1}, (0, 3))
    assert out["torch"][3]["legacy_clears"] == 1


@pytest.mark.parametrize("target", [None, 3, 0])
def test_trim_drops_least_recently_used_first(target):
    out = {}
    for side in SIDES:
        canon = mod(side, "semantics.canonical")
        cache = canon.VerdictCache(max_entries=10)
        for fp in range(1, 9):
            cache.put(fp, fp % 2 == 0, None)
        cache.get(1)  # now the most recently used
        dropped = cache.trim(target)
        kept = [fp for fp in range(1, 9) if cache.get(fp) is not None]
        stats = cache.stats()
        out[side] = (dropped, kept, stats["trims"], stats["trimmed_entries"],
                     stats["canonical_entries"], cache.trim(target))
    assert out["torch"] == out["jax"]
    want_kept = {None: [1, 5, 6, 7, 8], 3: [1, 7, 8], 0: []}[target]
    assert out["torch"][:2] == (8 - len(want_kept), want_kept)
    assert out["torch"][5] == 0  # already under the target


# -- the check service calls maintain_caches when a job retires ------------------


def register_props(side):
    """The "linearizable" / "value chosen" pair of the register examples."""
    P = mod(side, "tensor").TensorProperty
    GetOk = mod(side, "actor.register").GetOk
    null = mod(side, "examples.paxos").NULL_VALUE

    def properties(view):
        lin = view.history_pred(lambda h: h.is_consistent())
        chosen = view.any_env(lambda e: isinstance(e.msg, GetOk) and e.msg.value != null)
        return [P.always("linearizable", lambda m, s: lin(s)),
                P.sometimes("value chosen", lambda m, s: chosen(s))]

    return properties


def lowered_register(side):
    """The lowered single-copy register (2 clients, 1 server): its closure
    decides every history's linearizability, filling the verdict caches."""
    model = mod(side, "examples.single_copy_register").SingleCopyModelCfg(
        client_count=2, server_count=1).into_model()
    return mod(side, "tensor.lowering").lower_actor_model(model, properties=register_props(side))


def service(side):
    if side == "jax":
        return mod(side, "service").CheckService(batch_size=64, table_log2=12,
                                                 insert_variant="pallas", background=False)
    return mod(side, "service").CheckService(batch_size=64, table_log2=12, background=False,
                                             device="cpu")


BOUND = 8


@pytest.mark.parametrize("plane", [True, False], ids=["plane", "legacy"])
def test_service_retire_keeps_the_caches_bounded(monkeypatch, plane):
    """Register jobs on a long-lived service: the lowering fills the verdict
    caches past a small bound, and each retired job trims them back under
    it (plane on: the canonical cache; plane off: the legacy memo), in the
    port as in the JAX service, on the same jobs. `runnable_groups` lists
    the job's group while it runs and none once it retired."""
    out = {}
    for side in SIDES:
        sem = mod(side, "semantics")
        canon = mod(side, "semantics.canonical")
        lin = mod(side, "semantics.linearizability")
        if side == "torch":
            monkeypatch.setattr(sem, "MAINTAIN_MAX_ENTRIES", BOUND)
        else:  # the JAX default is bound when its function is defined
            monkeypatch.setattr(sem.maintain_caches, "__defaults__", (BOUND,))
        canon.set_enabled(plane)
        lowered = lowered_register(side)
        filled = (len(canon.CACHE), lin._serialized_cached.cache_info().currsize)
        assert max(filled) > BOUND
        svc = service(side)
        try:
            rows = []
            for _ in range(3):
                h = svc.submit(lowered)
                svc.pump()
                running = [len(g.jobs) for g in svc._engine.runnable_groups()]
                svc.drain()
                r = h.result()
                rows.append((r.state_count, r.unique_state_count, sorted(r.discoveries),
                             running, svc._engine.runnable_groups(),
                             len(canon.CACHE), lin._serialized_cached.cache_info().currsize))
                assert len(canon.CACHE) <= BOUND
                assert lin._serialized_cached.cache_info().currsize <= BOUND
        finally:
            svc.close()
            canon.set_enabled(True)
        out[side] = (filled, rows, counters(side))
    assert out["torch"] == out["jax"]
    c = out["torch"][2]
    assert (c["trims"], c["legacy_clears"]) == ((1, 0) if plane else (0, 1))
    assert [row[3:5] for row in out["torch"][1]] == [([1], [])] * 3


def test_failed_job_reaches_maintain_caches(monkeypatch):
    """A job failed by its group (JAX `_fail_group`, scheduler.py:1525)
    releases the caches as a retired one does."""
    sem = mod("torch", "semantics")
    canon = mod("torch", "semantics.canonical")
    models = mod("torch", "tensor.models")
    monkeypatch.setattr(sem, "MAINTAIN_MAX_ENTRIES", BOUND)
    for t in write_chain("torch", 20):
        canon.verdict(t)
    assert len(canon.CACHE) > BOUND
    svc = service("torch")
    try:
        h = svc.submit(models.TensorTwoPhaseSys(3))
        svc.pump()
        engine = svc._engine
        assert any(g.jobs for g in engine.groups.values())
        assert engine.runnable_groups()
        engine._fail_all("failed on purpose")
        assert h.status() == "error"
        assert len(canon.CACHE) <= BOUND
        assert counters("torch")["trims"] == 1
        assert engine.runnable_groups() == []
    finally:
        svc.close()
