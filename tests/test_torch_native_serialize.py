"""The port's native serializer bridge (stateright_tpu_torch/_native/ and
semantics/_native_bridge.py) on the CPU: the mirrors of the four tests of
tests/test_native_serialize.py, held against the port's own Python search and
against the JAX package's native steps on the same seeded histories, plus a
failed compile that raises, the canonical plane's `search_steps` and
`evaluate_batch` against the JAX package.

Every differential case asserts that the native path ran, by the bridge's
`native_searches()` counter: an `isinstance` against a class of the wrong
package would silently answer NOT_SUPPORTED and leave both sides equal."""

import random

import pytest

import stateright_tpu.semantics as jsem
import stateright_tpu.semantics.vec as jvec
from stateright_tpu.semantics import _native_bridge as jbridge
from stateright_tpu.semantics import batch as jbatch
from stateright_tpu.semantics import canonical as jcanon
import stateright_tpu_torch.semantics as psem
import stateright_tpu_torch.semantics.vec as pvec
from stateright_tpu_torch import _native
from stateright_tpu_torch.semantics import _native_bridge as pbridge
from stateright_tpu_torch.semantics import batch as pbatch
from stateright_tpu_torch.semantics import canonical as pcanon

TESTERS = {"linearizable": "LinearizabilityTester", "sequential": "SequentialConsistencyTester"}


@pytest.fixture(autouse=True)
def _always_native(monkeypatch):
    """Take the native path even on tiny histories (the testers gate it
    behind NATIVE_MIN_OPS because marshalling loses below that)."""
    monkeypatch.setattr(pbridge, "NATIVE_MIN_OPS", 0)


def _python_only(tester, monkeypatch):
    """The port's uncached search with the native path off."""
    with monkeypatch.context() as m:
        m.setattr(pbridge, "native_serialized_history",
                  lambda *a, **k: pbridge.NOT_SUPPORTED)
        return tester._serialized_uncached()


def _jax_native_steps(t, linearizable):
    return jbridge.native_serialize_steps(
        t.init_ref_obj, t.history_by_thread, t.in_flight_by_thread,
        linearizable=linearizable, min_ops=0)


def _port_native_steps(t, linearizable):
    return pbridge.native_serialize_steps(
        t.init_ref_obj, t.history_by_thread, t.in_flight_by_thread,
        linearizable=linearizable, min_ops=0)


def _register_script(rng):
    """(tid, op or ret) events under valid recorder discipline: invoke and
    return alternate per thread."""
    script, pending = [], {}
    for _ in range(rng.randrange(2, 9)):
        tid = rng.randrange(3)
        if tid in pending:
            op = pending.pop(tid)
            if op[0] == "write":
                script.append(("ret", tid, ("write_ok",)))
            else:
                script.append(("ret", tid, ("read_ok", rng.choice(["A", "B", None]))))
        else:
            op = ("write", rng.choice(["A", "B"])) if rng.random() < 0.6 else ("read",)
            script.append(("inv", tid, op))
            pending[tid] = op
    return script


def _vec_script(rng):
    script, pending = [], {}
    for _ in range(rng.randrange(2, 8)):
        tid = rng.randrange(2)
        if tid in pending:
            op = pending.pop(tid)
            if op[0] == "push":
                ret = ("push_ok",)
            elif op[0] == "pop":
                ret = ("pop_ok", rng.choice(["x", "y", None]))
            else:
                ret = ("len_ok", rng.randrange(3))
            script.append(("ret", tid, ret))
        else:
            r = rng.random()
            op = ("push", rng.choice(["x", "y"])) if r < 0.5 else (("pop",) if r < 0.8 else ("len",))
            script.append(("inv", tid, op))
            pending[tid] = op
    return script


def _value(sem, vec, word):
    kind = word[0]
    return {
        "write": lambda: sem.Write(word[1]), "read": lambda: sem.Read(),
        "write_ok": lambda: sem.WriteOk(), "read_ok": lambda: sem.ReadOk(word[1]),
        "push": lambda: vec.Push(word[1]), "pop": lambda: vec.Pop(), "len": lambda: vec.Len(),
        "push_ok": lambda: vec.PushOk(), "pop_ok": lambda: vec.PopOk(word[1]),
        "len_ok": lambda: vec.LenOk(word[1]),
    }[kind]()


def _play(sem, vec, tester_cls, spec, script):
    t = getattr(sem, tester_cls)(spec)
    for what, tid, word in script:
        v = _value(sem, vec, word)
        t = t.on_invoke(tid, v) if what == "inv" else t.on_return(tid, v)
    return t


SPECS = {
    "register_A": (lambda s: s.Register("A")),
    "wo_register": (lambda s: s.WORegister()),
    "register_None": (lambda s: s.Register(None)),
}


def _differential(monkeypatch, tester_cls, make_spec, make_script, seed, trials):
    rng = random.Random(seed)
    outcomes = set()
    before = pbridge.native_searches()
    for trial in range(trials):
        script = make_script(rng)
        t = _play(psem, pvec, tester_cls, make_spec(psem), script)
        jt = _play(jsem, jvec, tester_cls, make_spec(jsem), script)
        native = t._serialized_uncached()
        python = _python_only(t, monkeypatch)
        assert native == python, (trial, t, native, python)
        lin = tester_cls == "LinearizabilityTester"
        assert _port_native_steps(t, lin) == _jax_native_steps(jt, lin), (trial, t)
        outcomes.add(python is None)
    # Each trial ran the C++ search twice (the tester, the steps).
    assert pbridge.native_searches() - before == 2 * trials
    assert outcomes == {True, False}  # both verdicts exercised


@pytest.mark.parametrize("tester_cls", list(TESTERS.values()), ids=list(TESTERS))
@pytest.mark.parametrize("spec", list(SPECS), ids=list(SPECS))
def test_differential_register(monkeypatch, tester_cls, spec):
    _differential(monkeypatch, tester_cls, SPECS[spec], _register_script, 12345, 400)


@pytest.mark.parametrize("tester_cls", list(TESTERS.values()), ids=list(TESTERS))
def test_differential_vec(monkeypatch, tester_cls):
    _differential(monkeypatch, tester_cls, lambda s: pvec.VecSpec() if s is psem else jvec.VecSpec(),
                  _vec_script, 999, 300)


def test_unsupported_spec_falls_back():
    """A custom SequentialSpec takes the Python path and still works, on
    both packages alike; the C++ search never runs for it."""
    got = {}
    for name, sem in (("port", psem), ("jax", jsem)):
        class Counter(sem.SequentialSpec):
            def __init__(self, n=0):
                self.n = n

            def invoke(self, op):
                return self.n + 1, Counter(self.n + 1)

            def __eq__(self, other):
                return isinstance(other, Counter) and self.n == other.n

            def __hash__(self):
                return hash(("Counter", self.n))

        t = sem.LinearizabilityTester(Counter()).on_invoke(0, "inc").on_return(0, 1)
        before = pbridge.native_searches()
        got[name] = t.serialized_history()
        assert pbridge.native_searches() == before
    assert got["port"] == got["jax"] == [("inc", 1)]
    assert pbridge.native_serialize_steps(
        object(), {0: ()}, {}, linearizable=True, min_ops=0) is pbridge.NOT_SUPPORTED


def test_in_flight_ops_optional():
    """In-flight ops may or may not take effect (ref: linearizability.rs:203-208)."""
    for sem in (psem, jsem):
        t = sem.LinearizabilityTester(sem.Register("A"))
        t = t.on_invoke(0, sem.Write("B"))  # in flight, never returns
        t = t.on_invoke(1, sem.Read()).on_return(1, sem.ReadOk("B"))
        assert t._serialized_uncached() is not None  # write took effect
        t2 = sem.LinearizabilityTester(sem.Register("A"))
        t2 = t2.on_invoke(0, sem.Write("B"))
        t2 = t2.on_invoke(1, sem.Read()).on_return(1, sem.ReadOk("A"))
        assert t2._serialized_uncached() is not None  # write did not take effect
    ours, theirs = (
        sem.LinearizabilityTester(sem.Register("A")).on_invoke(0, sem.Write("B"))
        .on_invoke(1, sem.Read()).on_return(1, sem.ReadOk("A"))
        for sem in (psem, jsem))
    before = pbridge.native_searches()
    assert _port_native_steps(ours, True) == _jax_native_steps(theirs, True) == [(1, False)]
    assert pbridge.native_searches() == before + 1
    # A tester of the other package's classes is not one the bridge encodes.
    assert _port_native_steps(theirs, True) is pbridge.NOT_SUPPORTED


# -- the port's own cases -----------------------------------------------------


def test_failed_compile_raises(monkeypatch, tmp_path):
    """A failed g++ build raises with the compiler's stderr (the JAX package
    answers None and falls back to Python); no partial object is left."""
    (tmp_path / "broken.cpp").write_text("int broken( { return 0; }\n")
    monkeypatch.setattr(_native, "_DIR", tmp_path)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build broken.cpp") as e:
        _native.load("broken")
    assert "error" in str(e.value)
    assert list((tmp_path / "_build").iterdir()) == []


def test_library_is_built_into_the_ports_build_directory():
    lib = _native.load("serialize")
    path = _native.build("serialize")
    assert lib._name == str(path)
    assert path.parent == _native.BUILD_DIR
    assert path.parent.parent.name == "stateright_tpu_torch"


def _batch_scripts(seed, n, threads=2):
    """Register histories of the plane's native gate to two ops past it
    (completed + in flight) over `threads` threads, under recorder
    discipline. (Over 3 threads a few sequential-consistency histories of
    this length take the Python search seconds.)"""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        n_ops = pcanon.PLANE_NATIVE_MIN_OPS + rng.randrange(3)
        script, pending, invoked = [], {}, 0
        while invoked < n_ops or (pending and rng.random() < 0.7):
            tid = rng.randrange(threads)
            if tid in pending:
                op = pending.pop(tid)
                script.append(("ret", tid, ("write_ok",) if op[0] == "write"
                               else ("read_ok", rng.choice(["A", "B", None]))))
            elif invoked < n_ops:
                op = ("write", rng.choice(["A", "B"])) if rng.random() < 0.6 else ("read",)
                script.append(("inv", tid, op))
                pending[tid] = op
                invoked += 1
        out.append(script)
    return out


def test_search_steps_takes_the_native_path_like_the_jax_package():
    scripts = _batch_scripts(7, 60)
    before = pbridge.native_searches()
    for script in scripts:
        for tester_cls, lin in (("LinearizabilityTester", True),
                                ("SequentialConsistencyTester", False)):
            t = _play(psem, pvec, tester_cls, psem.Register("A"), script)
            jt = _play(jsem, jvec, tester_cls, jsem.Register("A"), script)
            form, jform = pcanon.canonical_form(t), jcanon.canonical_form(jt)
            assert form.fp == jform.fp
            steps = pcanon.search_steps(form)
            assert steps == jcanon.search_steps(jform)
            remaining = {i: tuple(enumerate(form.history[i])) for i in range(len(form.history))}
            python = pcanon._serialize_steps([], form.spec, remaining, form.in_flight)
            assert steps == (None if python is None else tuple(python))
    assert pbridge.native_searches() - before == 2 * len(scripts)


def test_evaluate_batch_matches_the_jax_package():
    """`evaluate_batch` on roots past the plane's gate: each full search
    runs in C++, serially (the port keeps no pool: it was slower than the
    serial loop on the card's host), and the verdicts and the full-search
    count are those of the JAX package's `evaluate_batch(parallel=True)`
    and `parallel=False`; no search is counted as pooled."""
    scripts = _batch_scripts(11, 40)
    got = {}
    for side, sem, batch, canon, clear, kwargs in (
            ("port", psem, pbatch, pcanon, psem.clear_serialization_caches, {}),
            ("jax", jsem, jbatch, jcanon, jsem.clear_serialization_caches,
             {"parallel": True}),
            ("jax serial", jsem, jbatch, jcanon, jsem.clear_serialization_caches,
             {"parallel": False})):
        testers = [_play(sem, pvec if sem is psem else jvec, "LinearizabilityTester",
                         sem.Register("A"), s) for s in scripts]
        clear()
        c0 = dict(canon.CACHE.counters)
        native0 = pbridge.native_searches()
        verdicts = batch.evaluate_batch(testers, **kwargs)
        c1 = dict(canon.CACHE.counters)
        got[side] = (verdicts, c1["full_searches"] - c0["full_searches"])
        if side == "port":
            assert pbridge.native_searches() - native0 == got[side][1] >= 2
            assert c1["batch_parallel_evals"] == c0["batch_parallel_evals"]
        if side == "jax":
            assert c1["batch_parallel_evals"] - c0["batch_parallel_evals"] >= 2
    assert got["port"] == got["jax"] == got["jax serial"]
    assert set(got["port"][0]) == {True, False}


def test_evaluate_batch_keeps_searches_below_the_gate_in_python():
    """Roots below the plane's native gate are searched in Python: no C++
    search, and the verdicts are the JAX package's."""
    rng = random.Random(5)
    scripts = []
    while len(scripts) < 30:
        script = _register_script(rng)
        if sum(what == "inv" for what, _, _ in script) < pcanon.PLANE_NATIVE_MIN_OPS:
            scripts.append(script)
    got = {}
    for side, sem, batch, canon, clear in (
            ("port", psem, pbatch, pcanon, psem.clear_serialization_caches),
            ("jax", jsem, jbatch, jcanon, jsem.clear_serialization_caches)):
        testers = [_play(sem, pvec if sem is psem else jvec, "LinearizabilityTester",
                         sem.Register("A"), s) for s in scripts]
        clear()
        c0 = dict(canon.CACHE.counters)
        native0 = pbridge.native_searches()
        got[side] = batch.evaluate_batch(testers)
        c1 = dict(canon.CACHE.counters)
        if side == "port":
            assert c1["full_searches"] - c0["full_searches"] >= 2
            assert pbridge.native_searches() == native0
    assert got["port"] == got["jax"]
    assert set(got["port"]) == {True, False}
