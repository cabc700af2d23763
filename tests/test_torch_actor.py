"""The port's host half of the actor lowering against the JAX package's:
the consistency testers (`semantics/`) give the same serializations and
verdicts on seeded register and vec histories, and the host `ActorModel`
(`actor/`) gives the same actions and successors over whole breadth-first
searches. States and actions of the two packages are different classes, so
they are compared by the stable fingerprint (`core/fingerprint.py`, which
encodes type names, not modules) and by `repr`. Exact equality throughout."""

import numpy as np
import pytest

import stateright_tpu.semantics as js
import stateright_tpu_torch.semantics as ts
from stateright_tpu.actor import Network as JNetwork
from stateright_tpu.actor.model import LossyNetwork as JLossy
from stateright_tpu.actor.test_util import PingPongCfg as JPingPongCfg
from stateright_tpu.core.fingerprint import fingerprint as jfingerprint
from stateright_tpu_torch.actor import Network as TNetwork
from stateright_tpu_torch.actor.model import LossyNetwork as TLossy
from stateright_tpu_torch.actor.test_util import PingPongCfg as TPingPongCfg
from stateright_tpu_torch.core.fingerprint import fingerprint as tfingerprint


def _register_step(pkg, rng, in_flight):
    """A random register op (invoke) or return for the chosen thread."""
    if in_flight:
        if rng.random() < 0.5:
            return pkg.WriteOk()
        return pkg.ReadOk(int(rng.integers(0, 3)) or None)
    return pkg.Write(int(rng.integers(1, 3))) if rng.random() < 0.5 else pkg.Read()


def _vec_step(pkg, rng, in_flight):
    if in_flight:
        r = rng.random()
        if r < 0.4:
            return pkg.PushOk()
        if r < 0.8:
            return pkg.PopOk(int(rng.integers(0, 3)) or None)
        return pkg.LenOk(int(rng.integers(0, 3)))
    r = rng.random()
    if r < 0.5:
        return pkg.Push(int(rng.integers(1, 3)))
    return pkg.Pop() if r < 0.8 else pkg.Len()


def _history(pkg, tester_cls, spec, step, seed, n_threads, n_events):
    """The same seeded recording sequence on `pkg`'s tester: each event picks
    a thread and either invokes (no op in flight) or returns."""
    rng = np.random.default_rng(seed)
    t = tester_cls(spec)
    for _ in range(n_events):
        tid = int(rng.integers(0, n_threads))
        if tid in t.in_flight_by_thread:
            t = t.on_return(tid, step(pkg, rng, True))
        else:
            t = t.on_invoke(tid, step(pkg, rng, False))
    return t


@pytest.mark.parametrize("kind", ["register", "vec"])
@pytest.mark.parametrize("name", ["LinearizabilityTester", "SequentialConsistencyTester"])
def test_testers_equal_jax_on_seeded_histories(name, kind):
    """40 seeded histories per tester and spec, 3 threads, 3-9 recordings:
    the same witness (or None) from `serialized_history()` and the same
    `is_consistent()` verdict (the dedup-first plane) as the JAX tester."""
    step = _register_step if kind == "register" else _vec_step
    verdicts = set()
    for seed in range(40):
        n_events = 3 + seed % 7
        hist = []
        for pkg in (js, ts):
            spec = pkg.Register() if kind == "register" else pkg.VecSpec()
            tester = _history(pkg, getattr(pkg, name), spec, step, seed, 3, n_events)
            hist.append((repr(tester.serialized_history()), tester.is_consistent(),
                         len(tester), tester.is_valid_history))
        assert hist[0] == hist[1], (seed, hist)
        verdicts.add(hist[1][1])
    assert verdicts == {True, False}  # both verdicts were exercised


def _bfs_pairs(model, fingerprint, limit=5000):
    """(state fingerprint, [(repr(action), successor fingerprint or None)])
    for every state of a breadth-first search of a host model, in visit
    order."""
    init = model.init_states()
    seen = {fingerprint(s) for s in init}
    queue = list(init)
    out = []
    while queue and len(out) < limit:
        s = queue.pop(0)
        acts = []
        model.actions(s, acts)
        row = []
        for a in acts:
            ns = model.next_state(s, a)
            row.append((repr(a), None if ns is None else fingerprint(ns)))
            if ns is not None and model.within_boundary(ns):
                fp = fingerprint(ns)
                if fp not in seen:
                    seen.add(fp)
                    queue.append(ns)
        out.append((fingerprint(s), row))
    return out


@pytest.mark.parametrize(
    "lossy,network",
    [(True, None), (False, "unordered_nonduplicating"), (False, "ordered"),
     (True, "ordered"), (False, None)],
)
def test_host_actor_model_equals_jax_over_a_bfs(lossy, network):
    """Ping-pong (max_nat 3, with history): the same actions, in the same
    order, and the same successors over the whole search, for each network
    kind, lossy and lossless."""

    def build(cfg_cls, net_cls, lossy_cls):
        m = cfg_cls(max_nat=3, maintains_history=True).into_model()
        m = m.with_lossy_network(lossy_cls.YES if lossy else lossy_cls.NO)
        if network is not None:
            m = m.with_init_network(getattr(net_cls, f"new_{network}")())
        return m

    j = _bfs_pairs(build(JPingPongCfg, JNetwork, JLossy), jfingerprint)
    t = _bfs_pairs(build(TPingPongCfg, TNetwork, TLossy), tfingerprint)
    assert len(j) > 5
    assert t == j
    jm = build(JPingPongCfg, JNetwork, JLossy)
    tm = build(TPingPongCfg, TNetwork, TLossy)
    assert [p.name for p in tm.properties()] == [p.name for p in jm.properties()]
    js0, ts0 = jm.init_states()[0], tm.init_states()[0]
    for jp, tp in zip(jm.properties(), tm.properties()):
        assert tp.condition(tm, ts0) == jp.condition(jm, js0)


@pytest.mark.parametrize("example", ["paxos", "single_copy_register", "abd", "timers"])
def test_host_examples_equal_jax_over_a_bfs(example):
    """The copied examples (1-client Paxos, the single-copy and ABD
    registers, the timer pingers) give the same search, first 1,500 states."""
    import importlib

    from stateright_tpu_torch.actor import Network as TN

    def build(root, net):
        mod = importlib.import_module(f"{root}.examples.{example}")
        if example == "paxos":
            return mod.PaxosModelCfg(client_count=1, server_count=3).into_model()
        if example == "single_copy_register":
            return mod.SingleCopyModelCfg(client_count=2, server_count=1).into_model()
        if example == "abd":
            return mod.AbdModelCfg(2, 2, network=net.new_ordered()).into_model()
        return mod.PingerModelCfg(
            server_count=2, network=net.new_unordered_nonduplicating()
        ).into_model()

    j = _bfs_pairs(build("stateright_tpu", JNetwork), jfingerprint, limit=1500)
    t = _bfs_pairs(build("stateright_tpu_torch", TN), tfingerprint, limit=1500)
    assert len(j) > 20
    assert t == j
