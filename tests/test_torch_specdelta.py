"""The port's Spec-CI definition-delta salvage (stateright_tpu_torch/store/
specdelta.py and the delta rung of service/scheduler.py) on the CPU: the
mirrors of the 8 tests of tests/test_specdelta.py, each holding the port
against the JAX package on the same inputs, and the port's own traced
digest (torch.fx `make_fx` in place of a jaxpr): stable across equal
instances, distinct across models, and refused, never guessed, where the
trace cannot follow a component.

Compared exactly: edit classes, reuse counts, counts, depth, the rung and
edit class served, discoveries and the delta counters. The JAX module's
slow mark is kept (`test_specdelta.py:249`)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from stateright_tpu.service import CheckService as JaxService
from stateright_tpu.store import specdelta as jdelta
from stateright_tpu.store.corpus import CorpusStore as JaxStore
from stateright_tpu.tensor import models as jm
from stateright_tpu_torch.service import CheckService
from stateright_tpu_torch.store import specdelta
from stateright_tpu_torch.store.corpus import CorpusStore, model_def_hash
from stateright_tpu_torch.tensor import models as pm

GOLD_2PC3 = (1_146, 288)

J3, P3 = jm.TensorTwoPhaseSys(3), pm.TensorTwoPhaseSys(3)

SVC_KW = dict(batch_size=128, table_log2=14, store="tiered", high_water=0.85,
              summary_log2=16, background=False)
JAX_KW = dict(SVC_KW, insert_variant="pallas")
PORT_KW = dict(SVC_KW, device="cpu")


def _run(svc, model, **opts):
    h = svc.submit(model, **opts)
    svc.drain(timeout=600)
    return h


def _property_edit(base_cls):
    """Negate the first (SOMETIMES) property's condition: the one-line edit.
    The subclass keeps the base's name (the geometry digest holds it)."""

    def _props(self, _base=base_cls):
        props = list(_base.properties(self))
        p0 = props[0]
        props[0] = dataclasses.replace(
            p0, name=p0.name + " flipped",
            condition=lambda model, s, _c=p0.condition: ~_c(model, s))
        return props

    return type(base_cls.__name__, (base_cls,), {"properties": _props})


def _jax_expand_edit(base_cls):
    """Mask the last action: a semantic transition edit (JAX form)."""

    def _expand(self, states, _base=base_cls):
        succs, valid = _base.expand(self, states)
        return succs, valid.at[:, -1].set(False)

    return type(base_cls.__name__, (base_cls,), {"expand": _expand})


def _expand_edit(base_cls):
    """The same edit in torch."""

    def _expand(self, states, _base=base_cls):
        succs, valid = _base.expand(self, states)
        valid = valid.clone()
        valid[:, -1] = False
        return succs, valid

    return type(base_cls.__name__, (base_cls,), {"expand": _expand})


def _vec(**over):
    base = {"geometry": "g", "init": "i", "expand": "e", "boundary": "b", "repr": "r",
            "props": {"p": "1", "q": "2"}}
    base.update(over)
    return base


def _both(fn, *args):
    """The port's answer, held equal to the JAX module's."""
    got = getattr(specdelta, fn)(*args)
    assert got == getattr(jdelta, fn)(*args), (fn, args)
    return got


# -- classification (host-only digest diffs) -----------------------------------


def test_classify_names_edit_classes():
    assert _both("classify", _vec(), _vec()) == "identical"
    assert _both("classify", _vec(props={"p": "9", "q": "2"}), _vec()) == "properties-only"
    assert _both("classify", _vec(props={"p": "1"}), _vec()) == "properties-only"
    assert _both("classify", _vec(boundary="B2"), _vec()) == "boundary-only"
    for part in ("geometry", "init", "expand", "repr"):
        assert _both("classify", _vec(**{part: "X"}), _vec()) == "expand/init"
    assert _both("classify", _vec(boundary="B2", props={"p": "9", "q": "2"}),
                 _vec()) == "expand/init"


def test_classify_pre_delta_or_corrupt_never_misclassifies():
    new = _vec()
    for old in (None, "not-a-dict", 7, {}, {"props": None}, _vec(props="truncated"),
                _vec(boundary=None), _vec(boundary=""),
                {k: v for k, v in _vec().items() if k != "expand"}):
        assert _both("classify", new, old) == "expand/init"
    assert _both("classify", {"props": None}, _vec()) == "expand/init"


def test_component_reuse_counts_unchanged_digests():
    assert _both("component_reuse", _vec(), _vec()) == 7
    assert _both("component_reuse", _vec(props={"p": "9", "q": "2"}), _vec()) == 6
    assert _both("component_reuse", _vec(expand="X"), _vec()) == 6


# -- component digests (traced graphs) ---------------------------------------------


def test_component_digests_address_the_edit():
    m2 = pm.TensorTwoPhaseSys(2)
    comps = specdelta.def_components(m2)
    assert set(comps) >= {"geometry", "init", "expand", "boundary", "repr", "props"}
    assert specdelta.joint_def_hash(comps) == model_def_hash(m2)
    # A pass-through override traces to the same graph: an exact hit.
    passthrough = type("TensorTwoPhaseSys", (pm.TensorTwoPhaseSys,),
                       {"expand": lambda self, s: pm.TensorTwoPhaseSys.expand(self, s)})(2)
    assert specdelta.classify(specdelta.def_components(passthrough), comps) == "identical"
    prop_comps = specdelta.def_components(_property_edit(pm.TensorTwoPhaseSys)(2))
    assert specdelta.classify(prop_comps, comps) == "properties-only"
    assert prop_comps["expand"] == comps["expand"]
    exp_comps = specdelta.def_components(_expand_edit(pm.TensorTwoPhaseSys)(2))
    assert specdelta.classify(exp_comps, comps) == "expand/init"
    assert exp_comps["props"] == comps["props"] and exp_comps["expand"] != comps["expand"]
    # The JAX package classifies the same edits the same way.
    jcomps = jdelta.def_components(jm.TensorTwoPhaseSys(2))
    assert jdelta.classify(jdelta.def_components(
        _property_edit(jm.TensorTwoPhaseSys)(2)), jcomps) == "properties-only"
    assert jdelta.classify(jdelta.def_components(
        _jax_expand_edit(jm.TensorTwoPhaseSys)(2)), jcomps) == "expand/init"


# -- service integration: the edit loop on one shared corpus -------------------


@pytest.fixture(scope="module")
def delta_corpus(tmp_path_factory):
    """ONE cold publish and the never-warmed expand-edit reference, on each
    side."""
    out = {}
    for side, cls, model, exp_model, kw in (
            ("jax", JaxService, J3, _jax_expand_edit(jm.TensorTwoPhaseSys)(3), JAX_KW),
            ("port", CheckService, P3, _expand_edit(pm.TensorTwoPhaseSys)(3), PORT_KW)):
        corpus_dir = str(tmp_path_factory.mktemp(f"specci-{side}"))
        svc = cls(corpus_dir=corpus_dir, **kw)
        cold = _run(svc, model).result()
        svc.close()
        assert (cold.state_count, cold.unique_state_count) == GOLD_2PC3
        assert (cold.detail["corpus"] or {}).get("published")
        ref_svc = cls(**kw)  # corpus-less: what a cold run says
        exp_ref = _run(ref_svc, exp_model).result()
        ref_svc.close()
        out[side] = (corpus_dir, cold, exp_ref)
    return out


def _outcome(r):
    return (r.state_count, r.unique_state_count, r.max_depth, r.complete,
            sorted(r.discoveries.items()))


def _delta_stats(svc):
    s = svc.stats()["corpus"]
    return {k: s[k] for k in ("delta_hits", "delta_refusals", "component_reuse", "hits",
                              "misses", "publishes")}


def test_property_edit_takes_delta_rung_bit_identical(delta_corpus):
    got = {}
    for side, cls, model, kw in (("jax", JaxService, _property_edit(jm.TensorTwoPhaseSys)(3),
                                  JAX_KW),
                                 ("port", CheckService, _property_edit(pm.TensorTwoPhaseSys)(3),
                                  PORT_KW)):
        corpus_dir, cold, _exp = delta_corpus[side]
        svc = cls(corpus_dir=corpus_dir, **kw)
        r = _run(svc, model).result()
        got[side] = (_outcome(r), {k: v for k, v in r.detail["corpus"].items() if k != "key"},
                     _delta_stats(svc))
        svc.close()
        corpus = r.detail["corpus"]
        assert corpus["warm_kind"] == "delta" and corpus["delta_class"] == "properties-only"
        assert (r.state_count, r.unique_state_count) == GOLD_2PC3
        assert r.max_depth == cold.max_depth and r.complete
        assert "abort agreement flipped" in r.discoveries
        assert r.discoveries["commit agreement"] == cold.discoveries["commit agreement"]
        assert got[side][2]["delta_hits"] >= 1 and got[side][2]["component_reuse"] >= 1
        assert not corpus.get("published")
    assert got["port"] == got["jax"]


def test_expand_edit_refuses_salvage_and_runs_cold(delta_corpus):
    got = {}
    for side, cls, model, kw in (("jax", JaxService, _jax_expand_edit(jm.TensorTwoPhaseSys)(3),
                                  JAX_KW),
                                 ("port", CheckService, _expand_edit(pm.TensorTwoPhaseSys)(3),
                                  PORT_KW)):
        corpus_dir, _cold, exp_ref = delta_corpus[side]
        svc = cls(corpus_dir=corpus_dir, **kw)
        r = _run(svc, model).result()
        stats = _delta_stats(svc)
        svc.close()
        assert "warm_kind" not in r.detail["corpus"]
        assert stats["delta_refusals"] >= 1 and stats["delta_hits"] == 0
        assert _outcome(r) == _outcome(exp_ref)
        got[side] = (_outcome(r), stats)
    assert got["port"] == got["jax"]


@pytest.mark.slow
def test_simulation_coverage_publish_accumulates(tmp_path):
    from stateright_tpu.store.corpus import key_components as jax_key_components
    from stateright_tpu.tensor.simulation import DeviceSimulation as JaxSimulation
    from stateright_tpu_torch.store.corpus import key_components
    from stateright_tpu_torch.tensor.simulation import DeviceSimulation

    got = {}
    for side, sim_cls, store_cls, kc, model, extra, variant in (
            ("jax", JaxSimulation, JaxStore, jax_key_components, J3,
             dict(insert_variant="pallas"), "pallas"),
            ("port", DeviceSimulation, CorpusStore, key_components, P3, dict(device="cpu"),
             "pallas")):
        store = store_cls(str(tmp_path / side))
        kw = dict(traces=256, max_depth=64, dedup="shared", table_log2=14, walks=512, **extra)
        sim = sim_cls(model, salt=7, **kw)
        sim.run()
        assert sim.publish_coverage(store)
        lowering = {"engine": "simulation", "dedup": "shared", "table_log2": 14,
                    "insert_variant": variant, "batch_size": 0, "finish": None}
        entry = store.lookup_family(kc(model, lowering)["def"])
        assert entry is not None and not entry.complete and entry.frontier is None
        sim2 = sim_cls(model, seed=99, salt=13, **kw)
        preloaded = sim2.warm_start(entry)
        assert preloaded == entry.fps.size > 0
        sim2.run()
        met = sim2.metrics()
        assert met["dedup_hits"] > 0 and met["unique"] < preloaded
        got[side] = (sorted(entry.fps.tolist()), sorted(entry.parents.tolist()), entry.meta,
                     preloaded, met)
    assert got["port"] == got["jax"]


def test_corrupt_spec_index_degrades_to_cold(delta_corpus, tmp_path):
    import shutil

    from stateright_tpu.faults.ckptio import fenced_savez as jax_fenced_savez
    from stateright_tpu_torch.faults.ckptio import fenced_savez

    got = {}
    for side, cls, store_cls, delta, model, edited, save, kw in (
            ("jax", JaxService, JaxStore, jdelta, J3, _property_edit(jm.TensorTwoPhaseSys)(3),
             jax_fenced_savez, JAX_KW),
            ("port", CheckService, CorpusStore, specdelta, P3,
             _property_edit(pm.TensorTwoPhaseSys)(3), fenced_savez, PORT_KW)):
        corpus_dir = str(tmp_path / side)
        shutil.copytree(delta_corpus[side][0], corpus_dir)
        store = store_cls(corpus_dir)
        core = delta.spec_core_hash(delta.def_components(model))
        members = store.spec_members(core)
        assert members, "the cold publish never indexed the spec family"
        for m in members:
            m["comps"] = None
        save(store._spec_path(core),
             {"members": np.asarray([json.dumps(members)], dtype=np.str_)})
        svc = cls(corpus_dir=corpus_dir, **kw)
        r = _run(svc, edited).result()
        stats = _delta_stats(svc)
        svc.close()
        assert "warm_kind" not in r.detail["corpus"]
        assert stats["delta_hits"] == 0 and stats["delta_refusals"] >= 1
        assert (r.state_count, r.unique_state_count) == GOLD_2PC3
        assert "abort agreement flipped" in r.discoveries
        got[side] = (_outcome(r), stats)
    assert got["port"] == got["jax"]


# -- the port's traced digest ----------------------------------------------------


def _models():
    from stateright_tpu_torch.tensor import TensorPaxos

    return {
        "2pc3": lambda: pm.TensorTwoPhaseSys(3),
        "2pc3-sym": lambda: pm.TensorTwoPhaseSys(3, symmetry=True),
        "2pc4": lambda: pm.TensorTwoPhaseSys(4),
        "paxos2": lambda: TensorPaxos(2),
        "increment3": lambda: pm.TensorIncrement(3),
        "inclock3": lambda: pm.TensorIncrementLock(3),
        "raft3": lambda: pm.TensorRaft(3),
        "lineq": lambda: pm.TensorLinearEquation(2, 10, 14),
    }


def test_every_model_traces_to_a_stable_distinct_definition():
    hashes = {}
    for name, build in _models().items():
        a, b = build(), build()
        comps = specdelta.def_components(a)
        assert comps == specdelta.def_components(b), name  # equal instances, one key
        assert (comps["repr"] != "") == (a.representative is not None), name
        hashes[name] = model_def_hash(a)
    assert len(set(hashes.values())) == len(hashes)


def test_digest_holds_the_constants_and_ignores_the_device_cache():
    """The code of a graph names its constants without their values, so the
    values are digested too; and the trace runs on the CPU whatever device
    the model's constant cache already holds."""

    class Table(pm.TensorLinearEquation):
        def _constants(self, device):
            return {"t": torch.tensor([self.c, 7, 9], device=device)}

        def properties(self):
            return [type(pm.TensorLinearEquation.properties(self)[0])(
                pm.TensorLinearEquation.properties(self)[0].expectation, "in table",
                lambda m, s: (s[:, :1] == m.constants(s.device)["t"]).any(1))]

    a, b = Table(2, 10, 14), Table(2, 10, 15)
    ca, cb = specdelta.def_components(a), specdelta.def_components(b)
    assert ca["expand"] == cb["expand"] and ca["props"] != cb["props"]
    c = Table(2, 10, 14)
    c.constants("meta")  # a cache for another device changes nothing
    assert specdelta.def_components(c) == ca


class _Branchy(pm.TensorTwoPhaseSys):
    """An expand that branches on a tensor's value."""

    def expand(self, states):
        if bool((states[:, 0] > 0).any()):
            return pm.TensorTwoPhaseSys.expand(self, states)
        return pm.TensorTwoPhaseSys.expand(self, states)


class _HostEscape(pm.TensorTwoPhaseSys):
    """A property that leaves torch for numpy: its values would be the
    probe's constants."""

    def properties(self):
        props = list(pm.TensorTwoPhaseSys.properties(self))
        p0 = props[0]
        props[0] = dataclasses.replace(
            p0, condition=lambda m, s: torch.from_numpy(s.numpy()[:, 0] > 1))
        return props


@pytest.mark.parametrize("cls", [_Branchy, _HostEscape], ids=["branch", "host-escape"])
def test_untraceable_component_runs_cold_unpublished_and_counted(cls, tmp_path):
    with pytest.raises(specdelta.Untraceable):
        specdelta.def_components(cls(3))
    svc = CheckService(corpus_dir=str(tmp_path), **PORT_KW)
    try:
        r = _run(svc, cls(3)).result()
        stats = svc.stats()["corpus"]
    finally:
        svc.close()
    assert (r.state_count, r.unique_state_count) == GOLD_2PC3
    assert "corpus" not in r.detail  # no key: nothing warmed, nothing published
    assert stats["untraceable"] == 1 and stats["publishes"] == 0
    assert stats["hits"] == stats["misses"] == 0


def _boundary_edit(base_cls):
    """A boundary that admits every reachable state but traces to another
    graph (the same source line in jnp and in torch): the boundary-only
    class, salvaged as a continuation that re-expands the whole published
    set."""

    def _within(self, states):
        return states[:, 0] >= 0

    return type(base_cls.__name__, (base_cls,), {"within_boundary": _within})


def test_boundary_edit_continues_on_the_delta_rung_as_in_jax(delta_corpus, tmp_path):
    import shutil

    got = {}
    for side, cls, base, kw in (("jax", JaxService, jm.TensorTwoPhaseSys, JAX_KW),
                                ("port", CheckService, pm.TensorTwoPhaseSys, PORT_KW)):
        corpus_dir = str(tmp_path / side)
        shutil.copytree(delta_corpus[side][0], corpus_dir)
        svc = cls(corpus_dir=corpus_dir, **kw)
        r = _run(svc, _boundary_edit(base)(3)).result()
        stats = _delta_stats(svc)
        svc.close()
        corpus = {k: v for k, v in r.detail["corpus"].items() if k != "key"}
        assert corpus["warm_kind"] == "delta" and corpus["delta_class"] == "boundary-only"
        assert corpus["published"] is False  # a continuation never publishes
        assert (r.state_count, r.unique_state_count) == GOLD_2PC3 and r.complete
        assert set(r.discoveries) == {"abort agreement", "commit agreement"}
        got[side] = (_outcome(r), corpus, stats)
    assert got["port"] == got["jax"]


def test_delta_salvage_and_publish_evaluate_on_the_service_device(delta_corpus, tmp_path,
                                                                  monkeypatch):
    """The salvage's re-evaluated condition and the publisher's boundary
    plane run on the engine's device (the card unless the caller asked for
    the CPU), never on a device of their own."""
    import shutil

    seen = []
    real = specdelta._batched_eval

    def batched_eval(fn, states, device):
        seen.append(device)
        return real(fn, states, device)

    monkeypatch.setattr(specdelta, "_batched_eval", batched_eval)
    corpus_dir = str(tmp_path / "delta")
    shutil.copytree(delta_corpus["port"][0], corpus_dir)
    for where, model in ((corpus_dir, _property_edit(pm.TensorTwoPhaseSys)(3)),
                         (str(tmp_path / "fresh"), P3)):
        svc = CheckService(corpus_dir=where, **PORT_KW)
        before = len(seen)
        r = _run(svc, model).result()
        svc.close()
        assert len(seen) > before, where
        assert all(d == svc._engine.device for d in seen[before:]), seen[before:]
        assert (r.state_count, r.unique_state_count) == GOLD_2PC3
    assert r.detail["corpus"]["published"] is True
