"""The port's host checkers (checker/{bfs,dfs,simulation}.py), paths and
reports held against the JAX package's on the CPU: the cases of
tests/test_{bfs,dfs,simulation,report_and_path,eventually}.py, each run by
both packages on the same fixture. Counts, visit order, discovery action
lists, fingerprint paths and the report text (but its `sec=`) must be
equal; all are integers or strings, so the tolerance is 0."""

import io
import re

import pytest

import stateright_tpu as J
import stateright_tpu_torch as T
from stateright_tpu import fixtures as jfx
from stateright_tpu.checker.simulation import UniformChooser as JaxChooser
from stateright_tpu.examples import two_phase_commit as j2pc
from stateright_tpu_torch import fixtures as tfx
from stateright_tpu_torch.checker.simulation import UniformChooser
from stateright_tpu_torch.examples import two_phase_commit as t2pc

PKGS = [(J, jfx, j2pc), (T, tfx, t2pc)]


def both(fn):
    """fn(package, fixtures, two_phase_commit) for (JAX, port)."""
    return [fn(*p) for p in PKGS]


def summary(c):
    """Counts, and each discovery's actions (by repr: the packages' action
    types are distinct classes) and fingerprint path."""
    return (c.state_count(), c.unique_state_count(), c.max_depth(),
            {n: ([repr(a) for a in p.actions()], p.fingerprints())
             for n, p in c.discoveries().items()})


# -- BFS (tests/test_bfs.py) -------------------------------------------------------


def test_visits_states_in_bfs_order():
    def run(pkg, fx, _):
        rec = pkg.StateRecorder()
        fx.LinearEquation(a=2, b=10, c=14).checker().visitor(rec).spawn_bfs().join()
        return rec.states

    jax_states, port_states = both(run)
    assert port_states == jax_states == [
        (0, 0), (1, 0), (0, 1), (2, 0), (1, 1), (0, 2), (3, 0), (2, 1),
    ]


@pytest.mark.parametrize("threads", [1, 4])
def test_can_complete_by_enumerating_all_states(threads):
    def run(_, fx, __):
        c = fx.LinearEquation(a=2, b=4, c=7).checker().threads(threads).spawn_bfs().join()
        assert c.is_done()
        c.assert_no_discovery("solvable")
        return c

    jc, pc = both(run)
    assert pc.unique_state_count() == jc.unique_state_count() == 256 * 256
    assert pc.state_count() == jc.state_count() == 131_073
    assert pc.max_depth() == jc.max_depth()


def test_can_complete_by_eliminating_properties():
    def run(_, fx, __):
        c = fx.LinearEquation(a=2, b=10, c=14).checker().spawn_bfs().join()
        c.assert_properties()
        c.assert_discovery("solvable", [fx.Guess.INCREASE_Y] * 27)
        with pytest.raises(AssertionError, match="Invalid discovery"):
            c.assert_discovery("solvable", [fx.Guess.INCREASE_Y])
        return c

    jc, pc = both(run)
    assert pc.unique_state_count() == 12
    assert [a.value for a in pc.discovery("solvable").actions()] == [
        "IncreaseX", "IncreaseX", "IncreaseY"]
    assert [repr(a) for a in pc.discovery("solvable").actions()] == [
        repr(a) for a in jc.discovery("solvable").actions()]
    assert summary(pc)[:3] == summary(jc)[:3]
    assert pc.discovery("solvable").fingerprints() == jc.discovery("solvable").fingerprints()


@pytest.mark.parametrize("spawn", ["spawn_bfs", "spawn_dfs"])
def test_handles_panics_gracefully(spawn):
    for pkg, fx, _ in PKGS:
        with pytest.raises(RuntimeError, match="reached panic state"):
            getattr(fx.Panicker().checker().threads(2), spawn)().join()


def test_target_max_depth_limits_exploration():
    jc, pc = both(lambda _, fx, __: fx.LinearEquation(a=2, b=4, c=7).checker()
                  .target_max_depth(3).spawn_bfs().join())
    assert pc.max_depth() == jc.max_depth() == 3
    assert pc.unique_state_count() == jc.unique_state_count() == 1 + 2 + 3
    assert pc.state_count() == jc.state_count()


def test_target_state_count_stops_early():
    jc, pc = both(lambda _, fx, __: fx.LinearEquation(a=2, b=4, c=7).checker()
                  .target_state_count(100).spawn_bfs().join())
    assert 100 <= pc.state_count() < 65536 * 2
    assert summary(pc) == summary(jc)


def test_timeout_closes_the_market():
    jc, pc = both(lambda _, fx, __: fx.LinearEquation(a=2, b=4, c=7).checker()
                  .timeout(0.0).spawn_bfs().join())
    assert pc.is_done() and jc.is_done()
    assert pc.unique_state_count() == jc.unique_state_count() == 1


def test_2pc_bfs_goldens_and_discoveries():
    jc, pc = both(lambda _, __, m: m.TwoPhaseSys(3).checker().spawn_bfs().join())
    assert (pc.state_count(), pc.unique_state_count()) == (1_146, 288)
    assert summary(pc) == summary(jc)
    pc.assert_properties()


# -- DFS (tests/test_dfs.py) -------------------------------------------------------


def test_dfs_can_complete_by_eliminating_properties():
    def run(_, fx, __):
        c = fx.LinearEquation(a=2, b=10, c=14).checker().spawn_dfs().join()
        c.assert_properties()
        return c

    jc, pc = both(run)
    assert [a.value for a in pc.discovery("solvable").actions()] == ["IncreaseY"] * 27
    assert pc.state_count() == pc.unique_state_count() == 55
    assert summary(pc)[:3] == summary(jc)[:3]
    assert pc.discovery("solvable").fingerprints() == jc.discovery("solvable").fingerprints()


def _full_key_rep(m):
    """The full-key orbit representative of a 2PC state (the host twin of
    the device canonicalization, tests/test_tensor_symmetry.py), for
    either package's `TwoPhaseState`."""

    def rep(state):
        n = len(state.rm_state)
        order = sorted(range(n), key=lambda i: (
            state.rm_state[i], state.tm_prepared[i], ("prepared", i) in state.msgs))
        inv = {old: new for new, old in enumerate(order)}
        return m.TwoPhaseState(
            rm_state=tuple(state.rm_state[i] for i in order),
            tm_state=state.tm_state,
            tm_prepared=tuple(state.tm_prepared[i] for i in order),
            msgs=frozenset(("prepared", inv[x[1]]) if isinstance(x, tuple) else x
                           for x in state.msgs),
        )

    return rep


@pytest.mark.parametrize("rep,unique", [("value-sort", 665), ("full-key", 314)])
def test_dfs_symmetry_on_2pc5(rep, unique):
    def run(_, __, m):
        b = m.TwoPhaseSys(5).checker()
        b = b.symmetry() if rep == "value-sort" else b.symmetry_fn(_full_key_rep(m))
        c = b.spawn_dfs().join()
        c.assert_properties()
        return c

    jc, pc = both(run)
    assert pc.unique_state_count() == jc.unique_state_count() == unique
    assert summary(pc) == summary(jc)


def test_dfs_enumerates_2pc3():
    jc, pc = both(lambda _, __, m: m.TwoPhaseSys(3).checker().spawn_dfs().join())
    assert pc.unique_state_count() == 288
    assert summary(pc) == summary(jc)


# -- simulation (tests/test_simulation.py) ------------------------------------------


def test_simulation_can_complete_by_eliminating_properties():
    jc, pc = (
        fx.LinearEquation(a=2, b=10, c=14).checker().spawn_simulation(0, ch()).join()
        for ch, fx in ((JaxChooser, jfx), (UniformChooser, tfx))
    )
    for c, fx in ((jc, jfx), (pc, tfx)):
        c.assert_properties()
        c.assert_discovery("solvable", [fx.Guess.INCREASE_X, fx.Guess.INCREASE_Y,
                                        fx.Guess.INCREASE_X])
    assert summary(pc) == summary(jc)


@pytest.mark.parametrize("seed", [7, 123])
def test_same_seed_gives_the_jax_walks(seed):
    def run(fx, chooser):
        return (fx.LinearEquation(a=2, b=10, c=14).checker()
                .spawn_simulation(seed, chooser).join())

    jc = run(jfx, JaxChooser())
    pc, pc2 = run(tfx, UniformChooser()), run(tfx, None)
    assert summary(pc) == summary(pc2) == summary(jc)
    assert pc.state_count() == pc.unique_state_count()


def test_simulation_options():
    with pytest.raises(TypeError):
        tfx.LinearEquation(2, 10, 14).checker().spawn_simulation(traces=8)
    with pytest.raises(ValueError, match="chooser"):
        tfx.LinearEquation(2, 10, 14).checker().spawn_simulation(
            chooser=UniformChooser(), device="cpu")
    jc, pc = both(lambda _, __, m: m.TwoPhaseSys(3).checker().target_max_depth(6)
                  .target_state_count(500).spawn_simulation(3).join())
    assert summary(pc) == summary(jc) and pc.max_depth() <= 6


# -- paths and reports (tests/test_report_and_path.py) -----------------------------


def test_can_build_path_from_fingerprints():
    def run(pkg, fx, _):
        model = fx.LinearEquation(a=2, b=10, c=14)
        fps = [pkg.fingerprint(s) for s in ((0, 0), (0, 1), (1, 1), (2, 1))]
        path = pkg.Path.from_fingerprints(model, fps)
        assert path.last_state() == (2, 1) == pkg.Path.final_state(model, fps)
        assert path.fingerprints() == fps
        return path.encode(), path.name(), [repr(a) for a in path.actions()]

    assert both(run)[0] == both(run)[1]


def test_from_actions_roundtrip():
    def run(pkg, fx, _):
        g = fx.Guess
        path = pkg.Path.from_actions(fx.LinearEquation(2, 10, 14), (0, 0),
                                     [g.INCREASE_X, g.INCREASE_X, g.INCREASE_Y])
        assert pkg.Path.from_actions(fx.LinearEquation(2, 10, 14), (0, 0), ["jump"]) is None
        return path.last_state(), path.encode()

    jr, pr = both(run)
    assert pr == jr and pr[0] == (2, 1)


def test_nondeterministic_model_detected():
    for pkg, fx, _ in PKGS:
        with pytest.raises(RuntimeError, match="nondeterministic"):
            pkg.Path.from_fingerprints(fx.LinearEquation(2, 10, 14), [12345])


def test_report_format_matches_jax():
    def run(pkg, fx, _):
        out = io.StringIO()
        fx.LinearEquation(a=2, b=10, c=14).checker().spawn_bfs().report(pkg.WriteReporter(out))
        return re.sub(r"sec=[0-9.e+-]+", "sec=S", out.getvalue())

    jout, pout = both(run)
    assert pout == jout
    assert "Done. states=" in pout and "unique=12, depth=4, sec=S" in pout
    assert 'Discovered "solvable" example Path[3]:\n' in pout
    assert "- IncreaseX\n- IncreaseX\n- IncreaseY\n" in pout
    assert re.search(r"Fingerprint path: \d+(/\d+){3}\n", pout), pout


def test_binary_clock_properties():
    jc, pc = both(lambda _, fx, __: fx.BinaryClock().checker().spawn_bfs().join())
    pc.assert_properties()
    assert pc.unique_state_count() == 2
    assert summary(pc) == summary(jc)


# -- eventually properties (tests/test_eventually.py) ------------------------------


def _dgraph(pkg, fx, paths):
    g = fx.DGraph.with_property(pkg.Property.eventually("odd", lambda _, s: s % 2 == 1))
    for p in paths:
        g = g.with_path(list(p))
    return g.check()


@pytest.mark.parametrize("paths", [
    [[1], [2, 3], [2, 6, 7], [4, 9, 10]], [[1]], [[2, 3]], [[2, 6, 7]], [[4, 9, 10]],
])
def test_eventually_can_validate(paths):
    for c in both(lambda pkg, fx, _: _dgraph(pkg, fx, paths)):
        c.assert_properties()


@pytest.mark.parametrize("paths,states", [
    ([[0, 1], [0, 2]], [0, 2]),
    ([[0, 1], [2, 4]], [2, 4]),
    ([[0, 1, 4, 6], [2, 4, 8]], [2, 4, 6]),
])
def test_eventually_can_discover_counterexample(paths, states):
    jc, pc = both(lambda pkg, fx, _: _dgraph(pkg, fx, paths))
    assert pc.discovery("odd").states() == jc.discovery("odd").states() == states


@pytest.mark.parametrize("paths", [[[0, 2, 4, 2]], [[0, 2, 4], [1, 4, 6]]])
def test_eventually_misses_counterexample_when_revisiting_a_state(paths):
    # The reference's documented false negative (ref: src/checker.rs:663-680),
    # kept on purpose in both packages.
    jc, pc = both(lambda pkg, fx, _: _dgraph(pkg, fx, paths))
    assert pc.discovery("odd") is None and jc.discovery("odd") is None


# -- FnModel and the state-building types -------------------------------------------


def test_fn_model_bfs_equals_jax():
    from stateright_tpu.core.model import FnModel as JaxFnModel
    from stateright_tpu_torch.core.model import FnModel

    def run(cls, pkg):
        m = cls(init=lambda: [0], step=lambda s: [s + 1, s + 2] if s < 6 else [],
                props=[pkg.Property.sometimes("five", lambda _, s: s == 5)],
                boundary=lambda s: s <= 7)
        return summary(m.checker().spawn_bfs().join())

    pr, jr = run(FnModel, T), run(JaxFnModel, J)
    assert pr == jr and pr[:2] == (11, 7)


def test_utils_encode_and_behave_like_jax():
    from stateright_tpu import actor as ja
    from stateright_tpu import utils as ju
    from stateright_tpu_torch import actor as ta
    from stateright_tpu_torch import utils as tu

    def values(u, actor):
        s = u.HashableSet([3, 1, 2]).add(5).remove(1)
        m = u.HashableMap({"b": 2, "a": 1}).set("c", u.HashableSet(["x"])).remove("b")
        d = u.DenseNatMap.from_iter_keyed([(actor.Id(1), "y"), (actor.Id(0), "x")]).insert(2, "z")
        v = u.VectorClock([1, 0, 2]).incremented(4).merge_max(u.VectorClock([3]))
        return [s, m, d, v, (s, m, d, v)]

    jv, tv = values(ju, ja), values(tu, ta)
    assert [T.fingerprint(x) for x in tv] == [J.fingerprint(x) for x in jv]
    assert [repr(x) for x in tv] == [repr(x) for x in jv]
    assert 3 in tv[0] and tv[1]["c"] == tu.HashableSet(["x"]) and tv[2].get(2) == "z"
    assert tv[3] == tu.VectorClock([3, 0, 2, 0, 1])
    assert tu.VectorClock([1, 2]).partial_cmp(tu.VectorClock([2, 1])) is None
    assert tu.VectorClock([1]) < tu.VectorClock([1, 1])
    with pytest.raises(IndexError):
        tu.DenseNatMap().insert(1, "gap")
