"""The port's `ActorModel` on its host checkers, held against the JAX
package's on the CPU: the host BFS/DFS cases of tests/test_actor_model.py,
the actor examples' host goldens of tests/test_examples.py (single-copy
register, ABD, with their consistency testers), and symmetric DFS through
`ActorModelState.representative`. Each system is built in both packages
from the same definition; counts, recorded states, discovery action lists
and fingerprints must be equal (integers and strings: tolerance 0)."""

import pytest

import stateright_tpu as J
import stateright_tpu_torch as T
from stateright_tpu import actor as ja
from stateright_tpu.actor import test_util as jtu
from stateright_tpu.examples import abd as jabd
from stateright_tpu.examples import single_copy_register as jscr
from stateright_tpu_torch import actor as ta
from stateright_tpu_torch.actor import test_util as ttu
from stateright_tpu_torch.examples import abd as tabd
from stateright_tpu_torch.examples import single_copy_register as tscr

PKGS = [(J, ja, jtu), (T, ta, ttu)]


def both(fn):
    """fn(package, actor module, test_util) for (JAX, port)."""
    return [fn(*p) for p in PKGS]


def summary(c):
    return (c.state_count(), c.unique_state_count(), c.max_depth(),
            {n: ([repr(a) for a in p.actions()], p.fingerprints())
             for n, p in c.discoveries().items()})


def ping_pong(a, tu, *, max_nat=5, lossy=True, network=None):
    m = tu.PingPongCfg(max_nat=max_nat, maintains_history=False).into_model()
    if network is not None:
        m = m.with_init_network(network(a))
    return m.with_lossy_network(a.LossyNetwork.YES if lossy else a.LossyNetwork.NO)


def test_visits_expected_states():
    # ref: src/actor/model.rs:774-892 — the 14 states of lossy duplicating
    # ping-pong with max_nat=1.
    def run(pkg, a, tu):
        rec = pkg.StateRecorder()
        c = ping_pong(a, tu, max_nat=1).checker().visitor(rec).spawn_bfs().join()
        assert c.unique_state_count() == len(rec.states) == 14
        e = lambda s, d, m: a.Envelope(a.Id(s), a.Id(d), m)  # noqa: E731
        Ping, Pong = tu.Ping, tu.Pong
        expected = a.ActorModelState(
            actor_states=(1, 1),
            network=a.Network.new_unordered_duplicating_with_last_msg(
                [e(0, 1, Ping(0)), e(0, 1, Ping(1))], e(1, 0, Pong(0))),
            timers_set=(frozenset(), frozenset()), random_choices=({}, {}),
            crashed=(False, False), history=(0, 0))
        assert expected in rec.states
        return [pkg.fingerprint(s) for s in rec.states], [repr(s) for s in rec.states]

    assert both(run)[0] == both(run)[1]


def _client_server(a):
    class Client(a.Actor):
        def __init__(self, server):
            self.server = server

        def on_start(self, id, out):
            out.send(self.server, "Ignored")
            out.send(self.server, "Interesting")
            return "Awaiting an interesting message."

        def on_msg(self, id, state, src, msg, out):
            return "Got an interesting message." if msg == "Interesting" else None

    class Server(a.Actor):
        def on_start(self, id, out):
            return "Awaiting an interesting message."

        def on_msg(self, id, state, src, msg, out):
            return "Got an interesting message." if msg == "Interesting" else None

    return Client(a.Id(1)), Server()


@pytest.mark.parametrize("network,unique", [
    ("new_unordered_duplicating", 2), ("new_unordered_nonduplicating", 2), ("new_ordered", 3),
])
def test_no_op_depends_on_network(network, unique):
    # ref: src/actor/model.rs:894-967
    def run(pkg, a, _):
        client, server = _client_server(a)
        m = (a.ActorModel.new(None, None).actor(client).actor(server)
             .with_lossy_network(a.LossyNetwork.NO)
             .with_init_network(getattr(a.Network, network)())
             .property(pkg.Expectation.ALWAYS, "Check everything", lambda m, s: True))
        return summary(m.checker().spawn_bfs().join())

    jr, pr = both(run)
    assert pr == jr and pr[1] == unique


def test_maintains_fixed_delta_despite_lossy_duplicating_network():
    # ref: src/actor/model.rs:969-1006 — the 4,094-state golden.
    def run(_, a, tu):
        c = ping_pong(a, tu).checker().spawn_bfs().join()
        c.assert_no_discovery("delta within 1")
        c.assert_discovery("must reach max", [
            a.DropEnv(a.Envelope(a.Id(0), a.Id(1), tu.Ping(0)))])
        return summary(c)

    jr, pr = both(run)
    assert pr == jr and pr[1] == 4094


@pytest.mark.parametrize("nonduplicating", [True, False])
def test_perfect_delivery_goldens(nonduplicating):
    # ref: src/actor/model.rs:1008-1073 — the 11-state goldens.
    net = (lambda a: a.Network.new_unordered_nonduplicating()) if nonduplicating else None

    def run(_, a, tu):
        c = ping_pong(a, tu, lossy=False, network=net).checker().spawn_bfs().join()
        if nonduplicating:
            c.assert_no_discovery("must reach max")
            assert c.discovery("must exceed max").last_state().actor_states == (5, 5)
        else:
            assert c.discovery("can reach max").last_state().actor_states == (4, 5)
        return summary(c)

    jr, pr = both(run)
    assert pr == jr and pr[1] == 11


def test_handles_undeliverable_messages():
    # ref: src/actor/model.rs:1076-1092
    def run(pkg, a, _):
        class Noop(a.Actor):
            def on_start(self, id, out):
                return ()

        m = (a.ActorModel.new(None, None).actor(Noop())
             .property(pkg.Expectation.ALWAYS, "unused", lambda m, s: True)
             .with_init_network(a.Network.new_unordered_duplicating(
                 [a.Envelope(a.Id(0), a.Id(99), ())])))
        return summary(m.checker().spawn_bfs().join())

    jr, pr = both(run)
    assert pr == jr and pr[1] == 1


@pytest.mark.parametrize("network,received", [
    ("new_ordered", {(), (2,), (2, 1)}),
    ("new_unordered_nonduplicating", {(), (1,), (2,), (1, 2), (2, 1)}),
])
def test_handles_ordered_network_flag(network, received):
    # ref: src/actor/model.rs:1094-1159
    def run(pkg, a, _):
        class OrderedNetworkActor(a.Actor):
            def on_start(self, id, out):
                if id == 0:
                    out.send(a.Id(1), 2)
                    out.send(a.Id(1), 1)
                return ()

            def on_msg(self, id, state, src, msg, out):
                return state + (msg,)

        rec = pkg.StateRecorder()
        (a.ActorModel.new(None, None)
         .add_actors([OrderedNetworkActor(), OrderedNetworkActor()])
         .property(pkg.Expectation.ALWAYS, "any", lambda m, s: True)
         .with_init_network(getattr(a.Network, network)())
         .checker().visitor(rec).spawn_bfs().join())
        return [pkg.fingerprint(s) for s in rec.states], {s.actor_states[1] for s in rec.states}

    jr, pr = both(run)
    assert pr == jr and pr[1] == received


@pytest.mark.parametrize("lossy", [False, True])
@pytest.mark.parametrize("network", [
    "new_ordered", "new_unordered_duplicating", "new_unordered_nonduplicating"])
def test_unordered_network_semantics(lossy, network):
    # ref: src/actor/model.rs:1161-1274, on the DFS with a PathRecorder.
    def run(pkg, a, _):
        class A(a.Actor):
            def on_start(self, id, out):
                if id == 0:
                    out.send(a.Id(1), "m")
                    out.send(a.Id(1), "m")
                return 0

            def on_msg(self, id, state, src, msg, out):
                return state + 1

        rec = pkg.PathRecorder()
        (a.ActorModel.new(None, None).add_actors([A(), A()])
         .with_init_network(getattr(a.Network, network)())
         .with_lossy_network(a.LossyNetwork.YES if lossy else a.LossyNetwork.NO)
         .property(pkg.Expectation.ALWAYS, "force visiting all states", lambda m, s: True)
         .with_within_boundary(lambda cfg, s: s.actor_states[1] < 4)
         .checker().visitor(rec).spawn_dfs().join())
        return [tuple(repr(x) for x in p.actions()) for p in rec.paths]

    jr, pr = both(run)
    assert pr == jr
    seqs = set(pr)
    deliver = repr(ta.Deliver(ta.Id(0), ta.Id(1), "m"))
    drop = repr(ta.DropEnv(ta.Envelope(ta.Id(0), ta.Id(1), "m")))
    assert (deliver, deliver) in seqs or (deliver, deliver, deliver) in seqs
    if network == "new_unordered_duplicating":
        assert (deliver, deliver, deliver) in seqs
        assert (drop, deliver) not in seqs  # drop means "never deliver again"
    else:
        assert (deliver, deliver, deliver) not in seqs
    assert ((drop,) in seqs or (drop, drop) in seqs) == lossy


def test_timer_semantics():
    # ref: src/actor/model.rs:1276-1330
    def run(pkg, a, _):
        class TimerActor(a.Actor):
            def on_start(self, id, out):
                out.set_timer("t", a.model_timeout())
                return 0

            def on_timeout(self, id, state, timer, out):
                if state < 2:
                    out.set_timer("t", a.model_timeout())
                    return state + 1
                return None

        return summary(a.ActorModel.new(None, None).actor(TimerActor())
                       .property(pkg.Expectation.ALWAYS, "any", lambda m, s: True)
                       .checker().spawn_bfs().join())

    jr, pr = both(run)
    assert pr == jr and pr[1] == 4


def test_crash_semantics():
    # ref: src/actor/model.rs:1332-1431 — crash cancels timers, blocks delivery;
    # then the whole space under one crash, on both checkers.
    def run(pkg, a, _):
        class CrashableActor(a.Actor):
            def on_start(self, id, out):
                out.set_timer("tick", a.model_timeout())
                if id == 0:
                    out.send(a.Id(1), "hello")
                return 0

            def on_msg(self, id, state, src, msg, out):
                return state + 1

            def on_timeout(self, id, state, timer, out):
                return None

        model = (a.ActorModel.new(None, None)
                 .add_actors([CrashableActor(), CrashableActor()])
                 .with_init_network(a.Network.new_unordered_nonduplicating())
                 .with_max_crashes(1)
                 .property(pkg.Expectation.ALWAYS, "any", lambda m, s: True))
        init = model.init_states()[0]
        crashed = model.next_state(init, a.Crash(a.Id(1)))
        assert crashed.crashed[1] and crashed.timers_set[1] == frozenset()
        assert model.next_state(crashed, a.Deliver(a.Id(0), a.Id(1), "hello")) is None
        acts: list = []
        model.actions(crashed, acts)
        assert a.Timeout(a.Id(1), "tick") not in acts and a.Timeout(a.Id(0), "tick") in acts
        assert not any(isinstance(x, a.Crash) for x in acts)
        return (summary(model.checker().spawn_bfs().join()),
                summary(model.checker().spawn_dfs().join()),
                model.format_step(init, a.Crash(a.Id(1))))

    jr, pr = both(run)
    assert pr == jr


def test_choose_random_creates_branches():
    def run(pkg, a, _):
        class RandomActor(a.Actor):
            def on_start(self, id, out):
                out.choose_random("coin", ["heads", "tails"])
                return "undecided"

            def on_random(self, id, state, random, out):
                return random

        rec = pkg.StateRecorder()
        c = (a.ActorModel.new(None, None).actor(RandomActor())
             .property(pkg.Expectation.ALWAYS, "any", lambda m, s: True)
             .checker().visitor(rec).spawn_bfs().join())
        return summary(c), {s.actor_states[0] for s in rec.states}

    jr, pr = both(run)
    assert pr == jr and pr[1] == {"undecided", "heads", "tails"} and pr[0][1] == 3


# -- the actor examples' host goldens (tests/test_examples.py) ----------------------


def _scr(pkg_scr, a, servers):
    return pkg_scr.SingleCopyModelCfg(
        client_count=2, server_count=servers,
        network=a.Network.new_unordered_nonduplicating()).into_model()


def test_single_copy_register_dfs_golden():
    jr, pr = (summary(_scr(m, a, 1).checker().spawn_dfs().join())
              for m, a in ((jscr, ja), (tscr, ta)))
    assert pr == jr and pr[1] == 93


def test_single_copy_register_two_servers_are_not_linearizable():
    jc, pc = (_scr(m, a, 2).checker().spawn_bfs().join() for m, a in ((jscr, ja), (tscr, ta)))
    assert summary(pc) == summary(jc)
    assert {"linearizable", "value chosen"} <= set(pc.discoveries())


@pytest.mark.parametrize("spawn,symmetric", [
    ("spawn_bfs", False), ("spawn_dfs", False), ("spawn_dfs", True)])
def test_abd_goldens(spawn, symmetric):
    def run(m, a):
        b = m.AbdModelCfg(client_count=2, server_count=2,
                          network=a.Network.new_unordered_nonduplicating()).into_model().checker()
        c = getattr(b.symmetry() if symmetric else b, spawn)().join()
        c.assert_properties()
        return summary(c)

    jr, pr = run(jabd, ja), run(tabd, ta)
    assert pr == jr
    assert pr[1] == 544 if not symmetric else pr[1] <= 544


def test_representative_equals_jax():
    # ActorModelState.representative and Network.__rewrite__ on every
    # reachable state of lossy ping-pong and of ABD's 2-client system.
    def states(pkg, a, tu, m):
        out = []
        for model in (ping_pong(a, tu, max_nat=2),
                      m.AbdModelCfg(client_count=2, server_count=2,
                                    network=a.Network.new_unordered_nonduplicating()
                                    ).into_model()):
            rec = pkg.StateRecorder()
            model.checker().visitor(rec).spawn_bfs().join()
            out += [(pkg.fingerprint(s.representative()), repr(s.representative()))
                    for s in rec.states]
        return out

    jr = states(J, ja, jtu, jabd)
    pr = states(T, ta, ttu, tabd)
    assert pr == jr and len(pr) > 544
