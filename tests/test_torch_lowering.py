"""The port's actor lowering (stateright_tpu_torch/tensor/lowering.py)
against the JAX package's: the baked tables and layout bit for bit, and the
goldens of the JAX package's tests/test_lowering.py through the port's
ResidentSearch on the CPU, each held against the JAX package's host
checker. `expand` on seeded rows is in test_torch_lowering_expand.py,
refinement and the deep configurations in test_torch_lowering_refine.py.
Integers and bits: the tolerance is 0."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.tensor import TensorProperty as JProp
from stateright_tpu.tensor import lowering as jl
from stateright_tpu_torch.tensor import TensorProperty as TProp
from stateright_tpu_torch.tensor import lowering as tl
from stateright_tpu_torch.tensor.resident import ResidentSearch
from test_torch_models import one_torch_thread  # noqa: F401 (autouse)

ROOTS = {"jax": "stateright_tpu", "torch": "stateright_tpu_torch"}
PROP = {"jax": JProp, "torch": TProp}
LOWER = {"jax": jl, "torch": tl}
# Row-wise max - min of a [B, n] feature: jnp and torch spell it differently.
SPREAD = {"jax": lambda x: x.max(1) - x.min(1), "torch": lambda x: x.amax(1) - x.amin(1)}
EMPTY = 0xFFFFFFFF


def mod(side, name):
    return importlib.import_module(f"{ROOTS[side]}.{name}")


def _host(model):
    """The JAX package's host BFS checker (jax-free): the count oracle."""
    return model.checker().spawn_bfs().join()


def _search(lowered, batch_size, table_log2, **run):
    return ResidentSearch(lowered, batch_size, table_log2, device="cpu").run(**run)


# -- model builders (the same spec on either side) --------------------------------


def ping_pong_model(side, max_nat, lossy, network=None):
    actor = mod(side, "actor")
    cfg = mod(side, "actor.test_util").PingPongCfg(max_nat=max_nat, maintains_history=False)
    model = cfg.into_model().with_lossy_network(lossy)
    if network is not None:
        model = model.with_init_network(getattr(actor.Network, f"new_{network}")())
    return model


def ping_pong(side, max_nat, lossy, network=None):
    """JAX tests/test_lowering.py `_ping_pong_lowered`."""
    P, spread = PROP[side], SPREAD[side]

    def properties(view):
        counters = view.actor_feature(lambda i, s: s)
        in_le_out = view.history_pred(lambda h: h[0] <= h[1])
        out_le_in1 = view.history_pred(lambda h: h[1] <= h[0] + 1)
        return [
            P.always("delta within 1", lambda m, s: spread(counters(s)) <= 1),
            P.sometimes("can reach max", lambda m, s: (counters(s) == max_nat).any(1)),
            P.eventually("must reach max", lambda m, s: (counters(s) == max_nat).any(1)),
            P.eventually("must exceed max", lambda m, s: (counters(s) == max_nat + 1).any(1)),
            P.always("#in <= #out", lambda m, s: in_le_out(s)),
            P.eventually("#out <= #in + 1", lambda m, s: out_le_in1(s)),
        ]

    return LOWER[side].lower_actor_model(
        ping_pong_model(side, max_nat, lossy, network),
        local_boundary=lambda i, s: s <= max_nat,
        properties=properties,
        boundary=counters_le(max_nat),
    )


def counters_le(cap):
    def boundary(view):
        counters = view.actor_feature(lambda i, s: s)
        return lambda s: (counters(s) <= cap).all(1)

    return boundary


def register_props(side):
    """The "linearizable" / "value chosen" pair of the register examples."""
    P = PROP[side]
    GetOk = mod(side, "actor.register").GetOk
    null = mod(side, "examples.paxos").NULL_VALUE

    def properties(view):
        lin = view.history_pred(lambda h: h.is_consistent())
        chosen = view.any_env(lambda e: isinstance(e.msg, GetOk) and e.msg.value != null)
        return [
            P.always("linearizable", lambda m, s: lin(s)),
            P.sometimes("value chosen", lambda m, s: chosen(s)),
        ]

    return properties


def single_copy(side, network=None):
    ex = mod(side, "examples.single_copy_register")
    kw = {} if network is None else {"network": getattr(mod(side, "actor").Network, f"new_{network}")()}
    return ex.SingleCopyModelCfg(client_count=2, server_count=1, **kw).into_model()


def paxos_model(side, clients):
    net = mod(side, "actor").Network.new_unordered_nonduplicating()
    return mod(side, "examples.paxos").PaxosModelCfg(
        client_count=clients, server_count=3, network=net
    ).into_model()


def paxos2_exact(side):
    return LOWER[side].lower_actor_model(
        paxos_model(side, 2), properties=register_props(side), closure="exact"
    )


def coin_flipper_model(side, crashes):
    """JAX tests/test_lowering.py `CoinFlipper` (choose_random / on_random),
    optionally with one crash."""
    actor = mod(side, "actor")

    class CoinFlipper(actor.Actor):
        def __init__(self, limit):
            self.limit = limit

        def on_start(self, id, out):
            out.choose_random("flip", ["H", "T"])
            return (0, 0)

        def on_random(self, id, state, random, out):
            flips, heads = state
            if flips >= self.limit:
                return None
            flips += 1
            heads += random == "H"
            if flips < self.limit:
                out.choose_random("flip", ["H", "T"] if heads % 2 == 0 else ["T", "H", "H2"])
            return (flips, heads)

    Exp = mod(side, "core.model").Expectation
    m = (
        mod(side, "actor.model").ActorModel.new(None, None)
        .actor(CoinFlipper(3))
        .actor(CoinFlipper(2))
        .property(
            Exp.SOMETIMES, "all heads",
            lambda m, s: all(st[1] == st[0] == 2 for st in s.actor_states[1:]),
        )
        .property(Exp.ALWAYS, "bounded", lambda m, s: all(st[0] <= 3 for st in s.actor_states))
    )
    return m.with_max_crashes(1) if crashes else m


def coin_flipper(side, crashes):
    P = PROP[side]

    def properties(view):
        flips = view.actor_feature(lambda i, s: s[0])
        heads = view.actor_feature(lambda i, s: s[1])
        return [
            P.sometimes(
                "all heads",
                lambda m, s: (heads(s)[:, 1:] == 2).all(1) & (flips(s)[:, 1:] == 2).all(1),
            ),
            P.always("bounded", lambda m, s: (flips(s) <= 3).all(1)),
        ]

    return LOWER[side].lower_actor_model(
        coin_flipper_model(side, crashes), properties=properties
    )


def tick_tock_model(side):
    """JAX tests/test_lowering.py `TickTock`: SetTimer lowering with the
    fired-timer-consumed and renew-elision rules."""
    actor = mod(side, "actor")

    class TickTock(actor.Actor):
        def on_start(self, id, out):
            out.set_timer("tick", (1, 2))
            return 0

        def on_timeout(self, id, state, timer, out):
            if state >= 3:
                return None
            out.set_timer("tick", (1, 2))
            return state + 1

    Exp = mod(side, "core.model").Expectation
    return (
        mod(side, "actor.model").ActorModel.new(None, None).actor(TickTock())
        .property(Exp.ALWAYS, "bounded", lambda m, s: s.actor_states[0] <= 3)
    )


def tick_tock(side):
    P = PROP[side]

    def properties(view):
        v = view.actor_feature(lambda i, s: s)
        return [P.always("bounded", lambda m, s: (v(s) <= 3).all(1))]

    return LOWER[side].lower_actor_model(tick_tock_model(side), properties=properties)


def pinger_seed(side):
    """The timer pingers (ROADMAP A8's refine-with-timers test) as a
    refinement seed: lazy histories are off (no history), timeout gaps on."""
    ex = mod(side, "examples.timers")
    net = mod(side, "actor").Network.new_unordered_nonduplicating()
    return LOWER[side].LoweredActorModel(
        ex.PingerModelCfg(server_count=2, network=net).into_model(),
        closure="seed", max_joint_states=2,
    )


def paxos1_seed(side):
    """1-client Paxos as a refinement seed: lazy history gaps (kind 4) and
    deliver gaps (kind 0) in `expand`'s poison payloads."""
    net = mod(side, "actor").Network.new_unordered_nonduplicating()
    model = mod(side, "examples.paxos").PaxosModelCfg(
        client_count=1, server_count=3, network=net
    ).into_model()
    return LOWER[side].LoweredActorModel(
        model, closure="seed", max_joint_states=32, properties=register_props(side)
    )


# -- tables and layout, bit for bit ----------------------------------------------


def _assert_tables_equal(j, t):
    assert (t.lanes, t.max_actions, t.maxS, t.E) == (j.lanes, j.max_actions, j.maxS, j.E)
    assert (t.sid_off, t.timer_off, t.hist_off, t.rand_off, t.crash_off, t.net_off) == (
        j.sid_off, j.timer_off, j.hist_off, j.rand_off, j.crash_off, j.net_off
    )
    assert (t.pool_size, t.flow_depth, t.closure_stats) == (j.pool_size, j.flow_depth, j.closure_stats)
    assert [len(s) for s in t.states] == [len(s) for s in j.states]
    assert [repr(e) for e in t.envs] == [repr(e) for e in j.envs]
    assert [repr(h) for h in t.histories] == [repr(h) for h in j.histories]
    assert sorted(t._dyn_host) == sorted(j._dyn_host)
    for name, a in j._dyn_host.items():
        b = t._dyn_host[name]
        assert (b.dtype, b.shape) == (a.dtype, a.shape), name
        assert b.tobytes() == a.tobytes(), name
    jd, td = j.dyn_tables(), t.dyn_tables()
    for name in jd:
        np.testing.assert_array_equal(
            td[name].numpy(), np.asarray(jd[name]).astype(td[name].numpy().dtype), err_msg=name
        )
    np.testing.assert_array_equal(
        t.init_states().numpy(), np.asarray(j.init_states()).astype(np.int64)
    )


@pytest.mark.parametrize(
    "build",
    [
        lambda side: ping_pong(side, 5, True),
        lambda side: LOWER[side].lower_actor_model(
            single_copy(side), properties=register_props(side)
        ),
        paxos2_exact,
    ],
    ids=["ping-pong", "single-copy-register", "paxos-2-exact"],
)
def test_tables_and_layout_equal_jax_bit_for_bit(build):
    """The host closure is the JAX code line for line: the same vocabularies
    in the same order, so the same sids, and every baked table (reaction
    tables, history transitions, view tables) byte for byte."""
    _assert_tables_equal(build("jax"), build("torch"))


# -- goldens (JAX tests/test_lowering.py) through the port's ResidentSearch ------


@pytest.mark.parametrize(
    "max_nat,lossy,network,batch,table_log2,golden",
    [
        (5, True, None, 512, 16, 4094),  # :84, ref src/actor/model.rs:969-982
        (5, False, "unordered_nonduplicating", 64, 10, 11),  # :104
        (3, False, None, 256, 14, None),  # :124
        (5, False, "ordered", 64, 10, None),  # :289
        (3, True, "ordered", 256, 14, None),  # :305
    ],
    ids=["lossy-duplicating", "lossless-nonduplicating", "lossless-duplicating",
         "ordered", "ordered-lossy"],
)
def test_ping_pong_goldens(max_nat, lossy, network, batch, table_log2, golden):
    host = _host(ping_pong_model("jax", max_nat, lossy, network))
    r = _search(ping_pong("torch", max_nat, lossy, network), batch, table_log2)
    assert r.unique_state_count == host.unique_state_count()
    assert r.state_count == host.state_count()
    assert set(r.discoveries) == set(host.discoveries())
    if golden is not None:
        assert r.unique_state_count == golden


@pytest.mark.parametrize("network", [None, "ordered"])
def test_single_copy_register_with_linearizability_history(network):
    """:139 (93 unique) and :319 (ordered): the LinearizabilityTester history
    lowers to a finite automaton and `is_consistent()` to a gather table."""
    host = _host(single_copy("jax", network))
    r = _search(
        tl.lower_actor_model(single_copy("torch", network), properties=register_props("torch")),
        128, 12,
    )
    assert r.unique_state_count == host.unique_state_count()
    assert r.state_count == host.state_count()
    assert set(r.discoveries) == set(host.discoveries()) == {"value chosen"}
    if network is None:
        assert r.unique_state_count == 93


def test_timer_lowering_parity():
    """:258."""
    host = _host(tick_tock_model("jax"))
    r = _search(tick_tock("torch"), 16, 8)
    assert (r.unique_state_count, r.state_count) == (host.unique_state_count(), host.state_count())
    assert r.discoveries == {} and not host.discoveries()


@pytest.mark.parametrize("crashes", [False, True])
def test_random_choices_and_crash_parity(crashes):
    """:430 (randoms) and the same model with one crash (crash lane and
    Crash actions, as :474 exercises them)."""
    host = _host(coin_flipper_model("jax", crashes))
    r = _search(coin_flipper("torch", crashes), 128, 12)
    assert (r.unique_state_count, r.state_count) == (host.unique_state_count(), host.state_count())
    assert set(r.discoveries) == set(host.discoveries())


def test_crash_injection_parity():
    """:474: ping-pong with one crash, a global boundary and the crash lane
    excluded from identity."""

    def bare(side):
        a = mod(side, "actor")
        tu = mod(side, "actor.test_util")
        Exp = mod(side, "core.model").Expectation
        return (
            mod(side, "actor.model").ActorModel.new(None, None)
            .actor(tu.PingPongActor(serve_to=a.Id(1)))
            .actor(tu.PingPongActor(serve_to=None))
            .with_init_network(a.Network.new_unordered_nonduplicating())
            .with_max_crashes(1)
            .with_within_boundary(lambda cfg, state: all(c <= 3 for c in state.actor_states))
            .property(
                Exp.ALWAYS, "delta within 1",
                lambda m, s: max(s.actor_states) - min(s.actor_states) <= 1,
            )
        )

    def properties(view):
        counters = view.actor_feature(lambda i, s: s)
        return [TProp.always("delta within 1", lambda m, s: SPREAD["torch"](counters(s)) <= 1)]

    host = _host(bare("jax"))
    lowered = tl.lower_actor_model(
        bare("torch"), local_boundary=lambda i, s: s <= 3, properties=properties,
        boundary=counters_le(3),
    )
    r = _search(lowered, 128, 12)
    assert (r.unique_state_count, r.state_count) == (host.unique_state_count(), host.state_count())
    assert set(r.discoveries) == set(host.discoveries())


def test_crash_and_randoms_identity_exclusion():
    """:523: states differing only in crash flags / pending choices share
    identity through `representative`, as in the JAX model."""

    def bare(side):
        flipper = coin_flipper_model(side, crashes=False).actors[0]
        flipper.limit = 1
        Exp = mod(side, "core.model").Expectation
        return (
            mod(side, "actor.model").ActorModel.new(None, None).actor(flipper)
            .with_max_crashes(1).property(Exp.ALWAYS, "t", lambda m, s: True)
        )

    def lowered(side):
        return LOWER[side].lower_actor_model(
            bare(side), properties=lambda view: [PROP[side].always("t", lambda m, s: s[:, 0] == s[:, 0])]
        )

    j, t = lowered("jax"), lowered("torch")
    assert t.representative is not None
    row = t.init_states()[0]
    variant = row.clone()
    variant[t.crash_off] = 1  # crashed bit set
    variant[t.rand_off] = 0  # choices cleared
    both = torch.stack([row, variant])
    canon = t.representative(both)
    assert (canon[0] == canon[1]).all()
    np.testing.assert_array_equal(
        canon.numpy(), np.asarray(j.representative(jnp.asarray(both.numpy().astype(np.uint32))))
    )
    assert (both == torch.stack([row, variant])).all()  # the originals are kept


def test_paxos2_exact_closure_golden():
    """:621, THE headline golden through the generic lowering: 32,971
    generated / 16,668 unique (ref: examples/paxos.rs:327,351), equal to
    the hand encoding's counts on the same protocol, and to the closure's
    own host traversal."""
    from stateright_tpu_torch.tensor import TensorPaxos

    lowered = paxos2_exact("torch")
    c = lowered.checker().spawn_cuda(batch_size=2048, table_log2=18, device="cpu").join()
    r = c.result()
    assert (r.state_count, r.unique_state_count) == (32_971, 16_668)
    assert set(r.discoveries) == {"value chosen"}  # linearizability holds
    path = c.discoveries()["value chosen"]  # the witness replays
    c.assert_discovery("value chosen", path.actions())
    c.assert_no_discovery("linearizable")
    s = lowered.closure_stats
    assert (s["generated"], s["unique"]) == (32_971, 16_668)
    hand = _search(TensorPaxos(2), 2048, 18)
    assert (hand.state_count, hand.unique_state_count) == (r.state_count, r.unique_state_count)


@pytest.mark.parametrize("mode", ["joint", "exact"])
def test_closure_modes_match_independent_on_ping_pong(mode):
    """:673: every closure mode gives the host's 7 unique states."""

    def build(closure):
        kw = {} if closure == "exact" else {"local_boundary": lambda i, s: s <= 3}
        return tl.lower_actor_model(
            ping_pong_model("torch", 3, False), closure=closure, boundary=counters_le(3), **kw
        )

    host = _host(ping_pong_model("jax", 3, False))
    r_ind = _search(build("independent"), 128, 12)
    r_mode = _search(build(mode), 128, 12)
    assert r_mode.unique_state_count == r_ind.unique_state_count == host.unique_state_count() == 7
    assert r_mode.state_count == r_ind.state_count == host.state_count()
    assert r_mode.max_depth == r_ind.max_depth


def test_exact_autosized_network_lanes_with_boundary():
    """:911: exact mode sizes the pool to the occupancy of every GENERATED
    successor (pre-boundary); an explicit pool_size is kept."""

    def bare(side):
        a = mod(side, "actor")
        Exp = mod(side, "core.model").Expectation

        class BurstSender(a.Actor):
            def on_start(self, id, out):
                out.send(a.Id(1), "ping")
                out.set_timer("tick", (1.0, 2.0))
                return 0

            def on_timeout(self, id, state, timer, out):
                out.send(a.Id(1), "ping")
                return state + 1

        class Sink(a.Actor):
            def on_start(self, id, out):
                return 0

            def on_msg(self, id, state, src, msg, out):
                return state + 1

        return (
            mod(side, "actor.model").ActorModel.new(None, None)
            .actor(BurstSender()).actor(Sink())
            .with_init_network(a.Network.new_unordered_nonduplicating())
            .with_within_boundary(
                lambda cfg, state: sum(state.network._data.values()) <= 1
                and all(c <= 4 for c in state.actor_states)
            )
            .property(Exp.ALWAYS, "ok", lambda m, s: True)
        )

    def boundary(view):
        m = view.m
        counters = view.actor_feature(lambda i, st: st)

        def f(s):
            occ = (s[:, m.net_off : m.net_off + m.pool_size] != EMPTY).sum(1)
            return (occ <= 1) & (counters(s) <= 4).all(1)

        return f

    host = _host(bare("jax"))
    lowered = tl.lower_actor_model(
        bare("torch"), boundary=boundary, closure="exact",
        properties=lambda view: [TProp.always("ok", lambda m, s: s[:, 0] >= 0)],
    )
    assert lowered.pool_size == 2
    r = _search(lowered, 256, 14)
    assert (r.unique_state_count, r.state_count) == (host.unique_state_count(), host.state_count())
    pinned = tl.lower_actor_model(bare("torch"), boundary=boundary, closure="exact", pool_size=7)
    assert pinned.pool_size == 7


def test_small_models_parity():
    """:207 (messages to a nonexistent actor: droppable, never delivered),
    :359 (envelopes pre-loaded in the init network), :580 (random choices
    installed by on_msg and sending from on_random) and :395 (decode)."""

    def models(side):
        a = mod(side, "actor")
        am = mod(side, "actor.model")
        Exp = mod(side, "core.model").Expectation

        class Shouter(a.Actor):
            def on_start(self, id, out):
                out.send(a.Id(99), "hello")
                return "idle"

        class Sink(a.Actor):
            def on_start(self, id, out):
                return 0

            def on_msg(self, id, state, src, msg, out):
                return 1 if msg == "seed" and state == 0 else None

        class RandomReplier(a.Actor):
            def on_start(self, id, out):
                if int(id) == 0:
                    out.send(a.Id(1), "ping")
                return 0

            def on_msg(self, id, state, src, msg, out):
                if int(id) == 1 and msg == "ping" and state == 0:
                    out.choose_random("reply", ["a", "b"])
                    return 1
                if int(id) == 0 and msg in ("a", "b") and state == 0:
                    return {"a": 1, "b": 2}[msg]
                return None

            def on_random(self, id, state, random, out):
                if int(id) == 1 and state == 1:
                    out.send(a.Id(0), random)
                    return 2
                return None

        nondup = a.Network.new_unordered_nonduplicating
        return [
            am.ActorModel.new(None, None).actor(Shouter()).with_init_network(nondup())
            .with_lossy_network(am.LossyNetwork.YES)
            .property(Exp.ALWAYS, "trivial", lambda m, s: True),
            am.ActorModel.new(None, None).actor(Sink())
            .with_init_network(nondup([a.Envelope(a.Id(0), a.Id(0), "seed")]))
            .property(Exp.ALWAYS, "trivial", lambda m, s: True),
            am.ActorModel.new(None, None).actor(RandomReplier()).actor(RandomReplier())
            .with_init_network(nondup())
            .property(Exp.ALWAYS, "bounded", lambda m, s: all(st <= 2 for st in s.actor_states))
            .property(Exp.SOMETIMES, "b chosen", lambda m, s: s.actor_states[0] == 2),
        ]

    def props(view):
        v = view.actor_feature(lambda i, s: s if isinstance(s, int) else 0)
        return [TProp.always("bounded", lambda m, s: (v(s) <= 2).all(1)),
                TProp.sometimes("b chosen", lambda m, s: v(s)[:, 0] == 2)]

    trivial = lambda view: [TProp.always("trivial", lambda m, s: s[:, 0] == s[:, 0])]  # noqa: E731
    for i, (jm, tm) in enumerate(zip(models("jax"), models("torch"))):
        host = _host(jm)
        r = _search(tl.lower_actor_model(tm, properties=props if i == 2 else trivial), 64, 10)
        assert (r.unique_state_count, r.state_count) == (host.unique_state_count(), host.state_count())
        assert set(r.discoveries) == set(host.discoveries())
    assert _host(models("jax")[2]).unique_state_count() > 2
    d = ping_pong("torch", 2, False).decode(ping_pong("torch", 2, False).init_states()[0])
    assert d["actor_states"] == (0, 0) and len(d["network"]) == 1  # the initial Ping(0)


# -- validation and poison rows ---------------------------------------------------


def test_lowering_rejects_unsupported_and_unbounded():
    """:279 (an unbounded message space trips the envelope cap), :351 (an
    unbounded local state) and :666 (an unknown closure mode)."""
    from stateright_tpu_torch.actor.test_util import PingPongCfg

    with pytest.raises(tl.LoweringError):
        tl.lower_actor_model(PingPongCfg(max_nat=1).into_model().with_max_crashes(1), max_envelopes=256)
    with pytest.raises(tl.LoweringError):
        tl.lower_actor_model(PingPongCfg(max_nat=5).into_model(), max_local_states=64)
    with pytest.raises(ValueError, match="closure"):
        tl.lower_actor_model(PingPongCfg(max_nat=2).into_model(), closure="bogus")


def test_poison_rows_are_terminal():
    """:770: an uncovered pair's marker row (here the all-EMPTY row, every
    lane out of range) must not expand through clamped gathers into
    phantom states."""
    m = tl.lower_actor_model(
        ping_pong_model("torch", 3, False),
        local_boundary=lambda i, s: s <= 1,  # deliberately under-approximate
        boundary=counters_le(3),
    )
    row = torch.full((1, m.lanes), EMPTY, dtype=torch.int64)
    _succs, valid = m.expand(row)
    assert int(valid.sum()) == 0


def test_poison_scan_matches_per_row_payload_decode():
    """:1001: the vectorized scan and the scalar decode read one layout."""
    from stateright_tpu_torch.actor.test_util import PingPongCfg

    m = tl.lower_actor_model(
        PingPongCfg(max_nat=2, maintains_history=False).into_model(),
        local_boundary=lambda i, s: s <= 2,
    )
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 1 << 32, size=(64, max(m.lanes, 3)), dtype=np.uint32)
    rows[::2, 0] = EMPTY  # half the rows are poison markers
    rows[::4, 1] = (16 | 7) << 24 | 5  # capacity-flagged payloads (bit 16)
    rows[1::2, 0] = 1  # real rows
    gaps, capacity, narrow = m.poison_scan(rows)
    ref_gaps, ref_cap = set(), []
    for r in rows:
        p = m.poison_payload(r)
        if p is None:
            continue
        assert p[0] >= 0
        (ref_cap.append if p[0] & 16 else ref_gaps.add)(p)
    assert gaps == ref_gaps
    assert sorted(capacity) == sorted(ref_cap)
    assert not narrow
    j = jl.lower_actor_model(
        mod("jax", "actor.test_util").PingPongCfg(max_nat=2, maintains_history=False).into_model(),
        local_boundary=lambda i, s: s <= 2,
    )
    assert j.poison_scan(rows) == (gaps, capacity, narrow)
