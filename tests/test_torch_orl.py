"""The port's ordered reliable link and write-once-register client
(stateright_tpu_torch/actor/{ordered_reliable_link,write_once_register}.py)
on the CPU: the mirrors of the five ORL tests of tests/test_orl_and_utils.py
(its utils cases are mirrored in tests/test_torch_host_checkers.py), each
held against the JAX package, plus a write-once-register client model.

The ORL is proved by model checking, the reference's own strategy
(ref: src/actor/ordered_reliable_link.rs:215-325): under a lossy duplicating
network, delivery to the wrapped actor must stay an in-order duplicate-free
prefix, and full delivery must be reachable. The host BFS counts and the
discovery paths must be the JAX package's."""

from dataclasses import dataclass

import pytest

import stateright_tpu.actor as ja
import stateright_tpu.actor.ordered_reliable_link as jorl
import stateright_tpu.actor.write_once_register as jwor
import stateright_tpu.core.model as jcm
import stateright_tpu.semantics as jsem
import stateright_tpu_torch.actor as pa
import stateright_tpu_torch.actor.ordered_reliable_link as porl
import stateright_tpu_torch.actor.write_once_register as pwor
import stateright_tpu_torch.core.model as pcm
import stateright_tpu_torch.semantics as psem

MSGS = ("a", "b")
SIDES = {
    "port": (pa, porl, pcm, pwor, psem),
    "jax": (ja, jorl, jcm, jwor, jsem),
}


def _actors(a):
    @dataclass
    class Sender(a.Actor):
        msgs: tuple

        def on_start(self, id, out):
            for m in self.msgs:
                out.send(a.Id(1), m)
            return "sender"

    class Recv(a.Actor):
        def on_start(self, id, out):
            return ()

        def on_msg(self, id, state, src, msg, out):
            return state + (msg,)

    return Sender, Recv


def _orl_model(side, lossy: bool):
    a, orl, cm, _, _ = SIDES[side]
    Sender, Recv = _actors(a)

    def received(state):
        return state.actor_states[1].wrapped

    return (
        a.ActorModel.new()
        .actor(orl.ActorWrapper(Sender(MSGS)))
        .actor(orl.ActorWrapper(Recv()))
        .with_init_network(a.Network.new_unordered_duplicating())
        .with_lossy_network(lossy)
        .property(
            cm.Expectation.ALWAYS,
            "delivered in order without dups",
            lambda m, s: received(s) == MSGS[: len(received(s))],
        )
        .property(
            cm.Expectation.SOMETIMES,
            "fully delivered",
            lambda m, s: received(s) == MSGS,
        )
    )


def _bfs(side, model):
    c = model.checker().spawn_bfs().join()
    paths = {name: [repr(x) for x in p.actions()] for name, p in c.discoveries().items()}
    return c, (c.state_count(), c.unique_state_count(), c.max_depth(), paths)


@pytest.mark.parametrize("lossy", [True, False], ids=["lossy_duplicating", "lossless"])
def test_orl_guarantees_hold_with_the_jax_counts(lossy):
    got = {}
    for side in SIDES:
        c, got[side] = _bfs(side, _orl_model(side, lossy))
        c.assert_properties()
    assert got["port"] == got["jax"]


def test_orl_acks_shrink_pending():
    out_of = {}
    for side, (a, orl, _, _, _) in SIDES.items():
        Sender, _Recv = _actors(a)
        w = orl.ActorWrapper(Sender(MSGS))
        state = w.on_start(a.Id(0), a.Out())
        assert [k for k, _ in state.pending_ack] == [(a.Id(1), 1), (a.Id(1), 2)]
        # Ack for seq 1 removes it; a duplicate ack is a no-op (None).
        state2 = w.on_msg(a.Id(0), state, a.Id(1), orl.Ack(1), a.Out())
        assert [k for k, _ in state2.pending_ack] == [(a.Id(1), 2)]
        assert w.on_msg(a.Id(0), state2, a.Id(1), orl.Ack(1), a.Out()) is None
        out_of[side] = (repr(state), repr(state2), w.name())
    assert out_of["port"] == out_of["jax"]


def test_orl_receiver_dedups_and_always_acks():
    out_of = {}
    for side, (a, orl, _, _, _) in SIDES.items():
        _Sender, Recv = _actors(a)
        w = orl.ActorWrapper(Recv())
        state = w.on_start(a.Id(1), a.Out())
        out = a.Out()
        state = w.on_msg(a.Id(1), state, a.Id(0), orl.Deliver(1, "a"), out)
        assert state.wrapped == ("a",)
        # Redelivery: dropped (None) but still acked.
        out2 = a.Out()
        assert w.on_msg(a.Id(1), state, a.Id(0), orl.Deliver(1, "a"), out2) is None
        assert any(isinstance(c.msg, orl.Ack) for c in out2.commands)
        # Out-of-order (seq 3 before 2): dropped.
        assert w.on_msg(a.Id(1), state, a.Id(0), orl.Deliver(3, "c"), a.Out()) is None
        out_of[side] = (repr(state), repr(out), repr(out2))
    assert out_of["port"] == out_of["jax"]


def test_orl_resend_retransmits_pending():
    out_of = {}
    for side, (a, orl, _, _, _) in SIDES.items():
        Sender, _Recv = _actors(a)
        w = orl.ActorWrapper(Sender(MSGS))
        state = w.on_start(a.Id(0), a.Out())
        out = a.Out()
        assert w.on_timeout(a.Id(0), state, orl.Resend(), out) is None
        sends = [c.msg for c in out.commands
                 if isinstance(c, a.Send) and isinstance(c.msg, orl.Deliver)]
        assert sends == [orl.Deliver(1, "a"), orl.Deliver(2, "b")]
        inner = orl.InnerTimer("t")
        out_of[side] = (repr(out), repr(sends), repr(inner), repr(orl.Resend()))
    assert out_of["port"] == out_of["jax"]


# -- the write-once register client ---------------------------------------------


def _wor_model(side, client_count: int):
    """One write-once register server and `client_count` WORegisterClients,
    each Putting its own value and then Getting: every Put after the first
    fails, so `PutFail` is delivered and recorded as `WriteFail`."""
    a, _, cm, wor, sem = SIDES[side]

    class WOServer(a.Actor):
        def on_start(self, id, out):
            return None

        def on_msg(self, id, state, src, msg, out):
            if isinstance(msg, wor.Put):
                if state is None or state == msg.value:
                    out.send(src, wor.PutOk(msg.request_id))
                    return msg.value
                out.send(src, wor.PutFail(msg.request_id))
                return None
            if isinstance(msg, wor.Get):
                out.send(src, wor.GetOk(msg.request_id, state))
            return None

    def put_failed(model, s):
        return any(isinstance(env.msg, wor.PutFail) for env in s.network.iter_deliverable())

    model = a.ActorModel.new(None, sem.LinearizabilityTester(sem.WORegister()))
    model.actor(wor.RegisterServer(WOServer()))
    for _ in range(client_count):
        model.actor(wor.WORegisterClient(put_count=1, server_count=1))
    return (
        model.with_init_network(a.Network.new_unordered_nonduplicating())
        .property(cm.Expectation.ALWAYS, "linearizable",
                  lambda m, s: s.history.serialized_history() is not None)
        .property(cm.Expectation.SOMETIMES, "put failed", put_failed)
        .property(cm.Expectation.SOMETIMES, "all done",
                  lambda m, s: all(getattr(x, "awaiting", 0) is None
                                   for x in s.actor_states[1:]))
        .record_msg_in(wor.record_returns)
        .record_msg_out(wor.record_invocations)
    )


def test_wor_client_model_matches_the_jax_package():
    got = {}
    for side in SIDES:
        c, got[side] = _bfs(side, _wor_model(side, 2))
        c.assert_properties()  # linearizable holds; PutFail and completion reached
        assert set(got[side][3]) == {"put failed", "all done"}
    assert got["port"] == got["jax"]
    assert repr(pwor.PutFail(3)) == repr(jwor.PutFail(3)) == "PutFail(3)"
