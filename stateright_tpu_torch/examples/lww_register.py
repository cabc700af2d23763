"""Last-write-wins register: a state-based CRDT using `choose_random` /
`on_random` nondeterminism for clock skew and value selection
(ref: examples/lww-register.rs).

The "eventually consistent" property is the CRDT flavor: whenever the network
is quiescent, all replicas agree (transient agreement doesn't count, hence an
`always` over quiescent states rather than an `eventually`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..actor import Actor, Id, Network, Out
from ..actor.model import ActorModel
from ..core.model import Expectation

VALUES = ("A", "B", "C")


@dataclass(frozen=True)
class LwwRegister:
    value: str
    timestamp: int
    updater_id: int

    @staticmethod
    def merge(a: "LwwRegister", b: "LwwRegister") -> "LwwRegister":
        return a if (a.timestamp, a.updater_id) > (b.timestamp, b.updater_id) else b


@dataclass(frozen=True)
class SetValue:
    value: str


@dataclass(frozen=True)
class SetTime:
    time: int


@dataclass(frozen=True)
class LwwActorState:
    register: Optional[LwwRegister]
    local_clock: int
    maximum_used_clock: int


class LwwActor(Actor):
    """ref: examples/lww-register.rs:64-150"""

    def __init__(self, peers):
        self.peers = peers

    def name(self):
        return "LWW"

    def _populate_choices(self, out: Out, time: int) -> None:
        out.choose_random(
            "node_action",
            [SetValue(v) for v in VALUES]
            + [SetTime(time + 1), SetTime(max(0, time - 1))],
        )

    def on_start(self, id: Id, out: Out):
        state = LwwActorState(None, 1000, 1000)
        self._populate_choices(out, state.local_clock)
        return state

    def on_random(self, id: Id, state: LwwActorState, random, out: Out):
        if isinstance(random, SetValue):
            if state.register is not None:
                clock = max(state.local_clock, state.maximum_used_clock + 1)
                register = LwwRegister(random.value, clock, int(id))
                new_state = LwwActorState(register, state.local_clock, clock)
            else:
                register = LwwRegister(random.value, state.local_clock, int(id))
                new_state = LwwActorState(
                    register, state.local_clock, state.maximum_used_clock
                )
            out.broadcast(self.peers, register)
            self._populate_choices(out, new_state.local_clock)
            return new_state
        # SetTime
        new_state = LwwActorState(
            state.register, random.time, state.maximum_used_clock
        )
        self._populate_choices(out, new_state.local_clock)
        return new_state

    def on_msg(self, id: Id, state: LwwActorState, src: Id, msg, out: Out):
        # Always report a (possibly identical) new state: the reference marks
        # the Cow owned unconditionally here, so delivery is never elided as a
        # no-op and the message is always consumed from the network
        # (ref: examples/lww-register.rs:131-149).
        if state.register is not None:
            merged = LwwRegister.merge(state.register, msg)
            return LwwActorState(merged, state.local_clock, state.maximum_used_clock)
        return LwwActorState(msg, state.local_clock, state.maximum_used_clock)


def build_model(num_actors: int) -> ActorModel:
    """ref: examples/lww-register.rs:152-186"""
    nodes = [Id(i) for i in range(num_actors)]

    def eventually_consistent(model, state):
        if len(state.network) == 0:
            regs = [s.register for s in state.actor_states]
            return all(r == regs[0] for r in regs)
        return True

    model = ActorModel.new(None, None)
    for _ in range(num_actors):
        model.actor(LwwActor(peers=nodes))
    return model.with_init_network(
        Network.new_unordered_nonduplicating()
    ).property(Expectation.ALWAYS, "eventually consistent", eventually_consistent)
