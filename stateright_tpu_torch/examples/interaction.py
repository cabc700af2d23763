"""Modeling external/user input with a driver actor
(ref: examples/interaction.rs).

A Client actor uses timers to inject increment requests into a Counter actor
and then query it; `target_max_depth(30)` bounds the otherwise unbounded
space. The system is heterogeneous (two different actor types) — the
reference needs the `choice!` machinery for this; here the actor list is
simply mixed.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..actor import Actor, Id, Out, model_timeout
from ..actor.model import ActorModel
from ..core.model import Expectation


@dataclass(frozen=True)
class IncrementRequest:
    amount: int


@dataclass(frozen=True)
class ReportRequest:
    pass


@dataclass(frozen=True)
class ReplyCount:
    count: int


@dataclass(frozen=True)
class CounterState:
    addr: Id
    counter: int


@dataclass(frozen=True)
class InputState:
    wait_cycles: int
    success: bool


CLIENT_INPUT, CLIENT_QUERY = "ClientInput", "ClientQuery"


class Counter(Actor):
    """ref: examples/interaction.rs:88-131"""

    def __init__(self, initial_state: CounterState):
        self.initial_state = initial_state

    def name(self):
        return "Counter"

    def on_start(self, id: Id, out: Out):
        return self.initial_state

    def on_msg(self, id: Id, state, src: Id, msg, out: Out):
        if isinstance(msg, IncrementRequest):
            return CounterState(state.addr, state.counter + msg.amount)
        if isinstance(msg, ReportRequest):
            out.send(src, ReplyCount(state.counter))
            return None
        return None


class Client(Actor):
    """ref: examples/interaction.rs:133-205"""

    def __init__(self, threshold: int, counter_addr: Id):
        self.threshold = threshold
        self.counter_addr = counter_addr

    def name(self):
        return "Client"

    def on_start(self, id: Id, out: Out):
        out.set_timer(CLIENT_INPUT, model_timeout())
        return InputState(wait_cycles=0, success=False)

    def on_msg(self, id: Id, state, src: Id, msg, out: Out):
        if isinstance(msg, ReplyCount) and msg.count >= self.threshold:
            return InputState(state.wait_cycles, True)
        return None

    def on_timeout(self, id: Id, state, timer, out: Out):
        if timer == CLIENT_INPUT:
            # Query after incrementing.
            out.set_timer(CLIENT_QUERY, model_timeout())
            out.send(self.counter_addr, IncrementRequest(3))
            return InputState(state.wait_cycles + 1, state.success)
        if timer == CLIENT_QUERY:
            out.send(self.counter_addr, ReportRequest())
            return InputState(state.wait_cycles + 1, state.success)
        return None


def build_model(threshold: int = 3) -> ActorModel:
    """ref: examples/interaction.rs:20-46"""

    def success_reached(model, state):
        return any(
            isinstance(s, InputState) and s.success for s in state.actor_states
        )

    return (
        ActorModel.new(None, 0)
        .actor(Client(threshold=threshold, counter_addr=Id(1)))
        .actor(Counter(CounterState(addr=Id(1), counter=0)))
        .property(Expectation.EVENTUALLY, "success", success_reached)
    )
