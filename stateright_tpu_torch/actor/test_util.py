"""Actor test fixtures (ref: src/actor/actor_test_util.rs).

The ping-pong pair exercises the full ActorModel state-space shape: message
counters, history recording, boundary, and all three property expectations.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..core.model import Expectation
from . import Actor, Id, Out
from .model import ActorModel


@dataclass(frozen=True)
class Ping:
    value: int

    def __repr__(self):
        return f"Ping({self.value})"


@dataclass(frozen=True)
class Pong:
    value: int

    def __repr__(self):
        return f"Pong({self.value})"


@dataclass
class PingPongActor(Actor):
    """ref: src/actor/actor_test_util.rs:8-51"""

    serve_to: Optional[Id] = None

    def on_start(self, id: Id, out: Out):
        if self.serve_to is not None:
            out.send(self.serve_to, Ping(0))
        return 0

    def on_msg(self, id: Id, state, src: Id, msg, out: Out):
        if isinstance(msg, Pong) and state == msg.value:
            out.send(src, Ping(msg.value + 1))
            return state + 1
        if isinstance(msg, Ping) and state == msg.value:
            out.send(src, Pong(msg.value))
            return state + 1
        return None


@dataclass
class PingPongCfg:
    """ref: src/actor/actor_test_util.rs:53-126"""

    maintains_history: bool = False
    max_nat: int = 1

    def into_model(self) -> ActorModel:
        def record_in(cfg, history, env):
            if cfg.maintains_history:
                msg_in, msg_out = history
                return (msg_in + 1, msg_out)
            return None

        def record_out(cfg, history, env):
            if cfg.maintains_history:
                msg_in, msg_out = history
                return (msg_in, msg_out + 1)
            return None

        return (
            ActorModel.new(self, (0, 0))
            .actor(PingPongActor(serve_to=Id(1)))
            .actor(PingPongActor(serve_to=None))
            .record_msg_in(record_in)
            .record_msg_out(record_out)
            .with_within_boundary(
                lambda cfg, state: all(c <= cfg.max_nat for c in state.actor_states)
            )
            .property(
                Expectation.ALWAYS,
                "delta within 1",
                lambda m, s: max(s.actor_states) - min(s.actor_states) <= 1,
            )
            .property(
                Expectation.SOMETIMES,
                "can reach max",
                lambda m, s: any(c == m.cfg.max_nat for c in s.actor_states),
            )
            .property(
                Expectation.EVENTUALLY,
                "must reach max",
                lambda m, s: any(c == m.cfg.max_nat for c in s.actor_states),
            )
            .property(
                Expectation.EVENTUALLY,
                "must exceed max",  # falsifiable due to the boundary
                lambda m, s: any(c == m.cfg.max_nat + 1 for c in s.actor_states),
            )
            .property(
                Expectation.ALWAYS,
                "#in <= #out",
                lambda m, s: s.history[0] <= s.history[1],
            )
            .property(
                Expectation.EVENTUALLY,
                "#out <= #in + 1",
                lambda m, s: s.history[1] <= s.history[0] + 1,
            )
        )
