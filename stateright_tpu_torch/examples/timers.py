"""Timer-driven ping actors (ref: examples/timers.rs).

Each pinger sets three recurring timers; Even/Odd timers ping even/odd peers,
NoOp renews itself (and is therefore elided by no-op-with-timer detection).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..actor import Actor, Id, Network, Out, model_peers, model_timeout
from ..actor.model import ActorModel
from ..core.model import Expectation

PING, PONG = "Ping", "Pong"
EVEN, ODD, NOOP = "Even", "Odd", "NoOp"


@dataclass(frozen=True)
class PingerState:
    sent: int
    received: int


class PingerActor(Actor):
    """ref: examples/timers.rs:31-98"""

    def __init__(self, peer_ids):
        self.peer_ids = peer_ids

    def name(self):
        return "Pinger"

    def on_start(self, id: Id, out: Out):
        out.set_timer(EVEN, model_timeout())
        out.set_timer(ODD, model_timeout())
        out.set_timer(NOOP, model_timeout())
        return PingerState(sent=0, received=0)

    def on_msg(self, id: Id, state, src: Id, msg, out: Out):
        if msg == PING:
            out.send(src, PONG)
            return None
        if msg == PONG:
            return PingerState(state.sent, state.received + 1)
        return None

    def on_timeout(self, id: Id, state, timer, out: Out):
        if timer == EVEN:
            out.set_timer(EVEN, model_timeout())
            sent = state.sent
            for dst in self.peer_ids:
                if int(dst) % 2 == 0:
                    sent += 1
                    out.send(dst, PING)
            return PingerState(sent, state.received) if sent != state.sent else None
        if timer == ODD:
            out.set_timer(ODD, model_timeout())
            sent = state.sent
            for dst in self.peer_ids:
                if int(dst) % 2 != 0:
                    sent += 1
                    out.send(dst, PING)
            return PingerState(sent, state.received) if sent != state.sent else None
        # NOOP: renew only — elided by no-op-with-timer detection.
        out.set_timer(NOOP, model_timeout())
        return None


@dataclass
class PingerModelCfg:
    """ref: examples/timers.rs:100-117"""

    server_count: int = 3
    network: Network = None

    def into_model(self) -> ActorModel:
        network = (
            self.network
            if self.network is not None
            else Network.new_unordered_nonduplicating()
        )
        model = ActorModel.new(self, None)
        for i in range(self.server_count):
            model.actor(PingerActor(model_peers(i, self.server_count)))
        return model.with_init_network(network).property(
            Expectation.ALWAYS, "true", lambda m, s: True
        )
