"""A non-replicated rewritable register: deliberately not fault-tolerant, and
linearizable only when there is a single server
(ref: examples/single-copy-register.rs).

Goldens: 93 unique states (1 server / 2 clients); 20 with 2 servers, where
both "linearizable" (counterexample) and "value chosen" (example) trigger.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..actor import Actor, Id, Network, Out
from ..actor.model import ActorModel
from ..actor.register import (
    Get,
    GetOk,
    Put,
    PutOk,
    RegisterClient,
    RegisterServer,
    record_invocations,
    record_returns,
)
from ..core.model import Expectation
from ..semantics import LinearizabilityTester, Register

NULL_VALUE = "\x00"


class SingleCopyActor(Actor):
    """ref: examples/single-copy-register.rs:15-46"""

    def on_start(self, id: Id, out: Out):
        return NULL_VALUE

    def on_msg(self, id: Id, state, src: Id, msg, out: Out):
        if isinstance(msg, Put):
            out.send(src, PutOk(msg.request_id))
            return msg.value
        if isinstance(msg, Get):
            out.send(src, GetOk(msg.request_id, state))
            return None
        return None


@dataclass
class SingleCopyModelCfg:
    """ref: examples/single-copy-register.rs:48-88"""

    client_count: int
    server_count: int = 1
    network: Network = None

    def into_model(self) -> ActorModel:
        network = (
            self.network
            if self.network is not None
            else Network.new_unordered_nonduplicating()
        )

        def value_chosen(model, state):
            for env in state.network.iter_deliverable():
                if isinstance(env.msg, GetOk) and env.msg.value != NULL_VALUE:
                    return True
            return False

        model = ActorModel.new(self, LinearizabilityTester(Register(NULL_VALUE)))
        for _ in range(self.server_count):
            model.actor(RegisterServer(SingleCopyActor()))
        for _ in range(self.client_count):
            model.actor(RegisterClient(put_count=1, server_count=self.server_count))
        return (
            model.with_init_network(network)
            .property(
                Expectation.ALWAYS,
                "linearizable",
                # Dedup-first verdict plane; boolean-identical to
                # `serialized_history() is not None`.
                lambda m, s: s.history.is_consistent(),
            )
            .property(Expectation.SOMETIMES, "value chosen", value_chosen)
            .record_msg_in(record_returns)
            .record_msg_out(record_invocations)
        )
