"""Single Decree Paxos as actors, validated with a linearizability-tested
register (ref: examples/paxos.rs).

A ballot is (round, leader_id); a proposal is (request_id, requester_id,
value). Phase 1 locks earlier terms and learns previously accepted proposals;
phase 2 drives the chosen proposal to a quorum. The model's history is a
`LinearizabilityTester` fed by the Put/Get/PutOk/GetOk traffic, and the
"linearizable" property simply asks for a valid serialization — the
integration pattern from SURVEY.md §2.5.

Golden: 16,668 unique states with 2 clients / 3 servers on an unordered
non-duplicating network (ref: examples/paxos.rs:327,351).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..actor import Actor, Id, Network, Out, majority, model_peers
from ..actor.model import ActorModel
from ..actor.register import (
    Get,
    GetOk,
    Internal,
    Put,
    PutOk,
    RegisterClient,
    RegisterServer,
    record_invocations,
    record_returns,
)
from ..core.model import Expectation
from ..semantics import LinearizabilityTester, Register

NULL_VALUE = "\x00"  # Value::default() in the reference


# -- internal protocol messages (ref: examples/paxos.rs:66-89) -----------------


@dataclass(frozen=True)
class Prepare:
    ballot: tuple

    def __repr__(self):
        return f"Prepare(ballot={self.ballot!r})"


@dataclass(frozen=True)
class Prepared:
    ballot: tuple
    last_accepted: Optional[tuple]

    def __repr__(self):
        return f"Prepared(ballot={self.ballot!r}, last_accepted={self.last_accepted!r})"


@dataclass(frozen=True)
class Accept:
    ballot: tuple
    proposal: tuple

    def __repr__(self):
        return f"Accept(ballot={self.ballot!r}, proposal={self.proposal!r})"


@dataclass(frozen=True)
class Accepted:
    ballot: tuple

    def __repr__(self):
        return f"Accepted(ballot={self.ballot!r})"


@dataclass(frozen=True)
class Decided:
    ballot: tuple
    proposal: tuple

    def __repr__(self):
        return f"Decided(ballot={self.ballot!r}, proposal={self.proposal!r})"


@dataclass(frozen=True)
class PaxosState:
    """ref: examples/paxos.rs:91-104. `prepares` is a frozenset of
    (peer_id, last_accepted) pairs (at most one entry per peer per ballot);
    `accepts` is a frozenset of peer ids."""

    ballot: tuple
    proposal: Optional[tuple]
    prepares: frozenset
    accepts: frozenset
    accepted: Optional[tuple]
    is_decided: bool


def _max_last_accepted(prepares: frozenset):
    """Highest previously-accepted (ballot, proposal) among prepare replies;
    None ranks lowest (the reference's Option<..>::max,
    ref: examples/paxos.rs:211-217)."""
    best = None
    for _src, last_accepted in prepares:
        if last_accepted is not None and (best is None or last_accepted > best):
            best = last_accepted
    return best


class PaxosActor(Actor):
    """ref: examples/paxos.rs:106-254"""

    def __init__(self, peer_ids):
        self.peer_ids = peer_ids

    def name(self):
        return "Paxos Server"

    def on_start(self, id: Id, out: Out):
        return PaxosState(
            ballot=(0, Id(0)),
            proposal=None,
            prepares=frozenset(),
            accepts=frozenset(),
            accepted=None,
            is_decided=False,
        )

    def on_msg(self, id: Id, state: PaxosState, src: Id, msg, out: Out):
        if state.is_decided:
            # Only reply once a decision is known locally; an undecided
            # server stays silent (ref: examples/paxos.rs:145-157). The
            # accepted-is-set guard keeps the handler TOTAL (required by the
            # generic device lowering, whose closure pass over-approximates
            # reachable local states): a decided server always has an
            # accepted proposal on every globally reachable path.
            if isinstance(msg, Get) and state.accepted is not None:
                _ballot, (_req, _src, value) = state.accepted
                out.send(src, GetOk(msg.request_id, value))
            return None

        if isinstance(msg, Put) and state.proposal is None:
            ballot = (state.ballot[0] + 1, Id(id))
            proposal = (msg.request_id, Id(src), msg.value)
            out.broadcast(self.peer_ids, Internal(Prepare(ballot)))
            return PaxosState(
                ballot=ballot,
                proposal=proposal,
                # Simulated Prepare/Prepared self-sends.
                prepares=frozenset({(Id(id), state.accepted)}),
                accepts=frozenset(),
                accepted=state.accepted,
                is_decided=False,
            )

        if isinstance(msg, Internal):
            inner = msg.msg
            if isinstance(inner, Prepare) and state.ballot < inner.ballot:
                out.send(
                    src,
                    Internal(Prepared(inner.ballot, state.accepted)),
                )
                return PaxosState(
                    ballot=inner.ballot,
                    proposal=state.proposal,
                    prepares=state.prepares,
                    accepts=state.accepts,
                    accepted=state.accepted,
                    is_decided=False,
                )
            if isinstance(inner, Prepared) and inner.ballot == state.ballot:
                prepares = state.prepares | {(Id(src), inner.last_accepted)}
                if len(prepares) == majority(len(self.peer_ids) + 1):
                    # Leadership handoff: favor the most recently accepted
                    # proposal from the prepare quorum, else the client's
                    # (ref: examples/paxos.rs:194-226).
                    prev = _max_last_accepted(prepares)
                    proposal = prev[1] if prev is not None else state.proposal
                    out.broadcast(
                        self.peer_ids, Internal(Accept(inner.ballot, proposal))
                    )
                    return PaxosState(
                        ballot=state.ballot,
                        proposal=proposal,
                        prepares=prepares,
                        # Simulated Accept/Accepted self-sends.
                        accepts=frozenset({Id(id)}),
                        accepted=(inner.ballot, proposal),
                        is_decided=False,
                    )
                return PaxosState(
                    ballot=state.ballot,
                    proposal=state.proposal,
                    prepares=prepares,
                    accepts=state.accepts,
                    accepted=state.accepted,
                    is_decided=False,
                )
            if isinstance(inner, Accept) and state.ballot <= inner.ballot:
                out.send(src, Internal(Accepted(inner.ballot)))
                return PaxosState(
                    ballot=inner.ballot,
                    proposal=state.proposal,
                    prepares=state.prepares,
                    accepts=state.accepts,
                    accepted=(inner.ballot, inner.proposal),
                    is_decided=False,
                )
            if isinstance(inner, Accepted) and inner.ballot == state.ballot:
                accepts = state.accepts | {Id(src)}
                if len(accepts) == majority(len(self.peer_ids) + 1):
                    proposal = state.proposal
                    out.broadcast(
                        self.peer_ids, Internal(Decided(inner.ballot, proposal))
                    )
                    request_id, requester_id, _value = proposal
                    out.send(requester_id, PutOk(request_id))
                    return PaxosState(
                        ballot=state.ballot,
                        proposal=proposal,
                        prepares=state.prepares,
                        accepts=accepts,
                        accepted=state.accepted,
                        is_decided=True,
                    )
                return PaxosState(
                    ballot=state.ballot,
                    proposal=state.proposal,
                    prepares=state.prepares,
                    accepts=accepts,
                    accepted=state.accepted,
                    is_decided=False,
                )
            if isinstance(inner, Decided):
                return PaxosState(
                    ballot=inner.ballot,
                    proposal=state.proposal,
                    prepares=state.prepares,
                    accepts=state.accepts,
                    accepted=(inner.ballot, inner.proposal),
                    is_decided=True,
                )
        return None


@dataclass
class PaxosModelCfg:
    """ref: examples/paxos.rs:256-298"""

    client_count: int
    server_count: int = 3
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
        for i in range(self.server_count):
            model.actor(
                RegisterServer(PaxosActor(model_peers(i, self.server_count)))
            )
        for _ in range(self.client_count):
            model.actor(
                RegisterClient(put_count=1, server_count=self.server_count)
            )
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
