"""ABD quorum register: linearizable shared memory per Attiya, Bar-Noy & Dolev,
"Sharing Memory Robustly in Message-Passing Systems"
(ref: examples/linearizable-register.rs).

Phase 1 queries a quorum for the highest (logical_clock, id) sequencer; phase 2
records the chosen (seq, value) at a quorum. Reads also perform phase 2
(read-repair) to preserve linearizability.

Golden: 544 unique states with 2 clients / 2 servers on an unordered
non-duplicating network.
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

NULL_VALUE = "\x00"


# -- internal protocol (ref: examples/linearizable-register.rs:27-34) ----------


@dataclass(frozen=True)
class Query:
    request_id: int


@dataclass(frozen=True)
class AckQuery:
    request_id: int
    seq: tuple  # (logical_clock, Id)
    value: str


@dataclass(frozen=True)
class Record:
    request_id: int
    seq: tuple
    value: str


@dataclass(frozen=True)
class AckRecord:
    request_id: int


@dataclass(frozen=True)
class Phase1:
    request_id: int
    requester_id: Id
    write: Optional[str]  # value to write, None for reads
    responses: frozenset  # {(peer_id, (seq, value))}


@dataclass(frozen=True)
class Phase2:
    request_id: int
    requester_id: Id
    read: Optional[str]  # value to return for reads, None for writes
    acks: frozenset  # {peer_id}


@dataclass(frozen=True)
class AbdState:
    seq: tuple
    val: str
    phase: Optional[object]


class AbdActor(Actor):
    """ref: examples/linearizable-register.rs:62-204"""

    def __init__(self, peers):
        self.peers = peers

    def name(self):
        return "ABD Server"

    def on_start(self, id: Id, out: Out):
        return AbdState(seq=(0, Id(id)), val=NULL_VALUE, phase=None)

    def on_msg(self, id: Id, state: AbdState, src: Id, msg, out: Out):
        if isinstance(msg, (Put, Get)) and state.phase is None:
            req_id = msg.request_id
            out.broadcast(self.peers, Internal(Query(req_id)))
            return AbdState(
                seq=state.seq,
                val=state.val,
                phase=Phase1(
                    request_id=req_id,
                    requester_id=Id(src),
                    write=msg.value if isinstance(msg, Put) else None,
                    responses=frozenset({(Id(id), (state.seq, state.val))}),
                ),
            )

        if not isinstance(msg, Internal):
            return None
        inner = msg.msg

        if isinstance(inner, Query):
            out.send(src, Internal(AckQuery(inner.request_id, state.seq, state.val)))
            return None

        if (
            isinstance(inner, AckQuery)
            and isinstance(state.phase, Phase1)
            and state.phase.request_id == inner.request_id
        ):
            ph = state.phase
            # Keyed by peer: a duplicate AckQuery from the same replica
            # replaces its previous entry rather than double-counting toward
            # the quorum (the reference keeps a HashMap<Id, (Seq, Value)>,
            # ref: examples/linearizable-register.rs:118-131).
            responses = frozenset(
                p for p in ph.responses if p[0] != Id(src)
            ) | {(Id(src), (inner.seq, inner.value))}
            if len(responses) < majority(len(self.peers) + 1):
                return AbdState(state.seq, state.val, Phase1(
                    ph.request_id, ph.requester_id, ph.write, responses
                ))
            # Quorum reached: pick max sequencer, move to phase 2
            # (sequencers are distinct, so the max is unambiguous).
            seq, val = max((sv for _p, sv in responses), key=lambda sv: sv[0])
            read = None
            if ph.write is not None:
                seq = (seq[0] + 1, Id(id))
                val = ph.write
            else:
                read = val
            out.broadcast(self.peers, Internal(Record(ph.request_id, seq, val)))
            # Self-send Record.
            new_seq, new_val = (
                (seq, val) if seq > state.seq else (state.seq, state.val)
            )
            return AbdState(
                seq=new_seq,
                val=new_val,
                phase=Phase2(
                    request_id=ph.request_id,
                    requester_id=ph.requester_id,
                    read=read,
                    acks=frozenset({Id(id)}),  # self-send AckRecord
                ),
            )

        if isinstance(inner, Record):
            out.send(src, Internal(AckRecord(inner.request_id)))
            if inner.seq > state.seq:
                return AbdState(inner.seq, inner.value, state.phase)
            return None

        if (
            isinstance(inner, AckRecord)
            and isinstance(state.phase, Phase2)
            and state.phase.request_id == inner.request_id
            and Id(src) not in state.phase.acks
        ):
            ph = state.phase
            acks = ph.acks | {Id(src)}
            if len(acks) < majority(len(self.peers) + 1):
                return AbdState(state.seq, state.val, Phase2(
                    ph.request_id, ph.requester_id, ph.read, acks
                ))
            if ph.read is not None:
                out.send(ph.requester_id, GetOk(ph.request_id, ph.read))
            else:
                out.send(ph.requester_id, PutOk(ph.request_id))
            return AbdState(state.seq, state.val, None)

        return None


@dataclass
class AbdModelCfg:
    """ref: examples/linearizable-register.rs:207-249"""

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
            model.actor(RegisterServer(AbdActor(model_peers(i, self.server_count))))
        for _ in range(self.client_count):
            model.actor(RegisterClient(put_count=1, server_count=self.server_count))
        return (
            model.with_init_network(network)
            .property(
                Expectation.ALWAYS,
                "linearizable",
                # is_consistent routes through the dedup-first verdict plane
                # (canonical fingerprints + witness-guided serialization) —
                # boolean-identical to `serialized_history() is not None`.
                lambda m, s: s.history.is_consistent(),
            )
            .property(Expectation.SOMETIMES, "value chosen", value_chosen)
            .record_msg_in(record_returns)
            .record_msg_out(record_invocations)
        )
