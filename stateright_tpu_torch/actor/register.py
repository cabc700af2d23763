"""Register-like actor interface and reusable client harness
(ref: src/actor/register.rs).

`RegisterMsg` defines the external protocol (Put/Get + oks, plus Internal for
the system's own messages). `RegisterActor` wraps a server actor under test
with scripted clients that Put `put_count` times round-robin across servers and
then Get. `record_invocations`/`record_returns` wire the message traffic into a
`ConsistencyTester` carried as the ActorModel history.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from ..semantics.register import Read, ReadOk, Write, WriteOk
from . import Actor, Id, Out


# -- protocol messages (ref: src/actor/register.rs:17-31) ----------------------


@dataclass(frozen=True)
class Internal:
    msg: Any

    def __repr__(self):
        return f"Internal({self.msg!r})"


@dataclass(frozen=True)
class Put:
    request_id: int
    value: Any

    def __repr__(self):
        return f"Put({self.request_id}, {self.value!r})"


@dataclass(frozen=True)
class Get:
    request_id: int

    def __repr__(self):
        return f"Get({self.request_id})"


@dataclass(frozen=True)
class PutOk:
    request_id: int

    def __repr__(self):
        return f"PutOk({self.request_id})"


@dataclass(frozen=True)
class GetOk:
    request_id: int
    value: Any

    def __repr__(self):
        return f"GetOk({self.request_id}, {self.value!r})"


# -- history recorders (ref: src/actor/register.rs:38-91) ----------------------


def record_invocations(cfg, history, env):
    """Pass to `ActorModel.record_msg_out`: records Read on Get, Write on Put."""
    if isinstance(env.msg, Get):
        return history.on_invoke(env.src, Read())
    if isinstance(env.msg, Put):
        return history.on_invoke(env.src, Write(env.msg.value))
    return None


def record_returns(cfg, history, env):
    """Pass to `ActorModel.record_msg_in`: records ReadOk on GetOk, WriteOk on
    PutOk."""
    if isinstance(env.msg, GetOk):
        return history.on_return(env.dst, ReadOk(env.msg.value))
    if isinstance(env.msg, PutOk):
        return history.on_return(env.dst, WriteOk())
    return None


# -- client/server harness (ref: src/actor/register.rs:93-275) -----------------


@dataclass(frozen=True)
class ClientState:
    awaiting: Any  # request id or None
    op_count: int

    def __repr__(self):
        return f"Client(awaiting={self.awaiting!r}, op_count={self.op_count})"


@dataclass(frozen=True)
class ServerState:
    state: Any

    def __repr__(self):
        return f"Server({self.state!r})"


class RegisterClient(Actor):
    """A client that Puts `put_count` values round-robin across the servers
    (which must occupy actor ids 0..server_count) and then issues a Get.
    Value scheme matches the reference: first Put sends chr(ord('A') + k) for
    client k, subsequent Puts send chr(ord('Z') - k)
    (ref: src/actor/register.rs:145-237)."""

    def __init__(self, put_count: int, server_count: int):
        self.put_count = put_count
        self.server_count = server_count

    def name(self) -> str:
        return "Client"

    def on_start(self, id: Id, out: Out):
        index = int(id)
        if index < self.server_count:
            raise RuntimeError(
                "RegisterClient actors must be added to the model after servers."
            )
        if self.put_count == 0:
            return ClientState(awaiting=None, op_count=0)
        unique_request_id = index  # 1 * index
        value = chr(ord("A") + index - self.server_count)
        out.send(Id(index % self.server_count), Put(unique_request_id, value))
        return ClientState(awaiting=unique_request_id, op_count=1)

    def on_msg(self, id: Id, state, src: Id, msg, out: Out):
        if not isinstance(state, ClientState) or state.awaiting is None:
            return None
        index = int(id)
        if isinstance(msg, PutOk) and msg.request_id == state.awaiting:
            unique_request_id = (state.op_count + 1) * index
            if state.op_count < self.put_count:
                value = chr(ord("Z") - (index - self.server_count))
                out.send(
                    Id((index + state.op_count) % self.server_count),
                    Put(unique_request_id, value),
                )
            else:
                out.send(
                    Id((index + state.op_count) % self.server_count),
                    Get(unique_request_id),
                )
            return ClientState(awaiting=unique_request_id, op_count=state.op_count + 1)
        if isinstance(msg, GetOk) and msg.request_id == state.awaiting:
            return ClientState(awaiting=None, op_count=state.op_count + 1)
        return None


class RegisterServer(Actor):
    """Wraps a server actor under test so its state is tagged distinctly from
    client states (the reference's RegisterActor::Server variant)."""

    def __init__(self, server_actor: Actor):
        self.server_actor = server_actor

    def name(self) -> str:
        return self.server_actor.name() or "Server"

    def on_start(self, id: Id, out: Out):
        return ServerState(self.server_actor.on_start(id, out))

    def on_msg(self, id: Id, state, src: Id, msg, out: Out):
        inner = self.server_actor.on_msg(id, state.state, src, msg, out)
        return None if inner is None else ServerState(inner)

    def on_timeout(self, id: Id, state, timer, out: Out):
        inner = self.server_actor.on_timeout(id, state.state, timer, out)
        return None if inner is None else ServerState(inner)

    def on_random(self, id: Id, state, random, out: Out):
        inner = self.server_actor.on_random(id, state.state, random, out)
        return None if inner is None else ServerState(inner)
