"""Actor framework (ref: src/actor.rs) — the port's copy of the JAX
package's `actor/`.

An `Actor` is an event-driven state machine: it initializes via `on_start` and
reacts to messages/timeouts/random choices, emitting `Out` commands. Actor
systems are model checked by lowering: `ActorModel` turns them into the
generic host `Model`, and tensor/lowering.py turns that into a `TensorModel`
for the device search. They also run for real over UDP (`spawn`).

Handler convention (the Python analogue of the reference's `Cow<State>`
copy-on-write, ref: src/actor.rs:270-287): handlers receive the current state
as an immutable value and RETURN the next state, or `None` to signal "state
unchanged". A handler that returns `None` and emits no commands is a no-op,
which `ActorModel` elides from the state space (ref: src/actor/model.rs:345-347).

Heterogeneous actor systems need no special machinery here: the reference's
`choice::Choice` exists to give Rust a type for mixed actor lists
(ref: src/actor.rs:391-548); in Python `ActorModel.actor(...)` accepts any mix
of Actor implementations directly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, Tuple


class Id(int):
    """Actor identity: an index for model checking, an encoded IPv4+port for
    spawned actors (ref: src/actor.rs:109-157, src/actor/spawn.rs:10-34)."""

    def __repr__(self) -> str:
        return f"Id({int(self)})"

    @staticmethod
    def vec_from(ids: Iterable) -> list["Id"]:
        return [Id(i) for i in ids]

    @staticmethod
    def from_addr(ip: str, port: int) -> "Id":
        """Encode an IPv4 address + port into an Id (spawn runtime)."""
        parts = [int(p) for p in ip.split(".")]
        ip_num = (parts[0] << 24) | (parts[1] << 16) | (parts[2] << 8) | parts[3]
        return Id((ip_num << 16) | port)

    def to_addr(self) -> Tuple[str, int]:
        """Decode an Id into (ip, port) (spawn runtime)."""
        v = int(self)
        port = v & 0xFFFF
        ip_num = v >> 16
        ip = f"{(ip_num >> 24) & 255}.{(ip_num >> 16) & 255}.{(ip_num >> 8) & 255}.{ip_num & 255}"
        return ip, port


# -- commands (ref: src/actor.rs:159-266) -------------------------------------


@dataclass(frozen=True)
class Send:
    dst: Id
    msg: Any


@dataclass(frozen=True)
class SetTimer:
    timer: Any
    duration: Tuple[float, float]  # (lo, hi) seconds; ignored by the checker


@dataclass(frozen=True)
class CancelTimer:
    timer: Any


@dataclass(frozen=True)
class ChooseRandom:
    key: str
    choices: tuple


class Out:
    """Collects commands emitted by an actor handler (ref: src/actor.rs:172-266)."""

    def __init__(self):
        self.commands: list = []

    def send(self, recipient: Id, msg) -> None:
        self.commands.append(Send(Id(recipient), msg))

    def broadcast(self, recipients: Iterable[Id], msg) -> None:
        for r in recipients:
            self.send(r, msg)

    def set_timer(self, timer, duration: Tuple[float, float]) -> None:
        self.commands.append(SetTimer(timer, tuple(duration)))

    def cancel_timer(self, timer) -> None:
        self.commands.append(CancelTimer(timer))

    def choose_random(self, key: str, choices: list) -> None:
        """Record a nondeterministic choice, creating a branch in the search
        tree keyed by `key` (later calls with the same key overwrite)."""
        self.commands.append(ChooseRandom(str(key), tuple(choices)))

    def remove_random(self, key: str) -> None:
        self.commands.append(ChooseRandom(str(key), ()))

    def append(self, other: "Out") -> None:
        self.commands.extend(other.commands)
        other.commands.clear()

    def __iter__(self):
        return iter(self.commands)

    def __len__(self):
        return len(self.commands)

    def __repr__(self):
        return repr(self.commands)


def model_timeout() -> Tuple[float, float]:
    """Timer range for model checking — durations are abstracted away entirely
    (ref: src/actor/model.rs:76-78)."""
    return (0.0, 0.0)


def model_peers(self_ix: int, count: int) -> list[Id]:
    """Peer ids for actor `self_ix` in a `count`-actor system
    (ref: src/actor/model.rs:82-87)."""
    return [Id(j) for j in range(count) if j != self_ix]


def majority(cluster_size: int) -> int:
    """Node count constituting a majority (ref: src/actor.rs:605-607)."""
    return cluster_size // 2 + 1


def peer_ids(self_id: Id, other_ids: Iterable[Id]):
    """All of `other_ids` except `self_id` (ref: src/actor.rs:610-615)."""
    return (i for i in other_ids if i != self_id)


class Actor:
    """Event-driven state machine (ref: src/actor.rs:293-389).

    Handlers return the next state, or None for "unchanged"."""

    def on_start(self, id: Id, out: Out):
        """Return the initial state, optionally emitting commands."""
        raise NotImplementedError

    def on_msg(self, id: Id, state, src: Id, msg, out: Out):
        return None  # no-op by default

    def on_timeout(self, id: Id, state, timer, out: Out):
        return None  # no-op by default

    def on_random(self, id: Id, state, random, out: Out):
        return None  # no-op by default

    def name(self) -> str:
        return ""


@dataclass
class ScriptedActor(Actor):
    """Sends a series of messages in sequence, waiting for any delivery between
    each — useful for driving actor systems under test (the reference implements
    `Actor` for `Vec<(Id, Msg)>`, ref: src/actor.rs:565-602)."""

    script: list  # [(dst_id, msg), ...]

    def on_start(self, id: Id, out: Out):
        if self.script:
            dst, msg = self.script[0]
            out.send(dst, msg)
            return 1
        return 0

    def on_msg(self, id: Id, state, src: Id, msg, out: Out):
        if state < len(self.script):
            dst, m = self.script[state]
            out.send(dst, m)
            return state + 1
        return None


# Re-exports for a flat `stateright_tpu.actor` namespace mirroring the
# reference's `use stateright::actor::*`.
from .network import Envelope, Network  # noqa: E402
from .model import (  # noqa: E402
    ActorModel,
    ActorModelAction,
    ActorModelState,
    Deliver,
    DropEnv,
    Timeout,
    Crash,
    SelectRandom,
    LossyNetwork,
)

__all__ = [
    "Id",
    "Out",
    "Send",
    "SetTimer",
    "CancelTimer",
    "ChooseRandom",
    "Actor",
    "ScriptedActor",
    "model_timeout",
    "model_peers",
    "majority",
    "peer_ids",
    "Envelope",
    "Network",
    "ActorModel",
    "ActorModelAction",
    "ActorModelState",
    "Deliver",
    "DropEnv",
    "Timeout",
    "Crash",
    "SelectRandom",
    "LossyNetwork",
]
