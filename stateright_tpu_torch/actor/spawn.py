"""Real-world actor execution over UDP (ref: src/actor/spawn.rs) — the
port's copy of the JAX package's `actor/spawn.py`.

One thread per actor; each binds the UDP socket encoded in its `Id`, JSON-serdes
messages, and multiplexes socket reads with a timer wheel (`next_interrupts`:
interrupt → deadline) via socket timeouts, mirroring the reference's event loop
(ref: src/actor/spawn.rs:64-154). Model-checked `choose_random` commands become
delayed interrupts resolved with a real RNG (ref: src/actor/spawn.rs:163-232).

Message serde: by default messages are encoded as JSON with a `{"__type__":
ClassName, ...fields}` convention for dataclasses (plus native JSON scalars /
lists). Pass a `msg_types` registry (class list) for decoding, or override
`serialize`/`deserialize` entirely — the reference likewise takes explicit
serde functions. The bytes are the JAX package's for the same values, so a
port actor and a JAX actor talk over one socket pair.

Stopping: `spawn(..., block=False)` returns `(threads, stop_event)`; a
runtime sees `stop_event` between socket reads, which time out after at most
0.5 s, so set the event and join each thread with a deadline.
"""

from __future__ import annotations

import dataclasses
import json
import random
import socket
import threading
import time
from typing import Callable, Iterable, Optional, Tuple

from . import Actor, CancelTimer, ChooseRandom, Id, Out, Send, SetTimer

_MAX_DATAGRAM = 65_507


def _encode_value(v):
    # Tagged forms keep every container/identity type EXACT through the
    # round trip (the reference's serde_json on typed structs does the same,
    # ref: src/actor/spawn.rs:64-130): tuples are not degraded to lists,
    # frozensets/sets survive, and Id stays Id.
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {
            "__type__": type(v).__name__,
            **{
                f.name: _encode_value(getattr(v, f.name))
                for f in dataclasses.fields(v)
            },
        }
    if isinstance(v, Id):
        return {"__id__": int(v)}
    if isinstance(v, bool) or v is None or isinstance(v, (str, float)):
        return v
    if isinstance(v, int):
        return v
    if isinstance(v, tuple):
        return {"__tuple__": [_encode_value(x) for x in v]}
    if isinstance(v, list):
        return [_encode_value(x) for x in v]
    if isinstance(v, (set, frozenset)):
        items = sorted((_encode_value(x) for x in v), key=json.dumps)
        tag = "__frozenset__" if isinstance(v, frozenset) else "__set__"
        return {tag: items}
    if isinstance(v, dict):
        # Insertion order IS part of dict semantics (the repo uses dicts as
        # insertion-ordered sets) — encode pairs in order, no sorting.
        return {
            "__dict__": [
                [_encode_value(k), _encode_value(x)] for k, x in v.items()
            ]
        }
    raise TypeError(f"cannot JSON-encode message part {v!r}; pass custom serde")


def make_json_serde(msg_types: Iterable[type] = ()):
    """Default JSON codec: dataclasses tagged by class name; tuples, sets,
    frozensets, dicts, and `Id` carry explicit tags so every message value
    round-trips EXACTLY (lww/vector-clock-style tuple- and set-valued
    messages included)."""
    registry = {t.__name__: t for t in msg_types}

    def serialize(msg) -> bytes:
        return json.dumps(_encode_value(msg)).encode("utf-8")

    def _decode(v):
        if isinstance(v, dict):
            if "__type__" in v:
                cls = registry.get(v["__type__"])
                if cls is None:
                    raise ValueError(
                        f"unknown message type {v['__type__']!r}"
                    )
                return cls(
                    **{
                        f.name: _decode(v[f.name])
                        for f in dataclasses.fields(cls)
                        if f.name in v
                    }
                )
            if "__id__" in v:
                return Id(v["__id__"])
            if "__tuple__" in v:
                return tuple(_decode(x) for x in v["__tuple__"])
            if "__frozenset__" in v:
                return frozenset(_decode(x) for x in v["__frozenset__"])
            if "__set__" in v:
                return {_decode(x) for x in v["__set__"]}
            if "__dict__" in v:
                return {_decode(k): _decode(x) for k, x in v["__dict__"]}
            return v
        if isinstance(v, list):
            return [_decode(x) for x in v]
        return v

    def deserialize(data: bytes):
        return _decode(json.loads(data.decode("utf-8")))

    return serialize, deserialize


class _ActorRuntime(threading.Thread):
    def __init__(self, id: Id, actor: Actor, serialize, deserialize, stop_event):
        super().__init__(name=f"actor-{int(id)}", daemon=True)
        self.id = Id(id)
        self.actor = actor
        self.serialize = serialize
        self.deserialize = deserialize
        self.stop_event = stop_event
        self.rng = random.Random()
        # interrupt key -> (deadline, payload); keys are ("timer", timer) or
        # ("random", key) (ref: src/actor/spawn.rs:156-160).
        self.next_interrupts: dict = {}
        ip, port = self.id.to_addr()
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((ip, port))

    def _on_command(self, cmd) -> None:
        """ref: src/actor/spawn.rs:163-232"""
        if isinstance(cmd, Send):
            ip, port = Id(cmd.dst).to_addr()
            try:
                self.sock.sendto(self.serialize(cmd.msg), (ip, port))
            except OSError:
                pass  # unreachable peers are dropped datagrams, like UDP itself
        elif isinstance(cmd, SetTimer):
            lo, hi = cmd.duration
            delay = self.rng.uniform(lo, hi) if hi > lo else lo
            self.next_interrupts[("timer", cmd.timer)] = (
                time.monotonic() + delay,
                cmd.timer,
            )
        elif isinstance(cmd, CancelTimer):
            self.next_interrupts.pop(("timer", cmd.timer), None)
        elif isinstance(cmd, ChooseRandom):
            if not cmd.choices:
                self.next_interrupts.pop(("random", cmd.key), None)
            else:
                # Random choices become near-immediate interrupts resolved
                # with a real RNG.
                self.next_interrupts[("random", cmd.key)] = (
                    time.monotonic() + self.rng.uniform(0.0, 0.01),
                    self.rng.choice(cmd.choices),
                )

    def run(self) -> None:
        out = Out()
        state = self.actor.on_start(self.id, out)
        for cmd in out:
            self._on_command(cmd)

        while not self.stop_event.is_set():
            # Wait until the next interrupt (or a message arrives).
            timeout = 0.5
            if self.next_interrupts:
                nearest = min(d for d, _ in self.next_interrupts.values())
                timeout = max(0.0, min(timeout, nearest - time.monotonic()))
            self.sock.settimeout(timeout if timeout > 0 else 0.000001)
            out = Out()
            try:
                data, addr = self.sock.recvfrom(_MAX_DATAGRAM)
                try:
                    msg = self.deserialize(data)
                except Exception:
                    continue  # malformed datagrams are ignored
                src = Id.from_addr(addr[0], addr[1])
                next_state = self.actor.on_msg(self.id, state, src, msg, out)
                if next_state is not None:
                    state = next_state
            except socket.timeout:
                now = time.monotonic()
                due = [
                    (k, payload)
                    for k, (deadline, payload) in self.next_interrupts.items()
                    if deadline <= now
                ]
                for key, payload in due:
                    del self.next_interrupts[key]
                    if key[0] == "timer":
                        next_state = self.actor.on_timeout(
                            self.id, state, payload, out
                        )
                    else:
                        next_state = self.actor.on_random(
                            self.id, state, payload, out
                        )
                    if next_state is not None:
                        state = next_state
            except OSError:
                break
            for cmd in out:
                self._on_command(cmd)
        self.sock.close()


def spawn(
    actors: Iterable[Tuple[Id, Actor]],
    serialize: Optional[Callable] = None,
    deserialize: Optional[Callable] = None,
    msg_types: Iterable[type] = (),
    block: bool = True,
):
    """Run actors for real over UDP (ref: src/actor/spawn.rs:64-154).

    Each (id, actor) pair gets a thread bound to the socket address encoded in
    its id. With `block=True` (default) this joins forever (ctrl-C to stop);
    otherwise returns (threads, stop_event) for the caller to manage.
    """
    if serialize is None or deserialize is None:
        default_ser, default_de = make_json_serde(msg_types)
        serialize = serialize or default_ser
        deserialize = deserialize or default_de
    stop_event = threading.Event()
    threads = [
        _ActorRuntime(id, actor, serialize, deserialize, stop_event)
        for id, actor in actors
    ]
    for t in threads:
        t.start()
    if not block:
        return threads, stop_event
    try:
        while any(t.is_alive() for t in threads):
            time.sleep(0.5)
    except KeyboardInterrupt:
        stop_event.set()
    return threads, stop_event


def local_ids(count: int, ip: str = "127.0.0.1") -> list:
    """`count` actor Ids on `ip`, each at a UDP port the OS hands out: the
    sockets are bound together (so the ports differ), read and closed, and
    the runtimes bind them again at `spawn`. For tests and demos that must
    not pick a fixed port."""
    socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM) for _ in range(count)]
    try:
        for s in socks:
            s.bind((ip, 0))
        return [Id.from_addr(ip, s.getsockname()[1]) for s in socks]
    finally:
        for s in socks:
            s.close()
