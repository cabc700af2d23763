"""The model-level communication fabric (ref: src/actor/network.rs).

Three pluggable delivery semantics:

- ``unordered_duplicating`` — a set of in-flight envelopes plus the last
  delivered envelope; delivery does NOT remove from the set, so messages race
  and can be redelivered. Tracking `last_msg` makes a redelivery that doesn't
  change actor state still produce a distinct fingerprint
  (ref: src/actor/network.rs:52, 224-228). Dropping means "never deliver
  again" (removes from the set).
- ``unordered_nonduplicating`` — a multiset (envelope → count); delivery/drop
  decrements.
- ``ordered`` — per directed (src, dst) flow FIFO queues; only the head of each
  flow is deliverable. Empty flows are deleted to keep the state canonical
  (ref: src/actor/network.rs:243-265).

Networks here are IMMUTABLE values: `send`/`on_deliver`/`on_drop` return new
networks. That matches this framework's immutable-state convention and makes
states safely shareable across the frontier without deep copies.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterator, Optional


@dataclass(frozen=True)
class Envelope:
    """Source, destination, and message (ref: src/actor/network.rs:24-29)."""

    src: Any  # Id
    dst: Any  # Id
    msg: Any


UNORDERED_DUPLICATING = "unordered_duplicating"
UNORDERED_NONDUPLICATING = "unordered_nonduplicating"
ORDERED = "ordered"


class Network:
    __slots__ = ("kind", "_data", "last_msg", "_hash")

    def __init__(self, kind: str, data: dict, last_msg: Optional[Envelope] = None):
        self.kind = kind
        # unordered_duplicating: {Envelope: None}   (insertion-ordered set)
        # unordered_nonduplicating: {Envelope: count}
        # ordered: {(src, dst): tuple(msgs)}
        self._data = data
        self.last_msg = last_msg

    # -- constructors (ref: src/actor/network.rs:84-137) -----------------------

    @staticmethod
    def new_unordered_duplicating(envelopes=()) -> "Network":
        n = Network(UNORDERED_DUPLICATING, {})
        for env in envelopes:
            n = n.send(env)
        return n

    @staticmethod
    def new_unordered_duplicating_with_last_msg(
        envelopes=(), last_msg: Optional[Envelope] = None
    ) -> "Network":
        n = Network.new_unordered_duplicating(envelopes)
        return Network(UNORDERED_DUPLICATING, n._data, last_msg)

    @staticmethod
    def new_unordered_nonduplicating(envelopes=()) -> "Network":
        n = Network(UNORDERED_NONDUPLICATING, {})
        for env in envelopes:
            n = n.send(env)
        return n

    @staticmethod
    def new_ordered(envelopes=()) -> "Network":
        n = Network(ORDERED, {})
        for env in envelopes:
            n = n.send(env)
        return n

    @staticmethod
    def names() -> list[str]:
        """CLI-selectable names (ref: src/actor/network.rs:140-166)."""
        return [ORDERED, UNORDERED_DUPLICATING, UNORDERED_NONDUPLICATING]

    @staticmethod
    def from_str(s: str) -> "Network":
        """ref: src/actor/network.rs:318-331"""
        if s == ORDERED:
            return Network.new_ordered()
        if s == UNORDERED_DUPLICATING:
            return Network.new_unordered_duplicating()
        if s == UNORDERED_NONDUPLICATING:
            return Network.new_unordered_nonduplicating()
        raise ValueError(f"unable to parse network name: {s}")

    # -- iteration -------------------------------------------------------------

    def iter_deliverable(self) -> Iterator[Envelope]:
        """Distinct deliverable envelopes; for ordered networks only flow heads
        (ref: src/actor/network.rs:180-190, 414-440)."""
        if self.kind == ORDERED:
            for (src, dst) in sorted(self._data):
                msgs = self._data[(src, dst)]
                yield Envelope(src, dst, msgs[0])
        else:
            yield from self._data.keys()

    def iter_all(self) -> Iterator[Envelope]:
        """Every in-flight envelope including multiset/flow repeats
        (ref: src/actor/network.rs:169-177, 350-412)."""
        if self.kind == UNORDERED_DUPLICATING:
            yield from self._data.keys()
        elif self.kind == UNORDERED_NONDUPLICATING:
            for env, count in self._data.items():
                for _ in range(count):
                    yield env
        else:
            for (src, dst) in sorted(self._data):
                for msg in self._data[(src, dst)]:
                    yield Envelope(src, dst, msg)

    def __len__(self) -> int:
        if self.kind == UNORDERED_DUPLICATING:
            return len(self._data)
        if self.kind == UNORDERED_NONDUPLICATING:
            return sum(self._data.values())
        return sum(len(msgs) for msgs in self._data.values())

    # -- mutation (functional; ref: src/actor/network.rs:203-315) --------------

    def send(self, envelope: Envelope) -> "Network":
        data = dict(self._data)
        if self.kind == UNORDERED_DUPLICATING:
            data[envelope] = None
        elif self.kind == UNORDERED_NONDUPLICATING:
            data[envelope] = data.get(envelope, 0) + 1
        else:
            key = (envelope.src, envelope.dst)
            data[key] = data.get(key, ()) + (envelope.msg,)
        return Network(self.kind, data, self.last_msg)

    def on_deliver(self, envelope: Envelope) -> "Network":
        if self.kind == UNORDERED_DUPLICATING:
            # Delivery does not consume; remember the last delivery so
            # state-preserving redeliveries still change the fingerprint.
            return Network(self.kind, self._data, envelope)
        if self.kind == UNORDERED_NONDUPLICATING:
            return self._remove_one(envelope)
        return self._remove_from_flow(envelope)

    def on_drop(self, envelope: Envelope) -> "Network":
        if self.kind == UNORDERED_DUPLICATING:
            data = dict(self._data)
            data.pop(envelope, None)
            return Network(self.kind, data, self.last_msg)
        if self.kind == UNORDERED_NONDUPLICATING:
            return self._remove_one(envelope)
        return self._remove_from_flow(envelope)

    def _remove_one(self, envelope: Envelope) -> "Network":
        count = self._data.get(envelope)
        if not count:
            raise KeyError(f"envelope not found: {envelope!r}")
        data = dict(self._data)
        if count == 1:
            del data[envelope]
        else:
            data[envelope] = count - 1
        return Network(self.kind, data, self.last_msg)

    def _remove_from_flow(self, envelope: Envelope) -> "Network":
        key = (envelope.src, envelope.dst)
        msgs = self._data.get(key)
        if msgs is None:
            raise KeyError(f"flow not found: src={envelope.src!r} dst={envelope.dst!r}")
        try:
            i = msgs.index(envelope.msg)
        except ValueError:
            raise KeyError(f"message not found in flow: {envelope.msg!r}") from None
        data = dict(self._data)
        remaining = msgs[:i] + msgs[i + 1 :]
        if remaining:
            data[key] = remaining
        else:
            del data[key]  # canonicalize: no empty flows
        return Network(self.kind, data, self.last_msg)

    def __rewrite__(self, plan) -> "Network":
        """Apply a symmetry rewrite plan to every envelope
        (ref: src/actor/network.rs:333-348)."""
        from ..symmetry import rewrite

        if self.kind == ORDERED:
            n = Network(self.kind, {})
            for (src, dst) in sorted(self._data):
                key = (plan.rewrite_id(src), plan.rewrite_id(dst))
                n._data[key] = tuple(rewrite(m, plan) for m in self._data[(src, dst)])
            return n
        n = Network(self.kind, {})
        for env in self._data:
            new_env = Envelope(
                plan.rewrite_id(env.src), plan.rewrite_id(env.dst), rewrite(env.msg, plan)
            )
            if self.kind == UNORDERED_DUPLICATING:
                n._data[new_env] = None
            else:
                n._data[new_env] = n._data.get(new_env, 0) + self._data[env]
        if self.kind == UNORDERED_DUPLICATING:
            n.last_msg = (
                None
                if self.last_msg is None
                else Envelope(
                    plan.rewrite_id(self.last_msg.src),
                    plan.rewrite_id(self.last_msg.dst),
                    rewrite(self.last_msg.msg, plan),
                )
            )
        return n

    # -- identity --------------------------------------------------------------

    def __stable_encode__(self):
        if self.kind == UNORDERED_DUPLICATING:
            return (self.kind, frozenset(self._data.keys()), self.last_msg)
        if self.kind == UNORDERED_NONDUPLICATING:
            return (self.kind, self._data)
        return (self.kind, self._data)

    def __eq__(self, other) -> bool:
        if not isinstance(other, Network) or self.kind != other.kind:
            return False
        if self.kind == UNORDERED_DUPLICATING:
            return (
                set(self._data.keys()) == set(other._data.keys())
                and self.last_msg == other.last_msg
            )
        return self._data == other._data

    def __hash__(self) -> int:
        # Networks are functional (every mutation returns a new Network), so
        # the deep hash over the frozenset is computed once and cached.
        h = getattr(self, "_hash", None)
        if h is None:
            if self.kind == UNORDERED_DUPLICATING:
                h = hash((self.kind, frozenset(self._data.keys()), self.last_msg))
            else:
                h = hash((self.kind, frozenset(self._data.items())))
            self._hash = h
        return h

    def __repr__(self) -> str:
        if self.kind == UNORDERED_DUPLICATING:
            return (
                f"Network.unordered_duplicating({list(self._data.keys())!r}, "
                f"last_msg={self.last_msg!r})"
            )
        if self.kind == UNORDERED_NONDUPLICATING:
            return f"Network.unordered_nonduplicating({self._data!r})"
        return f"Network.ordered({self._data!r})"
