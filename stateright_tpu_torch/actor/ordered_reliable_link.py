"""Ordered reliable link (ORL): an actor wrapper layering per-flow ordered,
exactly-once delivery over the unreliable fabric
(ref: src/actor/ordered_reliable_link.rs).

The real UDP runtime (and the lossy/duplicating model networks) may drop,
duplicate, and reorder. `ActorWrapper` restores sanity the classic way:

- outgoing messages get a per-destination sequence number and are retained
  until acknowledged;
- a periodic resend timer retransmits everything unacknowledged;
- receivers ack every `Deliver` (including re-deliveries, so lost acks heal)
  but hand the payload to the wrapped actor only when the sequence number is
  exactly the next expected for that source — dropping duplicates and
  buffering nothing (out-of-order messages are simply re-sent later).

The wrapper is itself model-checkable: tests prove the delivery guarantees as
properties under a lossy duplicating network, the same strategy as the
reference's embedded tests (ref: src/actor/ordered_reliable_link.rs:215-325).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

from . import Actor, Id, Out, model_timeout


# -- wire messages (ref: src/actor/ordered_reliable_link.rs:41-50) -------------


@dataclass(frozen=True)
class Deliver:
    seq: int
    msg: Any

    def __repr__(self):
        return f"Deliver({self.seq}, {self.msg!r})"


@dataclass(frozen=True)
class Ack:
    seq: int

    def __repr__(self):
        return f"Ack({self.seq})"


# -- timers --------------------------------------------------------------------


@dataclass(frozen=True)
class Resend:
    def __repr__(self):
        return "Resend"


@dataclass(frozen=True)
class InnerTimer:
    """A wrapped actor's own timer, namespaced away from `Resend`."""

    timer: Any

    def __repr__(self):
        return f"InnerTimer({self.timer!r})"


# -- state ---------------------------------------------------------------------


def _map_get(pairs: Tuple[tuple, ...], key, default):
    for k, v in pairs:
        if k == key:
            return v
    return default


def _map_set(pairs: Tuple[tuple, ...], key, value) -> Tuple[tuple, ...]:
    out = tuple((k, v) for k, v in pairs if k != key) + ((key, value),)
    return tuple(sorted(out, key=lambda kv: kv[0]))


@dataclass(frozen=True)
class StateWrapper:
    """ORL bookkeeping around the wrapped actor's state
    (ref: src/actor/ordered_reliable_link.rs:55-67).

    All maps are canonical sorted tuples so states fingerprint stably."""

    wrapped: Any
    next_send_seq: Tuple[tuple, ...] = ()  # (dst, next seq) sorted
    pending_ack: Tuple[tuple, ...] = ()  # ((dst, seq), msg) in send order
    last_delivered: Tuple[tuple, ...] = ()  # (src, last seq) sorted

    def __repr__(self):
        return (
            f"ORL {{ wrapped: {self.wrapped!r}, pending: "
            f"{[k for k, _ in self.pending_ack]!r}, "
            f"delivered: {dict(self.last_delivered)!r} }}"
        )


class ActorWrapper(Actor):
    """Wraps `inner`, translating its sends/timers through the link
    (ref: src/actor/ordered_reliable_link.rs:78-213)."""

    def __init__(self, inner: Actor, resend_interval=None):
        self.inner = inner
        self.resend_interval = resend_interval or model_timeout()

    def name(self) -> str:
        inner = self.inner.name()
        return f"ORL({inner})" if inner else "ORL"

    # -- helpers ---------------------------------------------------------------

    def _translate(self, state: StateWrapper, inner_out: Out, out: Out):
        """Wrap the inner actor's outgoing commands: sends become sequenced
        Delivers retained until acked; timers are namespaced."""
        from . import CancelTimer, ChooseRandom, Send, SetTimer

        next_send_seq = state.next_send_seq
        pending = state.pending_ack
        for c in inner_out:
            if isinstance(c, Send):
                seq = _map_get(next_send_seq, c.dst, 1)
                next_send_seq = _map_set(next_send_seq, c.dst, seq + 1)
                pending = pending + (((c.dst, seq), c.msg),)
                out.send(c.dst, Deliver(seq, c.msg))
            elif isinstance(c, SetTimer):
                out.set_timer(InnerTimer(c.timer), c.duration)
            elif isinstance(c, CancelTimer):
                out.cancel_timer(InnerTimer(c.timer))
            elif isinstance(c, ChooseRandom):
                out.commands.append(c)
            else:
                out.commands.append(c)
        return StateWrapper(
            wrapped=state.wrapped,
            next_send_seq=next_send_seq,
            pending_ack=pending,
            last_delivered=state.last_delivered,
        )

    # -- Actor interface -------------------------------------------------------

    def on_start(self, id: Id, out: Out):
        inner_out = Out()
        wrapped = self.inner.on_start(id, inner_out)
        out.set_timer(Resend(), self.resend_interval)
        state = StateWrapper(wrapped=wrapped)
        return self._translate(state, inner_out, out)

    def on_msg(self, id: Id, state: StateWrapper, src: Id, msg, out: Out):
        if isinstance(msg, Ack):
            key = (src, msg.seq)
            if not any(k == key for k, _ in state.pending_ack):
                return None
            return StateWrapper(
                wrapped=state.wrapped,
                next_send_seq=state.next_send_seq,
                pending_ack=tuple(
                    (k, m) for k, m in state.pending_ack if k != key
                ),
                last_delivered=state.last_delivered,
            )
        if isinstance(msg, Deliver):
            # Always ack — a lost ack otherwise wedges the sender forever.
            out.send(src, Ack(msg.seq))
            expected = _map_get(state.last_delivered, src, 0) + 1
            if msg.seq != expected:
                return None  # duplicate or out-of-order: dropped, will resend
            inner_out = Out()
            new_wrapped = self.inner.on_msg(
                id, state.wrapped, src, msg.msg, inner_out
            )
            mid = StateWrapper(
                wrapped=state.wrapped if new_wrapped is None else new_wrapped,
                next_send_seq=state.next_send_seq,
                pending_ack=state.pending_ack,
                last_delivered=_map_set(state.last_delivered, src, msg.seq),
            )
            return self._translate(mid, inner_out, out)
        return None

    def on_timeout(self, id: Id, state: StateWrapper, timer, out: Out):
        if isinstance(timer, Resend):
            out.set_timer(Resend(), self.resend_interval)
            for (dst, seq), msg in state.pending_ack:
                out.send(dst, Deliver(seq, msg))
            return None
        if isinstance(timer, InnerTimer):
            inner_out = Out()
            new_wrapped = self.inner.on_timeout(
                id, state.wrapped, timer.timer, inner_out
            )
            mid = StateWrapper(
                wrapped=state.wrapped if new_wrapped is None else new_wrapped,
                next_send_seq=state.next_send_seq,
                pending_ack=state.pending_ack,
                last_delivered=state.last_delivered,
            )
            return self._translate(mid, inner_out, out)
        return None

    def on_random(self, id: Id, state: StateWrapper, random, out: Out):
        inner_out = Out()
        new_wrapped = self.inner.on_random(id, state.wrapped, random, inner_out)
        mid = StateWrapper(
            wrapped=state.wrapped if new_wrapped is None else new_wrapped,
            next_send_seq=state.next_send_seq,
            pending_ack=state.pending_ack,
            last_delivered=state.last_delivered,
        )
        return self._translate(mid, inner_out, out)
