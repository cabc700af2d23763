"""Sequential-consistency tester (ref: src/semantics/sequential_consistency.rs).

Like `LinearizabilityTester` but without real-time constraints: a total order
need only respect each thread's own operation order plus the spec's semantics,
so e.g. a thread may observe stale state relative to another thread's completed
operation.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

from . import ConsistencyTester, SequentialSpec


class SequentialConsistencyTester(ConsistencyTester):
    __slots__ = (
        "init_ref_obj",
        "history_by_thread",
        "in_flight_by_thread",
        "is_valid_history",
        "_key_cache",  # lazy identity-tuple cache (testers are immutable)
        "_hash",
        # Dedup-first verdict plane hints (see LinearizabilityTester):
        "_canon",
        "_parent",
        "_delta",
    )

    def __init__(
        self,
        init_ref_obj: SequentialSpec,
        history_by_thread: Optional[dict] = None,
        in_flight_by_thread: Optional[dict] = None,
        is_valid_history: bool = True,
    ):
        self.init_ref_obj = init_ref_obj
        self.history_by_thread = history_by_thread or {}  # {tid: ((op, ret), ...)}
        self.in_flight_by_thread = in_flight_by_thread or {}  # {tid: op}
        self.is_valid_history = is_valid_history

    def __len__(self) -> int:
        return len(self.in_flight_by_thread) + sum(
            len(h) for h in self.history_by_thread.values()
        )

    # -- recording (ref: sequential_consistency.rs:97-143) ---------------------

    def on_invoke(self, thread_id, op) -> "SequentialConsistencyTester":
        if not self.is_valid_history or thread_id in self.in_flight_by_thread:
            return self._invalidated()
        in_flight = dict(self.in_flight_by_thread)
        in_flight[thread_id] = op
        history = dict(self.history_by_thread)
        history.setdefault(thread_id, ())
        child = SequentialConsistencyTester(
            self.init_ref_obj, history, in_flight, True
        )
        # Witness-guidance hints — see LinearizabilityTester.
        child._parent = self
        child._delta = ("inv", thread_id)
        return child

    def on_return(self, thread_id, ret) -> "SequentialConsistencyTester":
        if not self.is_valid_history or thread_id not in self.in_flight_by_thread:
            return self._invalidated()
        in_flight = dict(self.in_flight_by_thread)
        op = in_flight.pop(thread_id)
        history = dict(self.history_by_thread)
        history[thread_id] = history.get(thread_id, ()) + ((op, ret),)
        child = SequentialConsistencyTester(
            self.init_ref_obj, history, in_flight, True
        )
        child._parent = self
        child._delta = ("ret", thread_id)
        return child

    def _invalidated(self) -> "SequentialConsistencyTester":
        return SequentialConsistencyTester(
            self.init_ref_obj,
            self.history_by_thread,
            self.in_flight_by_thread,
            False,
        )

    def is_consistent(self) -> bool:
        """Dedup-first verdict path — see LinearizabilityTester.is_consistent."""
        from .canonical import verdict

        return verdict(self)

    # -- serialization search (ref: sequential_consistency.rs:152-238) ---------

    def serialized_history(self) -> Optional[list]:
        if not self.is_valid_history:
            return None
        from .canonical import probe_cached_negative

        if probe_cached_negative(self):
            return None
        cached = _serialized_cached(self)
        return None if cached is None else list(cached)

    def _serialized_uncached(self) -> Optional[list]:
        # Python search only (see LinearizabilityTester._serialized_uncached).
        return _serialize(
            [],
            self.init_ref_obj,
            dict(self.history_by_thread),
            self.in_flight_by_thread,
        )

    # -- identity --------------------------------------------------------------

    def _key(self):
        # Lazy identity-tuple memo, ported from LinearizabilityTester._key
        # (round-4 exact-closure profile): testers are immutable, so the two
        # frozensets are built ONCE instead of on every hash/eq — `hid_of`
        # dict probes during lowering closures dominate otherwise.
        k = getattr(self, "_key_cache", None)
        if k is None:
            k = self._key_cache = (
                self.init_ref_obj,
                frozenset(self.history_by_thread.items()),
                frozenset(self.in_flight_by_thread.items()),
                self.is_valid_history,
            )
        return k

    def __stable_encode__(self):
        return (
            type(self).__name__,
            self.init_ref_obj,
            self.history_by_thread,
            self.in_flight_by_thread,
            self.is_valid_history,
        )

    def __eq__(self, other) -> bool:
        return isinstance(other, type(self)) and self._key() == other._key()

    def __hash__(self) -> int:
        h = getattr(self, "_hash", None)
        if h is None:
            h = self._hash = hash(self._key())
        return h

    def __repr__(self) -> str:
        return (
            f"SequentialConsistencyTester(history={self.history_by_thread!r}, "
            f"in_flight={self.in_flight_by_thread!r}, valid={self.is_valid_history})"
        )


@lru_cache(maxsize=1 << 15)
def _serialized_cached(tester: "SequentialConsistencyTester"):
    """Memoized search result on the immutable tester (equal histories recur
    across many checker states)."""
    result = tester._serialized_uncached()
    if result is None:
        # Negatives only — see linearizability._serialized_cached.
        from .canonical import note_verdict

        note_verdict(tester, False)
        return None
    return tuple(result)


def _serialize(valid_history, ref_obj, remaining, in_flight) -> Optional[list]:
    if all(not h for h in remaining.values()):
        return valid_history
    for thread_id in remaining:
        history = remaining[thread_id]
        if not history:
            if thread_id not in in_flight:
                continue
            op = in_flight[thread_id]
            ret, next_obj = ref_obj.invoke(op)
            next_in_flight = {t: v for t, v in in_flight.items() if t != thread_id}
            result = _serialize(
                valid_history + [(op, ret)], next_obj, remaining, next_in_flight
            )
            if result is not None:
                return result
        else:
            op, ret = history[0]
            next_obj = ref_obj.is_valid_step(op, ret)
            if next_obj is None:
                continue
            next_remaining = dict(remaining)
            next_remaining[thread_id] = history[1:]
            result = _serialize(
                valid_history + [(op, ret)], next_obj, next_remaining, in_flight
            )
            if result is not None:
                return result
    return None
