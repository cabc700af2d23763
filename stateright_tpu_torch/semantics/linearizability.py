"""Linearizability tester (ref: src/semantics/linearizability.rs).

Captures a potentially concurrent history and decides whether a total order
exists that (a) respects each thread's own order, (b) respects *real-time*
order — an operation invoked after another completed must be serialized after
it — and (c) is valid per the `SequentialSpec`.

Real-time order is tracked exactly as the reference does: upon invocation, the
tester records the index of the last completed operation of every other thread
(ref: src/semantics/linearizability.rs:7-12, 114-126); the backtracking
`serialize` rejects interleavings that would place an operation before any of
those prerequisites (ref: :193-280).

Testers are immutable: recorders return new testers, so a tester can serve as
an `ActorModel` history (auxiliary state hashed into the fingerprint).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

from . import ConsistencyTester, SequentialSpec


class LinearizabilityTester(ConsistencyTester):
    __slots__ = (
        "init_ref_obj",
        "history_by_thread",
        "in_flight_by_thread",
        "is_valid_history",
        "_key_cache",  # lazy identity-tuple cache (testers are immutable)
        "_hash",
        # Dedup-first verdict plane (semantics/canonical.py). None of these
        # participate in identity/encoding — they are evaluation hints:
        "_canon",  # lazy canonical form (thread-relabeled fingerprint)
        "_parent",  # the tester this one was recorded from
        "_delta",  # ("inv"|"ret", thread_id): the recording that made it
    )

    def __init__(
        self,
        init_ref_obj: SequentialSpec,
        history_by_thread: Optional[dict] = None,
        in_flight_by_thread: Optional[dict] = None,
        is_valid_history: bool = True,
    ):
        self.init_ref_obj = init_ref_obj
        # {tid: tuple of (last_completed, op, ret)}, last_completed is a tuple
        # of sorted (peer_tid, last_index) pairs.
        self.history_by_thread = history_by_thread or {}
        # {tid: (last_completed, op)}
        self.in_flight_by_thread = in_flight_by_thread or {}
        self.is_valid_history = is_valid_history

    def __len__(self) -> int:
        return len(self.in_flight_by_thread) + sum(
            len(h) for h in self.history_by_thread.values()
        )

    # -- recording (ref: src/semantics/linearizability.rs:102-157) -------------

    def on_invoke(self, thread_id, op) -> "LinearizabilityTester":
        if not self.is_valid_history or thread_id in self.in_flight_by_thread:
            # Double-invocation invalidates the history permanently.
            return self._invalidated()
        last_completed = tuple(
            sorted(
                (tid, len(hist) - 1)
                for tid, hist in self.history_by_thread.items()
                if tid != thread_id and hist
            )
        )
        in_flight = dict(self.in_flight_by_thread)
        in_flight[thread_id] = (last_completed, op)
        history = dict(self.history_by_thread)
        history.setdefault(thread_id, ())
        child = LinearizabilityTester(self.init_ref_obj, history, in_flight, True)
        # Witness-guidance hint (semantics/canonical.py): the child extends
        # this tester by one recording; the verdict plane seeds its search
        # from this tester's cached witness instead of from scratch. Plane
        # code severs the chain (_seal) once a verdict is cached, so a live
        # tester pins O(1) ancestry.
        child._parent = self
        child._delta = ("inv", thread_id)
        return child

    def on_return(self, thread_id, ret) -> "LinearizabilityTester":
        if not self.is_valid_history or thread_id not in self.in_flight_by_thread:
            return self._invalidated()
        in_flight = dict(self.in_flight_by_thread)
        last_completed, op = in_flight.pop(thread_id)
        history = dict(self.history_by_thread)
        history[thread_id] = history.get(thread_id, ()) + ((last_completed, op, ret),)
        child = LinearizabilityTester(self.init_ref_obj, history, in_flight, True)
        child._parent = self
        child._delta = ("ret", thread_id)
        return child

    def _invalidated(self) -> "LinearizabilityTester":
        return LinearizabilityTester(
            self.init_ref_obj,
            self.history_by_thread,
            self.in_flight_by_thread,
            False,
        )

    def is_consistent(self) -> bool:
        """The dedup-first verdict path (semantics/canonical.py): canonical
        fingerprint cache -> witness-guided incremental serialization ->
        full search, boolean-identical to `serialized_history() is not
        None` but ~one search per equivalence class per process instead of
        one per distinct history. Properties should call THIS."""
        from .canonical import verdict

        return verdict(self)

    # -- serialization search (ref: src/semantics/linearizability.rs:175-280) --

    def serialized_history(self) -> Optional[list]:
        """A valid total order of (op, ret) pairs, or None. In-flight ops may
        appear (they might have taken effect) or not (they might not have).
        Exact legacy search order — pinned witness lists never change; the
        canonical plane only short-circuits the verdict-equivalent negative
        (a cached False IS None)."""
        if not self.is_valid_history:
            return None
        from .canonical import probe_cached_negative

        if probe_cached_negative(self):
            return None
        cached = _serialized_cached(self)
        return None if cached is None else list(cached)

    def _serialized_uncached(self) -> Optional[list]:
        # The JAX package tries its native (C++) serializer first; it returns
        # the same results as this search, which the port always runs.
        remaining = {
            tid: tuple(enumerate(hist))
            for tid, hist in self.history_by_thread.items()
        }
        return _serialize([], self.init_ref_obj, remaining, self.in_flight_by_thread)

    # -- identity (the tester lives inside checker states) ---------------------

    def _key(self):
        # Testers are immutable (every recording op returns a new tester),
        # so the identity tuple is built once and cached — `_key` dominates
        # host hashing costs otherwise (exact-closure profile, round 4).
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
            f"{type(self).__name__}(history={self.history_by_thread!r}, "
            f"in_flight={self.in_flight_by_thread!r}, valid={self.is_valid_history})"
        )


@lru_cache(maxsize=1 << 15)
def _serialized_cached(tester: "LinearizabilityTester"):
    """Equal testers recur across many checker states (the history is only one
    component of the state), so the search result is memoized on the immutable
    tester (SURVEY.md §7: "cache verdicts by history-fingerprint")."""
    result = tester._serialized_uncached()
    if result is None:
        # Feed the canonical plane the refutation for free: a negative is a
        # class-wide fact `serialized_history` can short-circuit on later
        # (positives are not recorded here — the legacy list is
        # label-specific and a positive cannot skip the legacy search, so
        # canonicalizing every positive would be pure overhead).
        from .canonical import note_verdict

        note_verdict(tester, False)
        return None
    return tuple(result)


def verdict_cache_stats() -> dict:
    """The verdict planes' counters: the legacy per-identity lru memo plus
    the dedup-first canonical plane (semantics/canonical.py: class
    collapse, witness guidance, batch evaluation). Exported through the obs
    REGISTRY as the "semantics" source, as in the JAX package."""
    from . import sequential_consistency as _sc
    from .canonical import CACHE

    info = _serialized_cached.cache_info()
    sc_info = _sc._serialized_cached.cache_info()
    out = {
        "verdict_cache_hits": info.hits + sc_info.hits,
        "verdict_cache_misses": info.misses + sc_info.misses,
        "verdict_cache_entries": info.currsize + sc_info.currsize,
    }
    out.update(CACHE.stats())
    return out


# The caches are process-global, so their counters register once, at
# import: `/metrics` on any service or replica reports them live.
from ..obs.registry import REGISTRY  # noqa: E402  (after what it exports)

REGISTRY.register("semantics", verdict_cache_stats)


def _violates_real_time(last_completed, remaining) -> bool:
    """An op cannot serialize before its prerequisites: every peer op up to the
    recorded index must already be consumed (ref: linearizability.rs:221-233)."""
    for peer_id, min_peer_time in last_completed:
        ops = remaining.get(peer_id)
        if ops:
            next_peer_time = ops[0][0]
            if next_peer_time <= min_peer_time:
                return True
    return False


def _serialize(valid_history, ref_obj, remaining, in_flight) -> Optional[list]:
    if all(not h for h in remaining.values()):
        # In-flight ops need not take effect (ref: linearizability.rs:203-208).
        return valid_history

    for thread_id in remaining:
        history = remaining[thread_id]
        if not history:
            # Case 1: only a possibly-in-flight op remains for this thread.
            if thread_id not in in_flight:
                continue
            last_completed, op = in_flight[thread_id]
            if _violates_real_time(last_completed, remaining):
                continue
            ret, next_obj = ref_obj.invoke(op)
            next_in_flight = {t: v for t, v in in_flight.items() if t != thread_id}
            result = _serialize(
                valid_history + [(op, ret)], next_obj, remaining, next_in_flight
            )
            if result is not None:
                return result
        else:
            # Case 2: consume the thread's next completed op.
            (_idx, (last_completed, op, ret)) = history[0]
            next_remaining = dict(remaining)
            next_remaining[thread_id] = history[1:]
            if _violates_real_time(last_completed, next_remaining):
                continue
            next_obj = ref_obj.is_valid_step(op, ret)
            if next_obj is None:
                continue
            result = _serialize(
                valid_history + [(op, ret)], next_obj, next_remaining, in_flight
            )
            if result is not None:
                return result
    return None
