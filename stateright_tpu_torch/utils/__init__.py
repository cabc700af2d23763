"""State-building utility types (ref: src/util.rs, src/util/densenatmap.rs,
src/util/vector_clock.rs).

The reference needs `HashableHashSet`/`HashableHashMap` because Rust's std
collections don't implement `Hash`; in Python `frozenset` nearly suffices, but
model states also need *stable* fingerprints and dict values aren't hashable.
`HashableSet`/`HashableMap` are immutable, order-insensitive, hashable, and
stably encodable (via `__stable_encode__`, which sorts canonical per-element
encodings exactly like the reference sorts per-element hashes,
ref: src/util.rs:137-159).
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Tuple

from ..core.fingerprint import stable_encode


class HashableSet:
    """Immutable unordered set usable inside model states
    (ref: src/util.rs:70-267)."""

    __slots__ = ("_items", "_canon")

    def __init__(self, items: Iterable = ()):
        canon = {}
        for item in items:
            canon[stable_encode(item)] = item
        self._canon = tuple(sorted(canon))
        self._items = tuple(canon[k] for k in self._canon)

    def add(self, item) -> "HashableSet":
        return HashableSet(self._items + (item,))

    def remove(self, item) -> "HashableSet":
        key = stable_encode(item)
        return HashableSet(
            i for i, k in zip(self._items, self._canon) if k != key
        )

    def __contains__(self, item) -> bool:
        return stable_encode(item) in self._canon

    def __iter__(self) -> Iterator:
        return iter(self._items)

    def __len__(self) -> int:
        return len(self._items)

    def __eq__(self, other) -> bool:
        return isinstance(other, HashableSet) and self._canon == other._canon

    def __hash__(self) -> int:
        return hash(self._canon)

    def __stable_encode__(self):
        return ("HashableSet", self._canon)

    def __repr__(self) -> str:
        return "{" + ", ".join(repr(i) for i in self._items) + "}"


class HashableMap:
    """Immutable unordered map usable inside model states
    (ref: src/util.rs:271-463)."""

    __slots__ = ("_pairs", "_index")

    def __init__(self, pairs=()):
        if isinstance(pairs, dict):
            pairs = pairs.items()
        elif isinstance(pairs, HashableMap):
            pairs = pairs.items()
        index = {}
        for k, v in pairs:
            index[stable_encode(k)] = (k, v)
        self._index = index
        self._pairs = tuple(index[ck] for ck in sorted(index))

    def set(self, key, value) -> "HashableMap":
        return HashableMap(self._pairs + ((key, value),))

    def remove(self, key) -> "HashableMap":
        ck = stable_encode(key)
        return HashableMap(
            (k, v) for k, v in self._pairs if stable_encode(k) != ck
        )

    def get(self, key, default=None):
        entry = self._index.get(stable_encode(key))
        return default if entry is None else entry[1]

    def __getitem__(self, key):
        entry = self._index.get(stable_encode(key))
        if entry is None:
            raise KeyError(key)
        return entry[1]

    def __contains__(self, key) -> bool:
        return stable_encode(key) in self._index

    def items(self) -> Tuple[tuple, ...]:
        return self._pairs

    def keys(self):
        return tuple(k for k, _ in self._pairs)

    def values(self):
        return tuple(v for _, v in self._pairs)

    def __iter__(self):
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self._pairs)

    def __eq__(self, other) -> bool:
        return isinstance(other, HashableMap) and self._pairs == other._pairs

    def __hash__(self) -> int:
        return hash(tuple((stable_encode(k), stable_encode(v)) for k, v in self._pairs))

    def __stable_encode__(self):
        return ("HashableMap", self._pairs)

    def __repr__(self) -> str:
        return "{" + ", ".join(f"{k!r}: {v!r}" for k, v in self._pairs) + "}"


class DenseNatMap:
    """Immutable Vec-backed map for dense nat keys — actor `Id`s — enforcing
    contiguity (ref: src/util/densenatmap.rs:74-356)."""

    __slots__ = ("_values",)

    def __init__(self, values: Iterable = ()):
        self._values = tuple(values)

    @staticmethod
    def from_iter_keyed(pairs: Iterable[tuple]) -> "DenseNatMap":
        """Build from (key, value) pairs; keys must be exactly 0..n-1
        (panics on gaps, ref: src/util/densenatmap.rs insert)."""
        items = sorted(pairs, key=lambda kv: int(kv[0]))
        for expected, (k, _) in enumerate(items):
            if int(k) != expected:
                raise IndexError(
                    f"DenseNatMap keys must be dense: missing {expected}"
                )
        return DenseNatMap(v for _, v in items)

    def insert(self, key, value) -> "DenseNatMap":
        i = int(key)
        if i > len(self._values):
            raise IndexError(
                f"DenseNatMap insert at {i} would leave a gap "
                f"(len={len(self._values)})"
            )
        if i == len(self._values):
            return DenseNatMap(self._values + (value,))
        vals = list(self._values)
        vals[i] = value
        return DenseNatMap(vals)

    def get(self, key, default=None):
        i = int(key)
        return self._values[i] if 0 <= i < len(self._values) else default

    def __getitem__(self, key):
        return self._values[int(key)]

    def items(self):
        from ..actor import Id

        return tuple((Id(i), v) for i, v in enumerate(self._values))

    def values(self) -> tuple:
        return self._values

    def __iter__(self):
        return iter(self._values)

    def __len__(self) -> int:
        return len(self._values)

    def __eq__(self, other) -> bool:
        return isinstance(other, DenseNatMap) and self._values == other._values

    def __hash__(self) -> int:
        return hash(self._values)

    def __stable_encode__(self):
        return ("DenseNatMap", self._values)

    def __repr__(self) -> str:
        return f"DenseNatMap({list(self._values)!r})"


class VectorClock:
    """Partial-order logical clock (ref: src/util/vector_clock.rs:9-275).
    Immutable; absent indices are implicitly zero."""

    __slots__ = ("_elems",)

    def __init__(self, elems: Iterable[int] = ()):
        elems = tuple(int(e) for e in elems)
        while elems and elems[-1] == 0:  # canonical: no trailing zeros
            elems = elems[:-1]
        self._elems = elems

    def get(self, index: int) -> int:
        return self._elems[index] if 0 <= index < len(self._elems) else 0

    def incremented(self, index: int) -> "VectorClock":
        n = max(len(self._elems), index + 1)
        elems = [self.get(i) for i in range(n)]
        elems[index] += 1
        return VectorClock(elems)

    def merge_max(self, other: "VectorClock") -> "VectorClock":
        n = max(len(self._elems), len(other._elems))
        return VectorClock(
            max(self.get(i), other.get(i)) for i in range(n)
        )

    def partial_cmp(self, other: "VectorClock") -> Optional[int]:
        """-1 if self < other, 0 if equal, 1 if self > other, None if
        incomparable (ref: src/util/vector_clock.rs partial_cmp)."""
        n = max(len(self._elems), len(other._elems))
        less = greater = False
        for i in range(n):
            a, b = self.get(i), other.get(i)
            if a < b:
                less = True
            elif a > b:
                greater = True
        if less and greater:
            return None
        if less:
            return -1
        if greater:
            return 1
        return 0

    def __lt__(self, other) -> bool:
        return self.partial_cmp(other) == -1

    def __le__(self, other) -> bool:
        return self.partial_cmp(other) in (-1, 0)

    def __eq__(self, other) -> bool:
        return isinstance(other, VectorClock) and self._elems == other._elems

    def __hash__(self) -> int:
        return hash(self._elems)

    def __stable_encode__(self):
        return ("VectorClock", self._elems)

    def __len__(self) -> int:
        return len(self._elems)

    def __repr__(self) -> str:
        return f"VectorClock({list(self._elems)!r})"


__all__ = ["HashableSet", "HashableMap", "DenseNatMap", "VectorClock"]
