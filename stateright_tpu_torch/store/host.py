"""Host spill tier: the cold half of the tiered state store (the JAX
package's `store/host.py`).

Holds every fingerprint evicted from the device hash table as packed uint64
arrays (fingerprint + parent fingerprint, aligned). Two-zone layout for
O(log n) membership with O(1) appends:

- a SORTED zone (deduped, binary-searchable), and
- PENDING append chunks in arrival order, merged into the sorted zone by a
  background compaction thread once they pile past a threshold (or inline
  when `background=False` — deterministic for tests).

Dedup keeps the FIRST-appended entry per fingerprint: eviction can re-spill
a key that was re-claimed on device after an earlier spill, and the first
entry carries the ORIGINAL parent — the one the BFS discovery wrote — which
is what keeps reconstructed paths acyclic (a later re-claim's parent can sit
deeper than the state itself).

The port keeps the reference's contents and answers exactly and differs
only in how it gets them at tens of millions of entries: each chunk is
sorted once, when it is appended; compaction merges the pending chunks into
the sorted zone (the reference re-sorts everything) into new arrays,
outside the lock that lookups take, so a lookup never waits for a merge;
and lookups sort their queries before the binary search, so that it walks
each zone in order.

All public methods are thread-safe.
"""

from __future__ import annotations

import threading
import weakref
from typing import Optional

import numpy as np


def _compactor_loop(store_ref, wake: threading.Event) -> None:
    """Background compactor body. Holds only a WEAKREF to the store, so a
    dropped store's arrays stay collectable, and reaps itself once the
    store is gone or closed."""
    while True:
        wake.wait(timeout=30.0)
        wake.clear()
        store = store_ref()
        if store is None or store._stop:
            return
        store.compact()
        del store


def _first_of_each(fps: np.ndarray, parents: np.ndarray):
    """(sorted unique fps, the parent of each one's first occurrence)."""
    order = np.argsort(fps, kind="stable")
    fps, parents = fps[order], parents[order]
    first = np.ones(fps.size, dtype=bool)
    first[1:] = fps[1:] != fps[:-1]
    return fps[first], parents[first]


def _find(sorted_fps: np.ndarray, fps: np.ndarray):
    """(hit bool[n], position in `sorted_fps` of each hit) for queries in
    any order; the queries are sorted first so the search walks in order."""
    hit = np.zeros(fps.size, dtype=bool)
    pos = np.zeros(fps.size, dtype=np.int64)
    if sorted_fps.size and fps.size:
        order = np.argsort(fps)
        p = np.minimum(np.searchsorted(sorted_fps, fps[order]), sorted_fps.size - 1)
        hit[order] = sorted_fps[p] == fps[order]
        pos[order] = p
    return hit, pos


class HostSpillStore:
    def __init__(self, compact_threshold: int = 1 << 15, background: bool = True):
        # `_lock` guards the published state: the sorted zone's two arrays,
        # which are never modified once published, and the pending list.
        # `_merge_lock` lets one compaction run at a time; it merges outside
        # `_lock`, so lookups never wait for a merge.
        self._lock = threading.Lock()
        self._merge_lock = threading.Lock()
        self._sorted_fps = np.zeros(0, dtype=np.uint64)
        self._sorted_parents = np.zeros(0, dtype=np.uint64)
        # Chunks in append order, each already (sorted unique fps, the
        # parent of each one's first occurrence).
        self._pending: list[tuple[np.ndarray, np.ndarray]] = []
        self._pending_len = 0
        self._compact_threshold = compact_threshold
        self._wake: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        if background:
            self._wake = threading.Event()
            self._thread = threading.Thread(
                target=_compactor_loop,
                args=(weakref.ref(self), self._wake),
                daemon=True,
            )
            self._thread.start()

    def close(self) -> None:
        """Stop the background compactor (call it when a store is
        replaced, so no parked thread outlives its search)."""
        if self._thread is not None:
            self._stop = True
            self._wake.set()
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- writes ---------------------------------------------------------------

    def append(self, fps: np.ndarray, parents: np.ndarray) -> None:
        """Append one eviction batch (packed uint64, aligned)."""
        fps = np.asarray(fps, dtype=np.uint64)
        parents = np.asarray(parents, dtype=np.uint64)
        if fps.size == 0:
            return
        chunk = _first_of_each(fps, parents)  # copies
        with self._lock:
            self._pending.append(chunk)
            self._pending_len += chunk[0].size
            due = self._pending_len >= self._compact_threshold
        if due:
            if self._wake is not None:
                self._wake.set()
            else:
                self.compact()

    def compact(self) -> None:
        """Merge pending chunks into the sorted zone (first-writer dedup)."""
        with self._merge_lock:
            with self._lock:
                chunks = list(self._pending)
                sorted_fps, sorted_parents = self._sorted_fps, self._sorted_parents
            if not chunks:
                return
            # Chunks in append order: a stable sort keeps each key's first
            # append first; the sorted zone predates them all, so a key it
            # already holds keeps its entry there.
            fps, parents = _first_of_each(
                np.concatenate([f for f, _ in chunks]),
                np.concatenate([p for _, p in chunks]),
            )
            known, _ = _find(sorted_fps, fps)
            fps, parents = fps[~known], parents[~known]
            at = np.searchsorted(sorted_fps, fps)
            merged = (np.insert(sorted_fps, at, fps), np.insert(sorted_parents, at, parents))
            with self._lock:
                self._sorted_fps, self._sorted_parents = merged
                del self._pending[: len(chunks)]
                self._pending_len -= sum(f.size for f, _ in chunks)

    # -- reads ----------------------------------------------------------------

    def contains(self, fps: np.ndarray) -> np.ndarray:
        """bool[n]: exact membership for packed fingerprints."""
        return self.parents(fps)[0]

    def parents(self, fps: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(found bool[n], parent uint64[n]) for packed fingerprints: the
        first-written parent of each spilled one (0 where not found), by
        binary search over the sorted zone, then each pending chunk in
        append order — never a dict of the whole tier."""
        fps = np.asarray(fps, dtype=np.uint64)
        with self._lock:
            zones = [(self._sorted_fps, self._sorted_parents), *self._pending]
        found = np.zeros(fps.size, dtype=bool)
        parent = np.zeros(fps.size, dtype=np.uint64)
        for zone_fps, zone_parents in zones:
            todo = np.nonzero(~found)[0]
            if todo.size == 0:
                break
            hit, p = _find(zone_fps, fps[todo])
            found[todo[hit]] = True
            parent[todo[hit]] = zone_parents[p[hit]]
        return found, parent

    def _compacted(self) -> tuple[np.ndarray, np.ndarray]:
        self.compact()
        with self._lock:
            return self._sorted_fps, self._sorted_parents

    def __len__(self) -> int:
        """Deduped spilled-state count (compacts to make it exact)."""
        return int(self._compacted()[0].size)

    def parent_map(self) -> dict:
        """{fingerprint: parent fingerprint} (test-scale use)."""
        fps, parents = self._compacted()
        return dict(zip(fps.tolist(), parents.tolist()))

    def to_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """(fps, parents) snapshot, compacted and sorted by fingerprint."""
        fps, parents = self._compacted()
        return fps.copy(), parents.copy()

    @classmethod
    def from_arrays(cls, fps: np.ndarray, parents: np.ndarray) -> "HostSpillStore":
        """A store holding `to_arrays`' snapshot (either package's: sorted,
        deduplicated fingerprints) as its sorted zone."""
        s = cls()
        s._sorted_fps = np.asarray(fps, dtype=np.uint64)
        s._sorted_parents = np.asarray(parents, dtype=np.uint64)
        return s
