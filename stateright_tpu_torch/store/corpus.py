"""The cross-job warm-start corpus: a persistent, content-addressed store of
finished jobs' visited sets (the JAX package's `store/corpus.py`, local
directories only).

When a job runs its model to exhaustion, the service publishes its whole
visited set — packed (fingerprint, parent) uint64 arrays in the host spill
tier's shape, a Bloom summary of the set, the result's counts and
discoveries, and the journal planes Spec-CI re-evaluates — as one
crash-atomic, CRC-checked `faults/ckptio.py` generation named by a CONTENT
key. A later submission of the same key preloads the set into the tiered
store's spill tier and Bloom summary before seeding, so every known state
is filtered at its first re-appearance (a suspect, resolved exactly on the
host) and the search collapses to the init frontier; the result replays the
publisher's counts and discoveries.

The content key digests the model DEFINITION (store/specdelta.py: the init
states and the traced graphs of expand, the boundary, the representative
and every property condition), the lowering and table configuration and the
finish policy. Two submissions share an entry exactly when a cold run of
each would give the same visited set and result. Port keys live in their
own namespace (specdelta's ``geometry`` names torch), so a JAX key never
serves the port or the other way round; the entry FILE format (npz keys,
dtypes, the JSON index rows, the CRC footer) is the JAX package's, and each
package decodes the other's entries.

Content addressing (`ckptio.content_path`): fleet replicas pointed at one
directory share generations; the first to finish a key publishes it, and a
later publish of the same key is skipped (`publish_skipped`). A corrupt
entry (bad CRC, torn tail) is counted (`corrupt_entries`) and ignored: the
job runs cold, never wrong. Both sides are chaos points (``corpus.load`` /
``corpus.publish``, and ``corpus.gc``).

The warm ladder beyond the exact key:

- PARTIAL entries (`complete=False`): a run cut short publishes what it
  visited, and a frontier snapshot when the cut is a step boundary, at
  ``corpus-partial-<key>.npz``; a successor continues from it, and the
  first complete publish of the key deletes it (`superseded_entries`).
  Partials are latest-wins.
- The FAMILY index (``corpus-family-<def hash>.npz``): one advisory record
  per definition listing every key with its components (`key_components`),
  so an exact miss can fall back to an entry of the same definition under
  another table packing (`near_match_hits`).
- The SPEC index (``corpus-spec-<geometry>.npz``): every definition of one
  geometry, with its component vector, for the delta rung.

Which entry may warm which run is decided in one place: store/warm.py.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..faults.blobstore import blob_backend, is_blob_uri, normalize_root
from ..faults.ckptio import (
    CheckpointCorrupt,
    LeaseRevoked,
    any_generation,
    content_path,
    fenced_load_latest,
    fenced_savez,
    latest_generation,
)
from ..faults.plan import FaultError, maybe_fault
from ..obs import REGISTRY
from .specdelta import def_components, joint_def_hash, spec_core_hash
from .summary import DEFAULT_HASHES, host_insert, summary_words

#: The payload format version (the JAX package's): an entry of another
#: version is treated as corrupt: ignored, cold.
FORMAT = 1


def model_def_hash(model) -> str:
    """The digest of a TensorModel's definition, derived from the component
    digests of `specdelta.def_components` (traced on the CPU, so equal on
    every device and in every process). Raises `specdelta.Untraceable`."""
    return joint_def_hash(def_components(model))


def content_key(model, lowering: dict, tenant: Optional[str] = None) -> str:
    """The corpus address of (model definition, lowering). `lowering` holds
    every knob that can change the visited set, the pop order or the stop
    point: batch_size, table_log2, insert_variant, the store and summary
    configuration, and the finish policy (`finish_signature`). A `tenant`
    salts the key into its own namespace (None: the default tenant)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(model_def_hash(model).encode())
    if tenant is not None:
        h.update(b"tenant:" + tenant.encode())
    h.update(repr(sorted(lowering.items())).encode())
    return h.hexdigest()


def key_components(model, lowering: dict, tenant: Optional[str] = None) -> dict:
    """The content key factored for the near and delta rungs: "def" (the
    definition hash, the family address; tenant-salted), "core" (the
    geometry digest, the spec address; tenant-salted), "comps" (the
    component vector), "batch_size" and "finish" (the pop order and the
    stop point) and "table" (the rest of the lowering, which no result
    depends on)."""
    fin = lowering.get("finish")
    comps = def_components(model)
    def_hash = joint_def_hash(comps)
    if tenant is not None:
        def_hash = hashlib.blake2b((def_hash + ":tenant:" + tenant).encode(),
                                   digest_size=16).hexdigest()
    return {
        "def": def_hash,
        "core": spec_core_hash(comps, tenant=tenant),
        "comps": comps,
        "batch_size": int(lowering.get("batch_size", 0)),
        "finish": repr(tuple(fin)) if fin is not None else repr(None),
        "table": repr(sorted((k, v) for k, v in lowering.items()
                             if k not in ("batch_size", "finish"))),
    }


def finish_signature(finish_when, target_state_count, target_max_depth):
    """The finish-policy part of a content key."""
    return (finish_when.kind, tuple(sorted(finish_when.names)), target_state_count,
            target_max_depth)


_EMPTY_U64 = np.zeros(0, dtype=np.uint64)
_EMPTY_U8 = np.zeros(0, dtype=np.uint8)


@dataclass
class CorpusEntry:
    """One published visited set: the host-tier arrays, the Bloom summary,
    the result a warm run replays, and the semantics plane's packed
    (canonical history fingerprint, verdict bit) table."""

    key: str
    fps: np.ndarray  # uint64[n] packed unsalted fingerprints
    parents: np.ndarray  # uint64[n] packed unsalted parents (0 = root)
    summary: np.ndarray  # uint32 Bloom words over the unsalted set
    summary_log2: int
    summary_hashes: int
    meta: dict  # state_count / unique_count / max_depth / discoveries
    sem_fps: np.ndarray = None  # uint64[m] canonical history fingerprints
    sem_verdicts: np.ndarray = None  # uint8[m] verdict bits
    #: False for a partial entry (its counts cover the published prefix).
    complete: bool = True
    #: Partial entries: the FIFO frontier at the cut, {"states" u32[n, L],
    #: "lo" u32[n], "hi" u32[n], "ebits" bool[n, P], "depths" u32[n]},
    #: unsalted, in pop order; None for a coverage-only partial.
    frontier: Optional[dict] = None
    #: The `key_components` recorded at publish.
    components: Optional[dict] = None
    #: Spec-CI journal planes of a complete entry, row for row with `fps`:
    #: the claimed rows in pop order (uint32[n, L]), their depths
    #: (uint32[n]) and the publisher boundary's verdict (bool[n]).
    journal_states: Optional[np.ndarray] = None
    journal_depths: Optional[np.ndarray] = None
    journal_bound: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.sem_fps is None:
            self.sem_fps = _EMPTY_U64
        if self.sem_verdicts is None:
            self.sem_verdicts = _EMPTY_U8

    @property
    def states(self) -> int:
        return int(self.fps.size)

    @property
    def verdicts(self) -> int:
        return int(self.sem_fps.size)


def _json_row(data, name="members") -> list:
    rows = json.loads(str(np.asarray(data[name]).reshape(-1)[0]))
    return rows if isinstance(rows, list) else []


class CorpusStore:
    """The content-addressed corpus directory. Thread-safe; one per service
    engine (fleet replicas each build one over the SHARED directory). The
    counters are the "corpus" source of the obs REGISTRY. The root may be a
    directory or a wire-store URI (faults/blobstore.py): entries are
    ckptio generations, and `gc` lists through the backend seam either
    way."""

    def __init__(self, root: str, summary_log2: int = 20,
                 summary_hashes: int = DEFAULT_HASHES):
        summary_words(summary_log2)  # validates >= 5
        self.root = normalize_root(root)
        self.summary_log2 = summary_log2
        self.summary_hashes = summary_hashes
        if not is_blob_uri(self.root):
            os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        # The owning fleet replica's lease (`set_lease`): publishes check it
        # and entries carry its stamp; lookups reject revoked stamps.
        self._lease = None
        # {content key: pin count}: entries live jobs preloaded, which `gc`
        # does not evict.
        self._pinned: dict = {}
        self.counters = {
            "hits": 0,
            "misses": 0,
            "publishes": 0,
            "publish_skipped": 0,
            "publish_faults": 0,
            "load_faults": 0,
            "corrupt_entries": 0,
            "lease_rejected": 0,
            "preload_states": 0,
            "verdict_preloads": 0,
            "verdicts_published": 0,
            "partial_publishes": 0,
            "partial_preloads": 0,
            "near_match_hits": 0,
            "superseded_entries": 0,
            "delta_hits": 0,
            "delta_refusals": 0,
            "component_reuse": 0,
            "gc_sweeps": 0,
            "gc_evicted": 0,
            "gc_bytes_freed": 0,
            "gc_pinned_skips": 0,
            "gc_faults": 0,
            # The port's own: jobs whose model could not be traced to a key
            # (specdelta.Untraceable) and so ran cold, unpublished.
            "untraceable": 0,
        }
        self._metrics_name = REGISTRY.register("corpus", self.metrics)

    def set_lease(self, lease) -> None:
        """Attach the owning replica's lease (service/lease.py `Lease`)."""
        self._lease = lease

    def path_for(self, key: str) -> str:
        return content_path(self.root, key)

    def partial_path_for(self, key: str) -> str:
        """The partial entry's path: a sibling under the same ``corpus-``
        prefix, never the complete entry's."""
        return content_path(self.root, key, kind="corpus-partial")

    def _family_path(self, def_hash: str) -> str:
        return content_path(self.root, def_hash, kind="corpus-family")

    def _spec_path(self, core_hash: str) -> str:
        """The spec index record of one model geometry."""
        return content_path(self.root, core_hash, kind="corpus-spec")

    def _count(self, counter: str, n: int = 1) -> None:
        with self._lock:
            self.counters[counter] += n

    def _validator(self):
        return self._lease.store.validate if self._lease is not None else None

    # -- read side -------------------------------------------------------------

    def lookup(self, key: str) -> Optional[CorpusEntry]:
        """The newest intact COMPLETE generation of `key`, or None. Never
        raises: a missing entry is a miss, a corrupt one is counted and
        ignored, an injected ``corpus.load`` fault is a miss."""
        return self._lookup_at(key, self.path_for(key))

    def lookup_partial(self, key: str) -> Optional[CorpusEntry]:
        """The newest intact PARTIAL generation of `key`, or None (the same
        contract as `lookup`); callers gate it on `warm.can_continue`."""
        return self._lookup_at(key, self.partial_path_for(key))

    def _lookup_at(self, key: str, path: str) -> Optional[CorpusEntry]:
        fenced_out = []
        try:
            maybe_fault("corpus.load", key=key[:16])  # before any file is read
            if not any_generation(path):
                self._count("misses")
                return None

            def reject(*stamp):
                fenced_out.append(stamp)
                self._count("lease_rejected")

            data, _src = fenced_load_latest(path, validator=self._validator(),
                                            on_reject=reject)
            entry = self._decode(key, data)
        except (FaultError, OSError):
            self._count("load_faults")
            self._count("misses")
            return None
        except CheckpointCorrupt:
            # A torn or flipped generation, or every candidate stamped by a
            # revoked lease: ignored, cold.
            if not fenced_out:
                self._count("corrupt_entries")
            self._count("misses")
            return None
        finally:
            if fenced_out and self._lease is not None:
                self._lease.store.count_rejected("read", len(fenced_out))
        if entry is None:
            self._count("corrupt_entries")
            self._count("misses")
            return None
        self._count("hits")
        return entry

    def _decode(self, key: str, data) -> Optional[CorpusEntry]:
        """npz -> CorpusEntry; None when the payload is not an entry of this
        key and format."""
        try:
            stored_key = str(np.asarray(data["key"]).reshape(-1)[0])
            fmt = int(np.asarray(data["format"]).reshape(-1)[0])
            if stored_key != key or fmt != FORMAT:
                return None
            cfg = np.asarray(data["cfg"], dtype=np.int64)
            counts = np.asarray(data["counts"], dtype=np.int64)
            discoveries = {str(n): int(f) for n, f in zip(data["d_names"], data["d_fps"])}
            names = getattr(data, "files", data)
            has_sem = "sem_fps" in names and "sem_verdicts" in names
            complete = True
            if "complete" in names:
                complete = bool(int(np.asarray(data["complete"]).reshape(-1)[0]))
            frontier = None
            if "f_lo" in names:
                frontier = {
                    "states": np.asarray(data["f_states"], dtype=np.uint32),
                    "lo": np.asarray(data["f_lo"], dtype=np.uint32),
                    "hi": np.asarray(data["f_hi"], dtype=np.uint32),
                    "ebits": np.asarray(data["f_ebits"], dtype=bool),
                    "depths": np.asarray(data["f_depths"], dtype=np.uint32),
                }
            components = None
            if "comp" in names:
                components = json.loads(str(np.asarray(data["comp"]).reshape(-1)[0]))
            j_states = j_depths = j_bound = None
            if "j_states" in names:
                j_states = np.asarray(data["j_states"], dtype=np.uint32)
                j_depths = np.asarray(data["j_depths"], dtype=np.uint32)
            if "j_bound" in names:
                j_bound = np.asarray(data["j_bound"], dtype=bool)
            return CorpusEntry(
                key=key,
                fps=np.asarray(data["fps"], dtype=np.uint64),
                parents=np.asarray(data["parents"], dtype=np.uint64),
                summary=np.asarray(data["summary"], dtype=np.uint32),
                summary_log2=int(cfg[0]),
                summary_hashes=int(cfg[1]),
                meta={
                    "state_count": int(counts[0]),
                    "unique_count": int(counts[1]),
                    "max_depth": int(counts[2]),
                    "discoveries": discoveries,
                },
                sem_fps=np.asarray(data["sem_fps"], dtype=np.uint64) if has_sem else None,
                sem_verdicts=(np.asarray(data["sem_verdicts"], dtype=np.uint8)
                              if has_sem else None),
                complete=complete,
                frontier=frontier,
                components=components,
                journal_states=j_states,
                journal_depths=j_depths,
                journal_bound=j_bound,
            )
        except (KeyError, ValueError, IndexError):
            return None

    def note_preload(self, n: int) -> None:
        """Account states preloaded into a tiered store."""
        self._count("preload_states", n)

    def note_partial_preload(self) -> None:
        """Account one warm-from-partial admission."""
        self._count("partial_preloads")

    def note_delta_hit(self, reused_components: int = 0) -> None:
        """Account one delta-rung salvage and the digests it reused."""
        self._count("delta_hits")
        if reused_components:
            self._count("component_reuse", reused_components)

    def note_delta_refusal(self, n: int = 1) -> None:
        """Account delta candidates the salvage rules refused (cold)."""
        if n:
            self._count("delta_refusals", n)

    def note_untraceable(self) -> None:
        """Account a job whose model has no content key (cold, unpublished)."""
        self._count("untraceable")

    # -- the family and spec indexes -------------------------------------------

    def _members(self, path: str, key_prefix: str) -> list:
        """An index record's rows; any failure reads as no rows (a miss)."""
        try:
            maybe_fault("corpus.load", key=key_prefix[:16])
            if not any_generation(path):
                return []
            data, _src = fenced_load_latest(path, validator=self._validator())
            return _json_row(data)
        except (FaultError, OSError, CheckpointCorrupt, KeyError, ValueError):
            return []

    def _rewrite(self, path: str, members: list) -> None:
        fenced_savez(path, {"members": np.asarray([json.dumps(members)], dtype=np.str_)},
                     lease=self._lease)

    def _note(self, path_of, address: str, member: dict, key: str, complete: bool) -> None:
        """Record (or refresh) one index row after a publish: read, modify,
        write, latest-wins, under this store's lock. Best-effort: a failure
        leaves the index stale (a future miss), never the entry wrong."""
        try:
            with self._lock:
                members = [m for m in self._members(path_of(address), address)
                           if m.get("key") != key or m.get("complete") != complete]
                members.append(member)
                self._rewrite(path_of(address), members)
        except (FaultError, OSError, LeaseRevoked, RuntimeError):
            pass

    def _drop(self, path_of, address: str, key: str, complete: bool) -> None:
        """Drop one index row (the superseded partial); best-effort."""
        try:
            with self._lock:
                members = [m for m in self._members(path_of(address), address)
                           if m.get("key") != key or m.get("complete") != bool(complete)]
                self._rewrite(path_of(address), members)
        except (FaultError, OSError, LeaseRevoked, RuntimeError):
            pass

    def family_members(self, def_hash: str) -> list:
        """The rows of one definition's family: {key, complete, states,
        batch_size, finish, table, comps}; empty on any failure."""
        return self._members(self._family_path(def_hash), def_hash)

    def spec_members(self, core_hash: str) -> list:
        """The rows of one geometry's spec index: {key, def, complete,
        states, batch_size, finish, comps} across every published
        definition; empty on any failure."""
        return self._members(self._spec_path(core_hash), core_hash)

    def _family_note(self, components: dict, key: str, complete: bool, states: int) -> None:
        if not components or "def" not in components:
            return
        member = {
            "key": key,
            "complete": bool(complete),
            "states": int(states),
            "batch_size": int(components.get("batch_size", -1)),
            "finish": components.get("finish"),
            "table": components.get("table"),
            "comps": components.get("comps"),
        }
        self._note(self._family_path, components["def"], member, key, bool(complete))

    def _spec_note(self, components: dict, key: str, complete: bool, states: int) -> None:
        if (not components or not components.get("core")
                or not isinstance(components.get("comps"), dict)):
            return  # no component vector to index
        member = {
            "key": key,
            "def": components.get("def"),
            "complete": bool(complete),
            "states": int(states),
            "batch_size": int(components.get("batch_size", -1)),
            "finish": components.get("finish"),
            "comps": components.get("comps"),
        }
        self._note(self._spec_path, components["core"], member, key, bool(complete))

    def lookup_near(self, components: dict, exclude: tuple = (),
                    allow_partial: bool = True) -> Optional[CorpusEntry]:
        """The family fallback after an exact miss: the best entry sharing
        `components["def"]`, replayable complete ones first (same batch and
        finish), then continuable partials (same batch), most states first.
        Keys in `exclude` are skipped. A hit counts `near_match_hits`; the
        caller gates it through store/warm.py."""
        if not components or "def" not in components:
            return None
        bs = int(components.get("batch_size", -1))
        fin = components.get("finish")
        replayable, continuable = [], []
        for m in self.family_members(components["def"]):
            if m.get("key") in exclude or m.get("batch_size") != bs:
                continue
            if m.get("complete"):
                if m.get("finish") == fin:
                    replayable.append(m)
            elif allow_partial:
                continuable.append(m)
        replayable.sort(key=lambda m: -int(m.get("states", 0)))
        continuable.sort(key=lambda m: -int(m.get("states", 0)))
        for m in replayable + continuable:
            entry = self.lookup(m["key"]) if m.get("complete") else self.lookup_partial(m["key"])
            if entry is not None:
                self._count("near_match_hits")
                return entry
        return None

    def lookup_family(self, def_hash: str) -> Optional[CorpusEntry]:
        """Any intact entry of the definition, complete ones and the most
        states first: the simulation's rung, which needs membership only."""
        members = self.family_members(def_hash)
        members.sort(key=lambda m: (0 if m.get("complete") else 1, -int(m.get("states", 0))))
        for m in members:
            entry = self.lookup(m["key"]) if m.get("complete") else self.lookup_partial(m["key"])
            if entry is not None:
                self._count("near_match_hits")
                return entry
        return None

    def preload_verdicts(self, entry: CorpusEntry) -> int:
        """Seed the semantics plane's canonical verdict cache from the
        entry's table (semantics/batch.py); returns the new verdicts
        (`verdict_preloads`). Verdicts are addressed by canonical history
        class, so a preload is never wrong for any job, only unused."""
        if entry.sem_fps.size == 0:
            return 0
        from ..semantics.batch import preload_verdicts

        n = preload_verdicts(entry.sem_fps, entry.sem_verdicts)
        if n:
            self._count("verdict_preloads", n)
        return n

    # -- GC pins ---------------------------------------------------------------

    def pin(self, key: str) -> None:
        """Keep `key` from `gc` while a live job depends on it."""
        with self._lock:
            self._pinned[key] = self._pinned.get(key, 0) + 1

    def unpin(self, key: str) -> None:
        with self._lock:
            n = self._pinned.get(key, 0) - 1
            if n <= 0:
                self._pinned.pop(key, None)
            else:
                self._pinned[key] = n

    def gc(self, max_bytes: int) -> dict:
        """An mtime-LRU sweep of the entry generations down to `max_bytes`,
        partial entries first at equal recency, skipping pinned keys (both
        generations of a pinned key). Index records are never evicted nor
        counted. ``corpus.gc`` fires before any file is removed; never
        raises. Returns {evicted, bytes_freed, pinned_skips, bytes_total}."""
        out = {"evicted": 0, "bytes_freed": 0, "pinned_skips": 0, "bytes_total": 0}
        try:
            maybe_fault("corpus.gc", max_bytes=int(max_bytes))
        except FaultError:
            self._count("gc_faults")
            return out
        self._count("gc_sweeps")
        backend = blob_backend(self.root)
        entries: dict = {}
        try:
            stats = backend.list("corpus-")
        except OSError:
            self._count("gc_faults")
            return out
        for st in stats:
            # Only the two committed generation names: another process's
            # in-flight ``.npz.tmp.<pid>`` must survive.
            if not (st.name.endswith(".npz") or st.name.endswith(".npz.prev")):
                continue
            key = st.name[len("corpus-"):].split(".npz")[0]
            if key.startswith("family-") or key.startswith("spec-"):
                continue
            ent = entries.setdefault(key, {"names": [], "bytes": 0, "mtime": 0.0,
                                           "partial": key.startswith("partial-")})
            ent["names"].append(st.name)
            ent["bytes"] += st.size
            ent["mtime"] = max(ent["mtime"], st.mtime)
        total = sum(e["bytes"] for e in entries.values())
        out["bytes_total"] = total
        if total <= max_bytes:
            return out
        with self._lock:
            pinned = set(self._pinned)
        stat_size = {st.name: st.size for st in stats}
        for key, ent in sorted(entries.items(),
                               key=lambda kv: (kv[1]["mtime"], 0 if kv[1]["partial"] else 1)):
            if total <= max_bytes:
                break
            real_key = key[len("partial-"):] if ent["partial"] else key
            if real_key in pinned:
                out["pinned_skips"] += 1
                self._count("gc_pinned_skips")
                continue
            freed = 0
            for name in ent["names"]:
                if backend.delete(name):
                    freed += stat_size.get(name, 0)
            total -= freed
            out["bytes_freed"] += freed
            out["evicted"] += 1
            self._count("gc_evicted")
            self._count("gc_bytes_freed", freed)
        out["bytes_total"] = total
        return out

    # -- write side ------------------------------------------------------------

    def publish(
        self,
        key: str,
        fps: np.ndarray,
        parents: np.ndarray,
        meta: dict,
        sem_fps: Optional[np.ndarray] = None,
        sem_verdicts: Optional[np.ndarray] = None,
        complete: bool = True,
        frontier: Optional[dict] = None,
        components: Optional[dict] = None,
        journal_states: Optional[np.ndarray] = None,
        journal_depths: Optional[np.ndarray] = None,
        journal_bound: Optional[np.ndarray] = None,
    ) -> bool:
        """Publish one visited set under `key`. A complete entry is written
        once per content address (skipped when an intact generation exists),
        deletes the partial it supersedes and is noted in the family and
        spec indexes. A partial one is latest-wins (skipped when the family
        index lists an equal or longer prefix, or a complete entry exists).
        Never raises: a failure (an injected ``corpus.publish`` fault, an
        I/O error, a revoked lease) is counted and leaves no entry."""
        path = self.path_for(key) if complete else self.partial_path_for(key)
        if self._lease is not None and not self._lease.valid():
            # A revoked replica publishes nothing, not even identical bytes.
            self._count("lease_rejected")
            self._lease.store.count_rejected("write")
            return False
        payload_extra = {}
        try:
            if latest_generation(self.path_for(key)) is not None:
                self._count("publish_skipped")  # the complete entry serves every rung
                return False
            if not complete and components:
                for m in self.family_members(components.get("def", "")):
                    if (m.get("key") == key and not m.get("complete")
                            and int(m.get("states", 0)) >= int(len(fps))):
                        self._count("publish_skipped")
                        return False
            maybe_fault("corpus.publish", key=key[:16], states=int(len(fps)))
            fps = np.asarray(fps, dtype=np.uint64)
            parents = np.asarray(parents, dtype=np.uint64)
            summary = np.zeros(summary_words(self.summary_log2), dtype=np.uint32)
            host_insert(summary, (fps & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                        (fps >> np.uint64(32)).astype(np.uint32), self.summary_log2,
                        self.summary_hashes)
            names = sorted(meta.get("discoveries", {}))
            if sem_fps is not None and len(sem_fps):
                payload_extra["sem_fps"] = np.asarray(sem_fps, dtype=np.uint64)
                payload_extra["sem_verdicts"] = np.asarray(sem_verdicts, dtype=np.uint8)
            if not complete:
                payload_extra["complete"] = np.asarray([0], dtype=np.int64)
                if frontier is not None:
                    payload_extra.update(
                        f_states=np.asarray(frontier["states"], dtype=np.uint32),
                        f_lo=np.asarray(frontier["lo"], dtype=np.uint32),
                        f_hi=np.asarray(frontier["hi"], dtype=np.uint32),
                        f_ebits=np.asarray(frontier["ebits"], dtype=bool),
                        f_depths=np.asarray(frontier["depths"], dtype=np.uint32),
                    )
            if components is not None:
                payload_extra["comp"] = np.asarray([json.dumps(components)], dtype=np.str_)
            if (complete and journal_states is not None and journal_depths is not None
                    and len(journal_states) == len(fps) and len(journal_depths) == len(fps)):
                # The Spec-CI planes; misaligned ones are dropped (the delta
                # rung then refuses this entry, never misreads it).
                payload_extra["j_states"] = np.asarray(journal_states, dtype=np.uint32)
                payload_extra["j_depths"] = np.asarray(journal_depths, dtype=np.uint32)
                if journal_bound is not None and len(journal_bound) == len(fps):
                    payload_extra["j_bound"] = np.asarray(journal_bound, dtype=bool)
            written = fenced_savez(
                path,
                {
                    "key": np.asarray([key], dtype=np.str_),
                    "format": np.asarray([FORMAT], dtype=np.int64),
                    "fps": fps,
                    "parents": parents,
                    "summary": summary,
                    **payload_extra,
                    "cfg": np.asarray([self.summary_log2, self.summary_hashes], dtype=np.int64),
                    "counts": np.asarray([meta["state_count"], meta["unique_count"],
                                          meta["max_depth"]], dtype=np.int64),
                    "d_names": np.asarray(names, dtype=np.str_),
                    "d_fps": np.asarray([meta["discoveries"][n] for n in names],
                                        dtype=np.uint64),
                },
                lease=self._lease,
                if_absent=complete,
            )
            if written is None:
                self._count("publish_skipped")
                return False
        except LeaseRevoked:
            self._count("lease_rejected")  # revoked between the check and the write
            return False
        except (FaultError, OSError):
            self._count("publish_faults")
            return False
        self._count("publishes" if complete else "partial_publishes")
        if "sem_fps" in payload_extra:
            self._count("verdicts_published", int(len(payload_extra["sem_fps"])))
        if complete:
            self._supersede_partial(key, components)
        if components is not None:
            self._family_note(components, key, complete, int(fps.size))
            self._spec_note(components, key, complete, int(fps.size))
        return True

    def _supersede_partial(self, key: str, components: Optional[dict]) -> None:
        """Delete the partial generations a complete publish supersedes
        (`superseded_entries` once, when anything went)."""
        backend = blob_backend(self.root)
        base = os.path.basename(self.partial_path_for(key))
        removed = False
        for name in (base, base + ".prev"):
            if backend.delete(name):
                removed = True
        if removed:
            self._count("superseded_entries")
            if components and "def" in components:
                self._drop(self._family_path, components["def"], key, complete=False)
            if components and components.get("core"):
                self._drop(self._spec_path, components["core"], key, complete=False)

    # -- reporting -------------------------------------------------------------

    def metrics(self) -> dict:
        """Flat counters for the obs REGISTRY "corpus" source."""
        with self._lock:
            return dict(self.counters)
