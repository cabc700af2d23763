"""Admission queue and per-job state of the check service (the JAX
package's `service/queue.py`).

A `Job` owns everything host-side about one check: its fingerprint salt
(tensor/fingerprint.py `job_salt`, what lets co-resident jobs share one
device table), its frontier (chunks of numpy rows with a depth per row, so
one batch may mix depths without breaking BFS order), its counters,
discoveries and completion event. The `AdmissionQueue` orders waiting jobs
by (priority desc, submission order); a preempted job re-enters behind its
priority class, which makes admission round-robin.

A frontier row is a state (int64[L]), its packed unsalted key (int64,
tensor/fingerprint.py `pack_fp`), its eventually bits and its depth.
Preemption spills the pending frontier to disk in the engines' checkpoint
queue schema, the JAX package's arrays (`q_states / q_lo / q_hi / q_ebits /
q_depths / q_lens`, uint32 where the JAX package has uint32), so the file
is the JAX service's.

The fleet's requeue plane: a job submitted with `journal=True` records each
unique state it claims as (unsalted key, unsalted parent key), packed int64
like every key of the port, so a fleet replica can checkpoint it
(`fleet_snapshot`) and a survivor can continue it from that checkpoint
(`JobResume`) after the replica dies. The snapshot speaks the JAX format —
`j_lo / j_hi / jp_lo / jp_hi` uint32, the frontier's queue arrays,
`c_counts`, `w_warm`, `d_names / d_fps` — converted at this boundary only,
so either package resumes the other's checkpoint. With a corpus the job
also journals each claimed row and its depth (`state_journal`, the Spec-CI
plane a complete publish records), and carries its warm-ladder state.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional

import numpy as np

from ..core.discovery import HasDiscoveries
from ..faults.ckptio import fenced_savez, load_latest
from ..tensor.fingerprint import MASK32, job_salt, pack_salt
from .metrics import JobMetrics


def _split(keys) -> tuple:
    """Packed int64 keys -> (lo, hi) uint32 arrays, the JAX format."""
    keys = np.asarray(keys, np.int64)
    return (keys & MASK32).astype(np.uint32), ((keys >> 32) & MASK32).astype(np.uint32)


def _pack(lo, hi) -> np.ndarray:
    """(lo, hi) uint32 arrays -> packed int64 keys."""
    return (np.asarray(hi).astype(np.int64) << 32) | np.asarray(lo).astype(np.int64)


class JobStatus:
    QUEUED = "queued"
    RUNNING = "running"
    PREEMPTED = "preempted"
    DONE = "done"
    CANCELLED = "cancelled"
    ERROR = "error"

    FINISHED = (DONE, CANCELLED, ERROR)


class _Chunk:
    """One frontier segment: states, packed unsalted keys, eventually-bit
    rows and depths."""

    __slots__ = ("states", "keys", "ebits", "depth")

    def __init__(self, states, keys, ebits, depth):
        self.states = states  # int64[n, L]
        self.keys = keys  # int64[n]
        self.ebits = ebits  # bool[n, P]
        self.depth = depth  # int64[n]

    def __len__(self) -> int:
        return len(self.keys)


class JobResume:
    """A fleet requeue payload: what a job needs to continue on a replica
    whose table holds none of its visited set. Built from a
    `fleet_snapshot` checkpoint by `from_npz`, in the JAX format: `chunks`
    are (states, lo, hi, ebits, depth) uint32 tuples and `journal` is
    (j_lo, j_hi, jp_lo, jp_hi) uint32 arrays; the scheduler packs them when
    it re-seeds (scheduler.py `_admit_resumed`)."""

    __slots__ = ("chunks", "journal", "state_count", "unique_count", "max_depth",
                 "discoveries", "was_warm")

    def __init__(self, chunks, journal, state_count, unique_count, max_depth,
                 discoveries, was_warm=False):
        self.chunks = chunks
        self.journal = journal
        self.state_count = state_count
        self.unique_count = unique_count
        self.max_depth = max_depth
        self.discoveries = discoveries  # {property name: unsalted host fingerprint}
        # The checkpoint came from a warm-started run (store/corpus.py): its
        # journal covers only the re-expanded slice, so only a replica that
        # re-warms from the same entry may resume it.
        self.was_warm = was_warm

    @classmethod
    def from_npz(cls, data) -> "JobResume":
        chunks = []
        off = 0
        for ln in data["q_lens"]:
            sl = slice(off, off + int(ln))
            chunks.append((data["q_states"][sl], data["q_lo"][sl], data["q_hi"][sl],
                           data["q_ebits"][sl], data["q_depths"][sl]))
            off += int(ln)
        counts = data["c_counts"]
        try:
            was_warm = bool(int(np.asarray(data["w_warm"]).reshape(-1)[0]))
        except KeyError:
            was_warm = False  # a generation written before the corpus
        return cls(
            chunks=chunks,
            journal=(data["j_lo"], data["j_hi"], data["jp_lo"], data["jp_hi"]),
            state_count=int(counts[0]),
            unique_count=int(counts[1]),
            max_depth=int(counts[2]),
            discoveries={str(n): int(f) for n, f in zip(data["d_names"], data["d_fps"])},
            was_warm=was_warm,
        )


class Job:
    def __init__(
        self,
        job_id: int,
        model,
        finish_when: HasDiscoveries = HasDiscoveries.ALL,
        target_state_count: Optional[int] = None,
        target_max_depth: Optional[int] = None,
        timeout: Optional[float] = None,
        priority: int = 0,
        journal: bool = False,
        resume: Optional[JobResume] = None,
        trace: Optional[str] = None,
        tenant: str = "default",
    ):
        self.id = job_id
        self.model = model
        # The tenancy identity; "default" is the quota-free namespace.
        self.tenant = tenant
        # The flight-recorder correlation id, minted at submission.
        self.trace = trace
        self.salt_lo, self.salt_hi = job_salt(job_id)
        self.salt = pack_salt(self.salt_lo, self.salt_hi)  # int64 key value
        self.finish_when = finish_when
        self.target_state_count = target_state_count
        self.target_max_depth = target_max_depth
        self.timeout = timeout
        self.priority = priority

        self.status = JobStatus.QUEUED
        self.metrics = JobMetrics.now()
        self.deadline = None if timeout is None else self.metrics.submitted_at + timeout
        self.state_count = 0
        self.unique_count = 0
        self.max_depth = 0
        self.steps_since_admit = 0
        self.early_exit = False
        self.timed_out = False
        self.quarantined = False  # poison job parked by the retry policy
        self.discoveries: dict[str, int] = {}  # name -> unsalted host fingerprint
        self.result = None  # SearchResult once finished
        self.error: Optional[str] = None
        self.event = threading.Event()

        # The warm-start corpus (store/corpus.py): the job's content key; the
        # publisher's result once an entry was preloaded (replayed at a
        # natural finish); a prefetched entry and its rung, parked off the
        # service lock by `ServiceEngine.prefetch_warm` and consumed at
        # admission (`warm_checked`: a prefetch ran, so a miss or an
        # injected fault is not retried); the states preloaded; whether this
        # job published.
        self.content_key: Optional[str] = None
        self.warm: Optional[dict] = None
        self.warm_entry = None
        self.warm_entry_kind = None
        self.warm_checked = False
        self.warm_states = 0
        self.published = False
        # The rung that served (knobs.WARM_KINDS; None cold), a continuable
        # partial entry parked for `admit`, and the key of the GC pin taken
        # (the served entry's: another key on the near rung).
        self.warm_kind = None
        self.partial_entry = None
        self.corpus_pin_key = None
        self.corpus_pinned = False
        # The Spec-CI rung (store/specdelta.py): the edit class it salvaged,
        # the rung a parked partial admits under ("delta" for a widened
        # boundary's continuation) and the publish veto of such a
        # continuation, whose depths are not a cold run's.
        self.delta_class = None
        self.partial_kind = "partial"
        self.no_publish = False
        # Verdict bits the preload seeded into the semantics cache.
        self.verdict_preloads = 0

        self._chunks: deque[_Chunk] = deque()
        self._pending = 0
        self._spill_path: Optional[str] = None
        # The fleet's requeue journal: (unsalted keys, unsalted parent keys)
        # int64 pairs, one per batch of claims; a root's parent is 0.
        self.journal: Optional[list] = [] if journal or resume else None
        # The Spec-CI plane beside it: the claimed state rows and their pop
        # depths, row for row. Appending keys without rows (a fleet-only
        # journal, a resumed payload) drops the plane for good, so a plane
        # that is not None is always aligned with the journal.
        self.state_journal: Optional[list] = [] if journal or resume else None
        self.resume = resume

    # -- frontier --------------------------------------------------------------

    @property
    def pending_lanes(self) -> int:
        return self._pending

    def push(self, states, keys, ebits, depth) -> None:
        if len(keys) == 0:
            return
        self._chunks.append(_Chunk(states, keys, ebits, depth))
        self._pending += len(keys)

    def push_front(self, states, keys, ebits, depth) -> None:
        """Return lanes a faulted step took to the front of the frontier,
        so that the retry pops them in the same order."""
        if len(keys) == 0:
            return
        self._chunks.appendleft(_Chunk(states, keys, ebits, depth))
        self._pending += len(keys)

    def take(self, k: int):
        """Pop up to k rows from the front (first in, first out across
        chunks: the order a standalone engine's coalesced same-depth queue
        pops). Returns (states, keys, ebits, depth) with n <= k rows."""
        parts = []
        taken = 0
        while taken < k and self._chunks:
            c = self._chunks[0]
            need = k - taken
            if len(c) <= need:
                parts.append(c)
                self._chunks.popleft()
                taken += len(c)
            else:
                parts.append(_Chunk(c.states[:need], c.keys[:need], c.ebits[:need],
                                    c.depth[:need]))
                self._chunks[0] = _Chunk(c.states[need:], c.keys[need:], c.ebits[need:],
                                         c.depth[need:])
                taken += need
        self._pending -= taken
        if len(parts) == 1:
            c = parts[0]
            return c.states, c.keys, c.ebits, c.depth
        return tuple(np.concatenate([getattr(c, f) for c in parts])
                     for f in _Chunk.__slots__)

    def drop_frontier(self) -> None:
        self._chunks.clear()
        self._pending = 0

    def journal_append(self, keys, parents, states=None, depths=None) -> None:
        """Record freshly claimed unique states: unsalted keys and their
        unsalted parent keys (0 for an initial state), and, for the Spec-CI
        plane, their rows and pop depths (without them the plane is
        dropped)."""
        if self.journal is None or len(keys) == 0:
            return
        self.journal.append((np.asarray(keys, np.int64), np.asarray(parents, np.int64)))
        if self.state_journal is None:
            return
        if states is None or depths is None:
            self.state_journal = None
            return
        self.state_journal.append((np.asarray(states, np.int64), np.asarray(depths, np.int64)))

    # -- preemption spill (the checkpoint queue schema) --------------------------

    def _frontier_arrays(self) -> dict:
        """The pending frontier in the engines' checkpoint queue schema, the
        JAX package's dtypes: states, lo, hi and depths uint32."""
        chunks = list(self._chunks)
        L = self.model.lanes
        P = len(self.model.properties())
        if chunks:
            states = np.concatenate([c.states for c in chunks])
            keys = np.concatenate([c.keys for c in chunks])
            ebits = np.concatenate([c.ebits for c in chunks])
            depth = np.concatenate([c.depth for c in chunks])
        else:
            states, keys = np.zeros((0, L), np.int64), np.zeros(0, np.int64)
            ebits, depth = np.zeros((0, P), bool), np.zeros(0, np.int64)
        return dict(
            q_states=states.astype(np.uint32),
            q_lo=(keys & MASK32).astype(np.uint32),
            q_hi=((keys >> 32) & MASK32).astype(np.uint32),
            q_ebits=ebits,
            q_depths=depth.astype(np.uint32),
            q_lens=np.asarray([len(c) for c in chunks], np.int64),
        )

    def spill_frontier(self, path: str) -> None:
        """Park the pending frontier on disk (crash-atomic, CRC footer:
        faults/ckptio.py) and free its host memory."""
        self._spill_path = fenced_savez(path, self._frontier_arrays(), keep_prev=False)
        self.drop_frontier()

    def load_frontier(self) -> None:
        """Reload a spilled frontier (CRC-verified) for resumption."""
        if self._spill_path is None:
            return
        data, _src = load_latest(self._spill_path)
        states = data["q_states"].astype(np.int64)
        keys = _pack(data["q_lo"], data["q_hi"])
        ebits = np.asarray(data["q_ebits"], bool)
        depth = data["q_depths"].astype(np.int64)
        off = 0
        for ln in data["q_lens"]:
            ln = int(ln)
            sl = slice(off, off + ln)
            self.push(states[sl], keys[sl], ebits[sl], depth[sl])
            off += ln
        self._spill_path = None

    def fleet_snapshot(self) -> dict:
        """The fleet's requeue checkpoint of this job, in the JAX format: the
        pending frontier, the whole journal, the counters and discoveries.
        Call under the owning service's lock (no step may run mid-copy); the
        replica writes it through `faults/ckptio.fenced_savez`."""
        j = self.journal or []
        keys = np.concatenate([c[0] for c in j]) if j else np.zeros(0, np.int64)
        parents = np.concatenate([c[1] for c in j]) if j else np.zeros(0, np.int64)
        j_lo, j_hi = _split(keys)
        jp_lo, jp_hi = _split(parents)
        names = sorted(self.discoveries)
        arrays = self._frontier_arrays()
        arrays.update(
            j_lo=j_lo, j_hi=j_hi, jp_lo=jp_lo, jp_hi=jp_hi,
            c_counts=np.asarray([self.state_count, self.unique_count, self.max_depth],
                                np.int64),
            # A warm run's journal covers only what it re-expanded: the mark
            # makes a resuming replica re-warm or restart (JobResume.was_warm).
            w_warm=np.asarray([1 if self.warm is not None else 0], np.int64),
            d_names=np.asarray(names, dtype=np.str_),
            d_fps=np.asarray([self.discoveries[n] for n in names], np.uint64),
        )
        return arrays


class AdmissionQueue:
    """Waiting jobs ordered by (priority desc, arrival). A preempted job
    re-enters through `push` behind queued peers of its priority.

    Within the top priority class, `pop_next` rotates over the tenants
    present (in first-arrival order) instead of draining one tenant's
    backlog, so a tenant flooding the queue delays another tenant's job by
    at most one admission per tenant present. With one tenant the pick is
    the head of the queue."""

    def __init__(self):
        self._q: list[Job] = []
        self._seq = 0
        self._order: dict[int, int] = {}
        self._last_tenant: Optional[str] = None

    def __len__(self) -> int:
        return len(self._q)

    def push(self, job: Job) -> None:
        self._order[job.id] = self._seq
        self._seq += 1
        self._q.append(job)
        self._q.sort(key=lambda j: (-j.priority, self._order[j.id]))

    def pop_next(self) -> Optional[Job]:
        if not self._q:
            return None
        top = self._q[0].priority
        cls = [j for j in self._q if j.priority == top]
        tenants: list[str] = []
        for j in cls:
            if j.tenant not in tenants:
                tenants.append(j.tenant)
        if len(tenants) == 1:
            pick = cls[0]
        else:
            # The tenant after the last one served; an absent last tenant
            # starts again at the head.
            i = ((tenants.index(self._last_tenant) + 1) % len(tenants)
                 if self._last_tenant in tenants else 0)
            pick = next(j for j in cls if j.tenant == tenants[i])
        self._last_tenant = pick.tenant
        self._q.remove(pick)
        return pick

    def peek(self) -> Optional[Job]:
        return self._q[0] if self._q else None

    def remove(self, job: Job) -> bool:
        try:
            self._q.remove(job)
            return True
        except ValueError:
            return False

    def jobs(self) -> list:
        """The waiting jobs in queue order."""
        return list(self._q)
