"""Admission queue and per-job state of the check service (the JAX
package's `service/queue.py`, without the fleet's journal and resume).

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
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional

import numpy as np

from ..core.discovery import HasDiscoveries
from ..faults.ckptio import atomic_savez, load_latest
from ..tensor.fingerprint import MASK32, job_salt, pack_salt
from .metrics import JobMetrics

#: What the fleet plumbing of the JAX package's queue waits for here.
FLEET_ITEM = "the service fleet (ROADMAP A14, second half)"


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
    """The fleet's requeue payload (a job continued on another replica from
    its journal). Not ported yet: constructing one raises."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"job resume is part of {FLEET_ITEM}")

    @classmethod
    def from_npz(cls, data) -> "JobResume":
        raise NotImplementedError(f"job resume is part of {FLEET_ITEM}")


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

        self._chunks: deque[_Chunk] = deque()
        self._pending = 0
        self._spill_path: Optional[str] = None

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
        self._spill_path = atomic_savez(path, self._frontier_arrays(), keep_prev=False)
        self.drop_frontier()

    def load_frontier(self) -> None:
        """Reload a spilled frontier (CRC-verified) for resumption."""
        if self._spill_path is None:
            return
        data, _src = load_latest(self._spill_path)
        states = data["q_states"].astype(np.int64)
        keys = (data["q_hi"].astype(np.int64) << 32) | data["q_lo"].astype(np.int64)
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
        """The fleet's requeue checkpoint of this job: not ported yet."""
        raise NotImplementedError(f"job snapshots are part of {FLEET_ITEM}")


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
