"""Epoch-fenced checkpoint leases: the fleet's zombie fence (the JAX
package's `service/lease.py`).

A replica the router declares dead may be alive (hung, or cut off from the
router), and without a fence it would keep writing checkpoint generations
and terminal journal events for jobs the router already handed to a
survivor. The fence makes such a false death harmless, as fencing tokens do
in every lease-based store:

- The router owns one monotonically increasing epoch per ring member, in a
  CRC'd lease record under a shared directory (`LeaseStore`). `grant` bumps
  the epoch and marks it held; `revoke`, called before a dead member's jobs
  are requeued, marks it fenced. Both writes are crash-atomic, with a
  ``.prev`` generation (faults/ckptio.py `write_record`).
- Every replica write re-validates its `Lease` and is stamped with
  (member, epoch): checkpoint generations through `ckptio.fenced_savez`,
  terminal and requeue journal events through `FencedEvents`. A revoked
  writer refuses its own write (`LeaseRevoked`); the one write that can slip
  past the check (the ``fleet.zombie_write`` chaos point) is rejected
  read-side by `ckptio.fenced_load_latest`.
- Every refusal and rejection is counted (`rejected_writes`,
  `rejected_reads`, `rejected_events`; the "lease" registry source, summed
  into the fleet's `lease_rejected`).

Chaos points: ``lease.revoke_race`` fires at the top of `revoke` (the lease
stays granted and the router retries next tick); ``fleet.zombie_write`` is
consumed by the fenced writer. The records are the JAX package's byte for
byte, so either package's store reads the other's. Local roots only: a
wire-store root raises `NotImplementedError` naming ROADMAP A item 3.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional

from ..faults.blobstore import normalize_root, refuse_wire
from ..faults.ckptio import (
    CheckpointCorrupt,
    LeaseRevoked,
    fenced_load_latest,
    read_record_latest,
    write_record,
)
from ..faults.plan import maybe_fault
from ..obs import REGISTRY
from ..obs.schema import LEASE_GATED_EVENTS

#: Lease-record magic for the shared CRC'd record footer
#: (`ckptio.write_record` / `read_record_latest` — payload is JSON, not npz).
LEASE_MAGIC = b"SRTPLSE1"

GRANTED = "granted"
REVOKED = "revoked"


# LeaseRevoked lives in faults/ckptio.py, below every fenced caller.
__all__ = [
    "FencedEvents",
    "Lease",
    "LeaseRevoked",
    "LeaseStore",
    "load_fenced_resume",
]


class Lease:
    """One writer's fencing token: (member, epoch) plus the store to
    re-validate against. Handed to `ckptio.fenced_savez` (duck-typed:
    `.member` / `.epoch` / `.check()`) and `FencedEvents`."""

    __slots__ = ("member", "epoch", "store")

    def __init__(self, member: str, epoch: int, store: "LeaseStore"):
        self.member = member
        self.epoch = epoch
        self.store = store

    def valid(self) -> bool:
        """Re-read the lease file: True iff this exact (member, epoch) is
        still granted. A torn/unreadable lease file reads as NOT valid —
        fencing fails safe (a fenced writer refuses; the router, the only
        lease writer, re-persists on its next transition)."""
        return self.store.validate(self.member, self.epoch)

    def check(self) -> None:
        """The write-side fence: raise `LeaseRevoked` (and count the
        refusal) instead of letting a revoked writer touch shared state."""
        if not self.valid():
            self.store.count_rejected("write")
            raise LeaseRevoked(
                f"lease for {self.member} (epoch {self.epoch}) is revoked; "
                "refusing the fenced write"
            )

    def __repr__(self) -> str:
        return f"Lease({self.member!r}, epoch={self.epoch})"


class LeaseStore:
    """The shared lease directory: one CRC-checked record per ring member,
    written only by the router (the single lease authority), read by every
    fenced writer/loader in every process. Thread-safe; counters exported
    through the obs REGISTRY "lease" source."""

    def __init__(self, root: str):
        self.root = normalize_root(root)
        refuse_wire(self.root, "a lease store")
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        self.counters = {
            "grants": 0,
            "revokes": 0,
            "rejected_writes": 0,
            "rejected_reads": 0,
            "rejected_events": 0,
        }
        self._metrics_name = REGISTRY.register("lease", self.metrics)

    def path_for(self, member: str) -> str:
        # Member names are fleet-internal ("router", "replica0", ...);
        # sanitize anyway so a name can never escape the lease root.
        safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in member)
        return os.path.join(self.root, f"lease-{safe}.json")

    # -- the router's write side (single authority) ----------------------------

    def _write(self, member: str, epoch: int, state: str) -> None:
        """Crash-atomic lease record write (`ckptio.write_record`: CRC
        footer, tmp, fsync, rename, the previous record kept at ``.prev``),
        verified after the write: a revoke that did not land would fall back
        to the granted ``.prev`` and un-fence the zombie. A failed
        verification retries; a persistent one raises, and the router's
        death handling aborts whole and runs again next tick."""
        payload = json.dumps(
            {"member": member, "epoch": int(epoch), "state": state}
        ).encode()
        path = self.path_for(member)
        for _attempt in range(3):
            write_record(path, payload, LEASE_MAGIC)
            if self._read(member) == (int(epoch), state):
                return
        raise OSError(
            f"lease record for {member!r} failed post-write verification "
            "(torn writes exhausted retries); the transition is NOT durable"
        )

    def grant(self, member: str) -> Lease:
        """Grant `member` a fresh epoch (old epochs are implicitly revoked:
        validation requires an exact epoch match). Returns the Lease the
        holder stamps its writes with."""
        with self._lock:
            epoch, _state = self._read(member)
            epoch += 1
            self._write(member, epoch, GRANTED)
            self.counters["grants"] += 1
        return Lease(member, epoch, self)

    def revoke(self, member: str) -> Optional[int]:
        """Fence `member` out: persist its current epoch as revoked. MUST
        complete before the member's jobs are requeued (revoke-then-requeue
        is what makes the zombie's later writes provably stale). Idempotent;
        returns the revoked epoch (None when the member never held one).
        The ``lease.revoke_race`` chaos point fires BEFORE anything is
        persisted, so an injected fault leaves the lease granted and the
        caller simply retries on its next tick."""
        maybe_fault("lease.revoke_race", member=member)
        with self._lock:
            epoch, state = self._read(member)
            if epoch == 0:
                return None
            if state != REVOKED:
                self._write(member, epoch, REVOKED)
                self.counters["revokes"] += 1
            return epoch

    # -- everyone's read side --------------------------------------------------

    def _read(self, member: str) -> tuple:
        """(epoch, state) for `member`: the newest intact lease record,
        `.prev` fallback included; (0, "none") when the member never held
        a lease; (0, "unreadable") when every record is torn (fail-safe: it
        validates False, so a fenced writer refuses instead of guessing)."""
        payload, any_file = read_record_latest(
            self.path_for(member), LEASE_MAGIC
        )
        if payload is not None:
            try:
                rec = json.loads(payload)
                return int(rec["epoch"]), str(rec["state"])
            except (ValueError, KeyError):
                any_file = True
        return (0, "unreadable") if any_file else (0, "none")

    def state(self, member: str) -> tuple:
        return self._read(member)

    def validate(self, member: str, epoch: int) -> bool:
        """The fence predicate: (member, epoch) is valid iff the member's
        newest intact lease record says exactly this epoch is granted."""
        cur, state = self._read(member)
        return state == GRANTED and cur == int(epoch)

    def acquire(self, member: str) -> Lease:
        """A replica process picking up the lease the router granted it
        (the router grants BEFORE spawning; the holder only reads). Raises
        `LeaseRevoked` when no granted lease exists for `member`."""
        epoch, state = self._read(member)
        if state != GRANTED or epoch == 0:
            raise LeaseRevoked(
                f"no granted lease for {member!r} (state={state}, "
                f"epoch={epoch}); the router grants before spawn"
            )
        return Lease(member, epoch, self)

    # -- accounting ------------------------------------------------------------

    def count_rejected(self, surface: str, n: int = 1) -> None:
        """Account one fenced refusal/rejection: `surface` is "write"
        (pre-write check refused), "read" (a loader skipped a
        stale-stamped generation), or "event" (FencedEvents dropped a
        gated journal event)."""
        key = f"rejected_{surface}s"
        with self._lock:
            self.counters[key] = self.counters.get(key, 0) + n

    def rejected_total(self) -> int:
        with self._lock:
            return sum(
                v for k, v in self.counters.items()
                if k.startswith("rejected_")
            )

    def metrics(self) -> dict:
        """Flat counters for the obs REGISTRY "lease" source."""
        with self._lock:
            out = dict(self.counters)
        out["rejected_total"] = sum(
            v for k, v in out.items() if k.startswith("rejected_")
        )
        return out

    def close(self) -> None:
        REGISTRY.unregister(self._metrics_name)


def load_fenced_resume(path: str, lease_store: Optional[LeaseStore]):
    """ResumeToken path -> queue.JobResume through the fence, or None
    (restart fresh, still exact) when nothing survives the CRC and stamp
    checks. Rejected generations count as lease "read" rejections."""
    from .queue import JobResume

    try:
        data, _src = fenced_load_latest(
            path,
            validator=(
                lease_store.validate if lease_store is not None else None
            ),
            on_reject=(
                (lambda _p, _m, _e: lease_store.count_rejected("read"))
                if lease_store is not None else None
            ),
        )
    except CheckpointCorrupt:  # no intact generation passed: restart fresh
        return None
    return JobResume.from_npz(data)


class FencedEvents:
    """Flight-recorder wrapper that gates terminal/requeue-relevant journal
    events behind the writer's lease (obs/schema.py LEASE_GATED_EVENTS) and
    stamps every event with the writer's epoch. A revoked writer's gated
    emit is dropped, counted, and recorded as a `lease.reject` event
    (rejection is evidence — it is itself ungated). Hot-path events
    (engine.chunk) pass through unchecked: gating them would put lease-file
    I/O on the fused-step path, and the timeline treats them as harmless.
    """

    def __init__(self, events, lease: Lease):
        self._inner = events
        self._lease = lease

    # The journal surface call sites rely on (obs/events.py):

    @property
    def enabled(self) -> bool:
        return self._inner.enabled

    @property
    def closed(self) -> bool:
        return self._inner.closed

    @property
    def writer(self):
        return self._inner.writer

    @property
    def path(self):
        return self._inner.path

    def emit(self, etype: str, **fields):
        if etype in LEASE_GATED_EVENTS and not self._lease.valid():
            self._lease.store.count_rejected("event")
            try:
                self._inner.emit(
                    "lease.reject", member=self._lease.member,
                    epoch=self._lease.epoch, surface="event", dropped=etype,
                )
            except Exception:  # noqa: BLE001 — recording never raises upward
                pass
            return None
        fields.setdefault("epoch", self._lease.epoch)
        return self._inner.emit(etype, **fields)

    def flush(self) -> None:
        self._inner.flush()

    def close(self) -> None:
        self._inner.close()

    def tail(self, since: int = 0, job=None, wait_s: float = 0.0) -> tuple:
        return self._inner.tail(since=since, job=job, wait_s=wait_s)

    def recent(self, n: int = 16) -> list:
        return self._inner.recent(n)

    def cursor(self) -> int:
        return self._inner.cursor()
