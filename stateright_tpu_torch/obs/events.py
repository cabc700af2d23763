"""The event journal: the flight recorder of the check service and its
fleet (the JAX package's `obs/events.py`, local files only: its blob-store
mirror is ROADMAP A item 3, and a wire-store URI raises).

- `EventJournal` appends schema'd events (obs/schema.py `EVENT_TYPES` pins
  the vocabulary and each type's required fields) to a JSONL file. Every
  record is stamped with wall-clock `ts`, a per-writer monotonic `seq`, the
  `writer` name and `pid`; a job's events carry the `trace` id minted at
  its submission. The format is the JAX package's, so either package's
  reader reads either's journal.
- Bounded flushing: emissions buffer in memory and reach the file every
  `flush_every` events or `flush_interval_s` seconds. A crash loses at most
  one window, and can only tear the last line, which `read_journal` skips.
- Live tails: an in-memory ring of recent events with a global cursor;
  `tail(since=, job=, wait_s=)` is the long-poll behind the service's
  `GET /jobs/<id>/events`.

`NULL_EVENTS` is the default collaborator: call sites emit unconditionally
at next to no cost when recording is off.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Optional

from .schema import EVENT_TYPES

_mint_lock = threading.Lock()
_mint_n = 0


def mint_trace_id() -> str:
    """A process-unique job trace id (pid, microsecond clock, counter),
    minted once per job at its submission."""
    global _mint_n
    with _mint_lock:
        _mint_n += 1
        n = _mint_n
    return f"{os.getpid():x}-{int(time.time() * 1e6) & 0xFFFFFFFF:08x}-{n:x}"


class EventJournal:
    """Append-only JSONL event journal with a schema'd vocabulary, bounded
    flushing and an in-memory tail ring. Thread-safe: the service's
    scheduler and its HTTP long-pollers share one.

    `path=None` keeps the journal in memory (ring and tail still work);
    with a path the file is opened for append, so a restarted writer
    continues the same file (its `seq` restarts)."""

    def __init__(
        self,
        path: Optional[str] = None,
        writer: Optional[str] = None,
        flush_every: int = 64,
        flush_interval_s: float = 0.5,
        ring: int = 4096,
        fsync: bool = False,
    ):
        self.path = path
        self.writer = writer if writer is not None else f"pid{os.getpid()}"
        self.flush_every = max(int(flush_every), 1)
        self.flush_interval_s = flush_interval_s
        self.fsync = fsync
        self.write_errors = 0  # I/O failures absorbed (recording must not kill)
        self._f = open(path, "a") if path is not None else None
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # File writes run outside _lock (an emit on the scheduler's path
        # must not wait on the disk). _io_lock orders the writers: it is
        # taken while _lock is still held and released after the write, so
        # flushed batches reach the file in emit order. Lock order: _lock,
        # then _io_lock, never the reverse.
        self._io_lock = threading.Lock()
        self._buf: list[str] = []
        self._seq = 0
        self._count = 0  # global cursor: events ever emitted here
        self._ring: deque = deque(maxlen=max(int(ring), 1))
        self._last_flush = time.monotonic()
        self._pid = os.getpid()
        self._closed = False

    @property
    def enabled(self) -> bool:
        return True

    @property
    def closed(self) -> bool:
        """True once `close()` ran (a fault plan that adopted this journal
        re-adopts the next live one)."""
        return self._closed

    def emit(self, etype: str, **fields) -> dict:
        """Append one event. `etype` must be declared in obs/schema.py
        EVENT_TYPES, with that type's required fields: anything else is a
        ValueError. None-valued fields are dropped. Returns the record."""
        required = EVENT_TYPES.get(etype)
        if required is None:
            raise ValueError(
                f"event type {etype!r} is not declared in obs/schema.py "
                "EVENT_TYPES — pin the vocabulary before emitting it"
            )
        fields = {k: v for k, v in fields.items() if v is not None}
        missing = [k for k in required if k not in fields]
        if missing:
            raise ValueError(
                f"event {etype!r} is missing required fields {missing} "
                f"(schema: {list(required)})"
            )
        batch = None
        with self._cond:
            self._seq += 1
            rec = {
                "event": etype,
                "ts": round(time.time(), 6),
                "seq": self._seq,
                "writer": self.writer,
                "pid": self._pid,
                **fields,
            }
            self._ring.append((self._count, rec))
            self._count += 1
            if self._f is not None and not self._closed:
                self._buf.append(json.dumps(rec, default=str))
                now = time.monotonic()
                if (len(self._buf) >= self.flush_every
                        or now - self._last_flush >= self.flush_interval_s):
                    batch = self._take_batch_locked(now)
            self._cond.notify_all()
        self._write_batch(batch)
        return rec

    def _take_batch_locked(self, now: Optional[float] = None):
        """The pending buffer, handed to the caller for writing outside the
        journal lock; takes _io_lock, which `_write_batch` releases."""
        if not self._buf or self._f is None:
            return None
        self._io_lock.acquire()
        batch, self._buf = self._buf, []
        self._last_flush = now if now is not None else time.monotonic()
        return batch

    def _write_batch(self, batch) -> None:
        if batch is None:
            return
        try:
            self._f.write("\n".join(batch) + "\n")
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())
        except (OSError, ValueError, AttributeError):
            # Recording must never kill its host; the loss shows as a count.
            self.write_errors += 1
        finally:
            self._io_lock.release()

    def flush(self) -> None:
        with self._lock:
            batch = self._take_batch_locked()
        self._write_batch(batch)

    def close(self) -> None:
        self.flush()
        with self._lock:
            self._closed = True
            if self._f is not None:
                with self._io_lock:  # no write in flight holds the file
                    try:
                        self._f.close()
                    except OSError:
                        self.write_errors += 1
                    self._f = None
            self._cond.notify_all()

    # -- live tails ------------------------------------------------------------

    @staticmethod
    def _matches(rec: dict, job) -> bool:
        if job is None or rec.get("job") == job:
            return True
        jobs = rec.get("jobs")
        return isinstance(jobs, (list, tuple)) and job in jobs

    def tail(self, since: int = 0, job=None, wait_s: float = 0.0) -> tuple:
        """Events with global cursor >= `since` (optionally only those
        naming `job`), long-polling up to `wait_s` seconds for a first
        match. Returns `(events, next_cursor)`; pass `next_cursor` back as
        `since` to resume. The ring is bounded: an older cursor gets what
        the ring still holds."""
        deadline = time.monotonic() + max(wait_s, 0.0)
        with self._cond:
            while True:
                out = [rec for idx, rec in self._ring
                       if idx >= since and self._matches(rec, job)]
                left = deadline - time.monotonic()
                if out or self._closed or left <= 0:
                    return out, self._count
                self._cond.wait(timeout=min(left, 0.2))

    def recent(self, n: int = 16) -> list:
        """The last `n` events, of any job."""
        with self._lock:
            return [rec for _idx, rec in list(self._ring)[-n:]]

    def cursor(self) -> int:
        with self._lock:
            return self._count


class _NullEvents:
    """emit/flush/tail no-ops: the default `events` collaborator."""

    enabled = False
    closed = False
    writer = "null"
    path = None

    def emit(self, etype: str, **fields) -> None:
        return None

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass

    def tail(self, since: int = 0, job=None, wait_s: float = 0.0) -> tuple:
        return [], since

    def recent(self, n: int = 16) -> list:
        return []

    def cursor(self) -> int:
        return 0


NULL_EVENTS = _NullEvents()


def as_events(events) -> "EventJournal | _NullEvents":
    return events if events is not None else NULL_EVENTS


# -- readers (never raise on a torn journal) -----------------------------------


def read_journal(path: str) -> list:
    """Every intact event of one journal file, in file order. An append can
    only tear the last line, so a line that does not parse is skipped; a
    missing or unreadable file is an empty journal. Never raises on the
    journal's content; a wire-store URI raises `NotImplementedError`."""
    from ..faults.blobstore import refuse_wire

    refuse_wire(path, "reading a journal")
    try:
        with open(path, "r") as f:
            data = f.read()
    except OSError:
        return []
    events = []
    for line in data.split("\n"):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict) and "event" in rec:
            events.append(rec)
    return events


def merge_events(event_lists) -> list:
    """One order over events from many journals. Each writer's own order is
    kept exactly (by its `seq`, never by wall clock); across writers,
    events interleave by `ts`, clamped monotonic within each writer."""
    streams: dict = {}
    for evs in event_lists:
        for e in evs:
            streams.setdefault(str(e.get("writer", "")), []).append(e)
    keyed = []
    for w, evs in streams.items():
        evs.sort(key=lambda e: e.get("seq", 0))
        t = float("-inf")
        for e in evs:
            ts = e.get("ts")
            if isinstance(ts, (int, float)):
                t = max(t, ts)
            keyed.append((t, w, e.get("seq", 0), e))
    keyed.sort(key=lambda k: k[:3])
    return [e for _t, _w, _s, e in keyed]


def read_journals(paths) -> list:
    """`read_journal` over many files, merged into one order."""
    return merge_events(read_journal(p) for p in paths)
