"""Host-side span tracing as Chrome trace-event JSON (the JAX package's
`obs/trace.py`).

An engine's device work is opaque to a wall clock, but the host phases
around it are worth a timeline: chunks of engine steps, the tiered store's
queue compaction, eviction and suspect resolution, checkpoints. `Tracer`
records them as complete ("ph": "X") events, so the file a run leaves
(`trace_out=` on the builder or on `spawn_cuda`) loads in Perfetto
(https://ui.perfetto.dev) or chrome://tracing.

With `annotate=True` each span also enters `torch.profiler.record_function`
(where the JAX package enters `jax.profiler.TraceAnnotation`), so under a
`torch.profiler` session the host phases line up with the CUDA kernels in
the same view.

With `out=<path>` the trace is also flushed to that file every
`flush_every` events or `flush_interval_s` seconds (tmp file, then rename),
so a fleet replica that crashes leaves a loadable partial trace, which
obs/timeline.py can merge.

`NULL_TRACER` is the default everywhere: its `span()` returns one shared
no-op context manager, so call sites trace unconditionally at no cost.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Optional


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0", "_ann")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args
        self._ann = None

    def __enter__(self):
        self._t0 = time.monotonic()
        if self._tracer.annotate:
            from torch.profiler import record_function

            self._ann = record_function(self._name)
            self._ann.__enter__()
        return self

    def __exit__(self, *exc):
        if self._ann is not None:
            self._ann.__exit__(*exc)
        self._tracer._record(self._name, self._cat, self._t0, time.monotonic(), self._args)
        return False


class Tracer:
    """Collects trace events; thread-safe (a checker's search thread spans
    while its caller may save)."""

    def __init__(self, annotate: bool = False, max_events: int = 200_000,
                 out: Optional[str] = None, flush_every: int = 256,
                 flush_interval_s: float = 2.0):
        self.annotate = annotate
        self.max_events = max_events
        self.out = out
        self.flush_every = max(int(flush_every), 1)
        self.flush_interval_s = flush_interval_s
        self.events: list[dict] = []
        self.dropped = 0
        self._lock = threading.Lock()
        # Flushes write outside _lock; this lock orders the writers of `out`.
        self._io_lock = threading.Lock()
        self._epoch = time.monotonic()
        self._pid = os.getpid()
        self._unflushed = 0
        self._flush_threshold = self.flush_every
        self._last_flush = time.monotonic()

    def span(self, name: str, cat: str = "host", **args) -> _Span:
        """Context manager timing one phase; nests per thread."""
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "host", **args) -> None:
        self._append({"name": name, "cat": cat, "ph": "i", "s": "t",
                      "ts": (time.monotonic() - self._epoch) * 1e6}, args)

    def _record(self, name, cat, t0, t1, args) -> None:
        self._append({"name": name, "cat": cat, "ph": "X",
                      "ts": (t0 - self._epoch) * 1e6, "dur": (t1 - t0) * 1e6}, args)

    def _append(self, event: dict, args: dict) -> None:
        event.update(pid=self._pid, tid=threading.get_ident())
        if args:
            event["args"] = args
        with self._lock:
            if len(self.events) >= self.max_events:
                self.dropped += 1
                return
            self.events.append(event)
            snap = self._maybe_flush_locked()
        if snap is not None:
            with self._io_lock, contextlib.suppress(OSError):  # never fail the host
                self._write(self.out, self._envelope(snap))

    def _maybe_flush_locked(self) -> Optional[list]:
        """The events to flush now (under _lock), or None. Each flush
        rewrites the whole file, so the count trigger grows with the trace
        (half its length) and the time trigger backs off up to 16x: a long
        run costs linear, not quadratic, writes, and a crash loses at most
        16 x `flush_interval_s` of recording."""
        if self.out is None:
            return None
        self._unflushed += 1
        now = time.monotonic()
        interval = self.flush_interval_s * min(
            max(len(self.events) / (4.0 * self.flush_every), 1.0), 16.0)
        if self._unflushed < self._flush_threshold and now - self._last_flush < interval:
            return None
        self._unflushed = 0
        self._last_flush = now
        self._flush_threshold = max(self.flush_every, len(self.events) // 2)
        return list(self.events)

    def _envelope(self, events: list) -> dict:
        meta = {"name": "process_name", "ph": "M", "pid": self._pid,
                "args": {"name": "stateright_tpu_torch"}}
        return {
            "traceEvents": [meta] + events,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped, "pid": self._pid},
        }

    @staticmethod
    def _write(path: str, envelope: dict) -> None:
        """Write the envelope to `path` (tmp file, then rename, so the file
        is always whole)."""
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(envelope, f)
        os.replace(tmp, path)

    def to_json(self) -> dict:
        """The Chrome trace-event envelope (the object form)."""
        with self._lock:
            events = list(self.events)
        return self._envelope(events)

    def flush(self) -> Optional[str]:
        """Write the trace to `out` now (None without an `out` path).
        Tracing must not fail its host: a write error is swallowed."""
        if self.out is None:
            return None
        with self._io_lock:
            try:
                self._write(self.out, self.to_json())
            except OSError:
                return None
        return self.out

    def save(self, path: Optional[str] = None) -> str:
        """Write the trace JSON to `path` (default: `out`) and return it."""
        path = path if path is not None else self.out
        with self._io_lock:
            self._write(path, self.to_json())
        return path


class _NullTracer:
    """span/instant no-ops; the default `tracer` everywhere."""

    def span(self, name: str, cat: str = "host", **args) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, cat: str = "host", **args) -> None:
        pass

    def flush(self) -> None:
        return None


NULL_TRACER = _NullTracer()


def as_tracer(tracer: Optional[Tracer]) -> "Tracer | _NullTracer":
    return tracer if tracer is not None else NULL_TRACER
