"""Host-side span tracing as Chrome trace-event JSON (the JAX package's
`obs/trace.py`, without the periodic flush its service fleet needs).

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

`NULL_TRACER` is the default everywhere: its `span()` returns one shared
no-op context manager, so call sites trace unconditionally at no cost.
"""

from __future__ import annotations

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

    def __init__(self, annotate: bool = False, max_events: int = 200_000):
        self.annotate = annotate
        self.max_events = max_events
        self.events: list[dict] = []
        self.dropped = 0
        self._lock = threading.Lock()
        self._epoch = time.monotonic()
        self._pid = os.getpid()

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

    def to_json(self) -> dict:
        """The Chrome trace-event envelope (the object form)."""
        with self._lock:
            events = list(self.events)
        meta = {"name": "process_name", "ph": "M", "pid": self._pid,
                "args": {"name": "stateright_tpu_torch"}}
        return {
            "traceEvents": [meta] + events,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped, "pid": self._pid},
        }

    def save(self, path: str) -> str:
        """Write the trace JSON to `path` (tmp file, then rename, so the
        file is always whole) and return the path."""
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f)
        os.replace(tmp, path)
        return path


class _NullTracer:
    """span/instant no-ops; the default `tracer` everywhere."""

    def span(self, name: str, cat: str = "host", **args) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, cat: str = "host", **args) -> None:
        pass


NULL_TRACER = _NullTracer()


def as_tracer(tracer: Optional[Tracer]) -> "Tracer | _NullTracer":
    return tracer if tracer is not None else NULL_TRACER
