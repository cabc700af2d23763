"""Host-side span tracing as Chrome trace-event JSON (the JAX package's
`obs/trace.py`), with counters kept where the spans close.

An engine's device work is opaque to a wall clock, but the host phases
around it are worth a timeline: chunks of engine steps, the layers of each
step (`layer()`, cat "step": pop, properties, expand, fingerprint, insert,
eventually, append, the tiered bits, the telemetry row), the tiered store's
queue compaction, eviction and its parts, suspect resolution, checkpoints.
`Tracer` records them as complete ("ph": "X") events, so the file a run
leaves (`trace_out=` on the builder or on `spawn_cuda`) loads in Perfetto
(https://ui.perfetto.dev) or chrome://tracing.

The clock: `ts` is the Unix epoch in microseconds, the clock
`torch.profiler` stamps its events on, kept as monotonic deltas from one
wall-clock reading taken when the tracer is made (so spans never run
backwards), and `otherData.clock` says "unix_us". A `torch.profiler`
export shifts its `ts` by its `baseTimeNanoseconds`; added back, the two
files share one timeline, and each idle gap on the card sits under the host
span that was open.

Counters: for every span name the tracer keeps `count`, `host_s` (the
spans' seconds) and `self_s` (those seconds less the seconds of the spans
nested inside them, per thread); `counters()` returns them.

`device_timing=True` adds `stream_s` on a CUDA machine: each step-layer
span records one pooled CUDA event on the current stream as it opens and
one as it closes, so a layer's `stream_s` is its share of the step on the
card's timeline (its kernels, and the gaps while the host issues them).
Nothing waits for the events there: the engine calls `resolve()` after a
read that has already waited for the card (the resident engine's counter
read at each chunk boundary), which reads the finished events' times into
the counters and into a device track of the trace. The device track is
placed by an anchor event recorded by `resolve()` with the card idle, so its
intervals line up with the host spans. Off CUDA, `device_timing` records
nothing.

With `annotate=True` each span also enters `torch.profiler.record_function`
(where the JAX package enters `jax.profiler.TraceAnnotation`), so under a
`torch.profiler` session the host phases line up with the CUDA kernels in
the same view.

With `out=<path>` the trace is also flushed to that file every
`flush_every` events or `flush_interval_s` seconds (tmp file, then rename),
so a fleet replica that crashes leaves a loadable partial trace, which
obs/timeline.py can merge.

`NULL_TRACER` is the default everywhere: its `span()` and `layer()` return
one shared no-op context manager and its `resolve()` does nothing, so call
sites trace unconditionally at no cost. `layer_tracer` gives a tracer
duck-typed to `span`/`instant` (one without `layer`) a `layer()` that opens
`span(name, cat="step")`.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Optional

#: the `cat` of a step-layer span (`Tracer.layer`): the spans that
#: `device_timing` marks on the card's stream.
STEP_CAT = "step"
#: the `tid` of the device track (the step layers' intervals on the card).
DEVICE_TID = 0x7FFF0000


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0", "_ann", "_child", "_ev0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: Optional[dict]):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args
        self._ann = None
        self._ev0 = None

    def __enter__(self):
        tr = self._tracer
        tr._stack().append(self)
        self._child = 0.0
        if tr._device and self._cat == STEP_CAT:
            self._ev0 = tr._mark()
        self._t0 = time.monotonic()
        if tr.annotate:
            from torch.profiler import record_function

            self._ann = record_function(self._name)
            self._ann.__enter__()
        return self

    def __exit__(self, *exc):
        if self._ann is not None:
            self._ann.__exit__(*exc)
        t1 = time.monotonic()
        tr = self._tracer
        stack = tr._stack()
        stack.pop()
        dur = t1 - self._t0
        if stack:
            stack[-1]._child += dur
        ev = None if self._ev0 is None else (self._ev0, tr._mark())
        tr._record(self._name, self._cat, self._t0, dur, dur - self._child, self._args, ev)
        return False


class Tracer:
    """Collects trace events and per-name counters; thread-safe (a
    checker's search thread spans while its caller may save)."""

    def __init__(self, annotate: bool = False, max_events: int = 200_000,
                 out: Optional[str] = None, flush_every: int = 256,
                 flush_interval_s: float = 2.0, device_timing: bool = False):
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
        # The clock: Unix-epoch seconds as monotonic deltas from one reading.
        self._wall0 = time.time()
        self._mono0 = time.monotonic()
        self._pid = os.getpid()
        self._unflushed = 0
        self._flush_threshold = self.flush_every
        self._last_flush = time.monotonic()
        self._tls = threading.local()
        # name -> [count, host_s, self_s, stream_s]
        self._counters: dict[str, list] = {}
        self._device = device_timing and _cuda_available()
        self._pool: list = []  # recorded-and-resolved CUDA events, for reuse
        self._pending: list = []  # (name, event at open, event at close)
        self._anchor = None  # (event, monotonic seconds when it was recorded)

    def span(self, name: str, cat: str = "host", **args) -> _Span:
        """Context manager timing one phase; nests per thread."""
        return _Span(self, name, cat, args)

    def layer(self, name: str) -> _Span:
        """A span of one layer of an engine step (cat "step"): marked on the
        card's stream with `device_timing`."""
        return _Span(self, name, STEP_CAT, None)

    def instant(self, name: str, cat: str = "host", **args) -> None:
        self._append({"name": name, "cat": cat, "ph": "i", "s": "t",
                      "ts": self._us(time.monotonic())}, args)

    def _us(self, t: float) -> float:
        """A monotonic reading as Unix-epoch microseconds."""
        return (self._wall0 + (t - self._mono0)) * 1e6

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _record(self, name, cat, t0, dur, self_s, args, ev) -> None:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = [0, 0.0, 0.0, 0.0]
            c[0] += 1
            c[1] += dur
            c[2] += self_s
            if ev is not None:
                self._pending.append((name, *ev))
        self._append({"name": name, "cat": cat, "ph": "X",
                      "ts": self._us(t0), "dur": dur * 1e6}, args)

    def counters(self) -> dict:
        """{span name: {"count", "host_s", "self_s"[, "stream_s"]}} over the
        tracer's life (`stream_s` with device timing, up to the last
        `resolve()`)."""
        keys = ("count", "host_s", "self_s", "stream_s")[:4 if self._device else 3]
        with self._lock:
            return {name: dict(zip(keys, c)) for name, c in self._counters.items()}

    # -- device timing -----------------------------------------------------------

    def _mark(self):
        """One pooled CUDA event, recorded on the current stream."""
        import torch

        if self._anchor is None:
            # The first mark anchors the device track: with the card idle,
            # an event runs as it is recorded.
            torch.cuda.synchronize()
            self._anchor = (self._event(), time.monotonic())
            self._anchor[0].record()
        ev = self._event()
        ev.record()
        return ev

    def _event(self):
        import torch

        with self._lock:
            if self._pool:
                return self._pool.pop()
        return torch.cuda.Event(enable_timing=True)

    def resolve(self) -> None:
        """Read the times of the step layers' finished CUDA events into
        `stream_s` and the device track, and re-anchor the track. Call it
        right after a read that waited for the card (it waits for nothing:
        events still running stay pending, and the anchor is kept)."""
        if not self._device:
            return
        with self._lock:
            pending, self._pending = self._pending, []
        if not pending:
            return
        anchor, t_anchor = self._anchor
        base = self._us(t_anchor)
        done, keep, free = [], [], []
        for name, e0, e1 in pending:
            if not e1.query():
                keep.append((name, e0, e1))
                continue
            start = anchor.elapsed_time(e0) * 1e3  # us
            dur = e0.elapsed_time(e1) * 1e3
            done.append((name, base + start, dur))
            free += (e0, e1)
        idle = not keep
        if idle:
            free.append(anchor)
            t = time.monotonic()
            ev = self._event()
            ev.record()
            self._anchor = (ev, t)
        with self._lock:
            self._pending[:0] = keep
            self._pool.extend(free)
            for name, _, dur in done:
                self._counters[name][3] += dur / 1e6
        for name, ts, dur in done:
            self._append({"name": name, "cat": "device", "ph": "X", "ts": ts, "dur": dur,
                          "tid": DEVICE_TID}, None)

    # -- the event list and the file --------------------------------------------

    def _append(self, event: dict, args: Optional[dict]) -> None:
        event.setdefault("tid", threading.get_ident())
        event["pid"] = self._pid
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
        meta = [{"name": "process_name", "ph": "M", "pid": self._pid,
                 "args": {"name": "stateright_tpu_torch"}}]
        if self._device:
            meta.append({"name": "thread_name", "ph": "M", "pid": self._pid,
                         "tid": DEVICE_TID, "args": {"name": "CUDA stream (step layers)"}})
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped, "pid": self._pid,
                          "clock": "unix_us"},
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


def _cuda_available() -> bool:
    import torch

    return torch.cuda.is_available()


class _NullTracer:
    """span/layer/instant/resolve no-ops; the default `tracer` everywhere."""

    def span(self, name: str, cat: str = "host", **args) -> _NullSpan:
        return _NULL_SPAN

    def layer(self, name: str) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, cat: str = "host", **args) -> None:
        pass

    def resolve(self) -> None:
        pass

    def counters(self) -> dict:
        return {}

    def flush(self) -> None:
        return None


NULL_TRACER = _NullTracer()


def as_tracer(tracer: Optional[Tracer]) -> "Tracer | _NullTracer":
    return tracer if tracer is not None else NULL_TRACER


class _LayerSpans:
    """`layer()` over a tracer that has only `span()`."""

    __slots__ = ("_tracer",)

    def __init__(self, tracer):
        self._tracer = tracer

    def layer(self, name: str):
        return self._tracer.span(name, cat=STEP_CAT)


def layer_tracer(tracer):
    """What an engine opens its step-layer spans on: `tracer` itself when it
    has `layer()`, else a shim whose `layer(name)` is
    `tracer.span(name, cat="step")`."""
    return tracer if hasattr(tracer, "layer") else _LayerSpans(tracer)
