"""The traced slice of a window: `torch.profiler` over whole chunks of the
engine's steps, and what the device did in it.

`SliceTracer` is handed to the engine as its tracer (the engine's spans:
`resident.chunk` around each chunk of steps, which ends with the engine's
one read of its counters, so the card is idle when the span closes;
`tiered.evict` and `tiered.queue_compact` inside the tiered store's
service). It records every span for the idle gaps' labels, and starts and
ends the slice on the engine's own thread as a chunk span closes, so the
slice holds whole chunks and `steps` is exact. The chunk and run spans
outside the slice give the seconds of an untraced step, against which the
slice's device seconds per step read the device's idle share. The profiler has to stop on
the thread that started it, and its stop holds that thread for seconds
while it collects the slice's events: `stall_s` is the time the profiler's
start and stop held the engine, which the window-based readers of a traced
run take out of the window.

Where the slice starts comes from the configuration's `profile_slice`:
`start_after_s` seconds into the window and, with `after_span`, after the
first such span has ended; it holds `chunks` chunks.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Optional

CHUNK_SPAN = "resident.chunk"
RUN_SPAN = "search.run"  # the checker's span around the engine's run()
#: the steps of one chunk (the engine's CHUNK_STEPS; every chunk span holds
#: that many steps, the no-op ones past a stop included).
CHUNK_STEPS = 16
NAME_CHARS = 160  # a device op's name in the breakdown, cut to its head
MARKER_CYCLES = 200_000  # ~0.1 ms spin kernel at the slice's start, a check on the clocks


class _Span:
    __slots__ = ("tracer", "name", "t0")

    def __init__(self, tracer, name):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self.tracer._close(self.name, self.t0, time.monotonic())
        return False


@dataclass
class Slice:
    """What the profiler saw over the slice."""

    wall_s: float
    steps: int
    chunks: int
    device_ops: int
    busy_s: float
    top_ops: list  # [[name, seconds], ...] the ops that took most device time
    idle_gaps: list  # [[what the host was doing, seconds], ...] longest first
    stall_s: float  # how long the profiler's start and stop held the engine
    #: the engines' run() seconds per step over the window's steps outside
    #: the slice and the profiler's start and stop (None: no such step)
    untraced_step_s: Optional[float] = None

    def idle_pct(self) -> Optional[float]:
        """The device's idle share of the untraced steps: the slice's device
        seconds per step against the untraced seconds per step. Under the
        profiler the host issues each step slower, so the slice's own wall
        time would count the profiler's cost as idle."""
        if not self.busy_s or not self.untraced_step_s:
            return None
        return 100.0 * (1.0 - self.busy_s / self.steps / self.untraced_step_s)


def warm_profiler() -> None:
    """Start and stop the profiler once on this thread (the CUDA profiling
    interface's first start takes seconds), so that the slice's own start
    holds the engine only briefly. A traced run's set-up calls it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()


class SliceTracer:
    """A tracer for the engine (duck-typed to obs.Tracer's `span` and
    `instant`) that profiles one slice of whole chunks."""

    def __init__(self, rule: dict):
        self.rule = rule
        self.window_start = 0.0  # set by the window as it opens
        self.spans: list = []  # (name, t0, t1)
        self._prof = None
        self._armed = rule.get("after_span") is None
        self._t_start = self._t_stop = None
        self._marker_host = None
        self._chunks = 0
        self.stall_s = 0.0
        self.start_s = self.stop_s = 0.0
        self.clock_check_s = None  # the marker's start less its launch, on the spans' clock
        self.error = None
        self.done = False

    # -- the tracer interface ----------------------------------------------

    def span(self, name: str, cat: str = "host", **args):
        return _Span(self, name)

    def instant(self, name: str, cat: str = "host", **args) -> None:
        t = time.monotonic()
        self.spans.append((name, t, t))

    # -- the slice -----------------------------------------------------------

    def _close(self, name: str, t0: float, t1: float) -> None:
        self.spans.append((name, t0, t1))
        if self.done:
            return
        try:
            self._advance(name, t1)
        except Exception as e:  # noqa: BLE001 - a profiler fault must not fail the check
            self.error = f"{type(e).__name__}: {e}"
            self.done = True

    def _advance(self, name: str, t1: float) -> None:
        if name == self.rule.get("after_span"):
            self._armed = True
        if name == RUN_SPAN and self._prof is not None:
            # The check ended inside the slice: the profiler stops on the
            # thread that started it, with the chunks counted so far.
            self._stop()
        if name != CHUNK_SPAN:
            return
        if self._prof is None:
            if self._armed and t1 - self.window_start >= float(self.rule.get("start_after_s", 0)):
                self._start()
            return
        self._chunks += 1
        if self._chunks >= int(self.rule.get("chunks", 8)):
            self._stop()

    def _start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        t0 = time.monotonic()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self._t_start = time.monotonic()
        self.start_s = self._t_start - t0
        self.stall_s += self.start_s
        # The trace's timestamps are on the wall clock; the spans are on the
        # monotonic one.
        self._wall_minus_mono = time.time() - time.monotonic()
        # On an idle card a kernel starts within microseconds of its launch:
        # the marker's timestamp checks the two clocks against each other.
        self._marker_host = time.monotonic()
        torch.cuda._sleep(MARKER_CYCLES)

    def _stop(self) -> None:
        self._t_stop = time.monotonic()
        self.done = True
        self._prof.stop()
        self.stop_s = time.monotonic() - self._t_stop
        self.stall_s += self.stop_s

    def summary(self) -> dict:
        """How the slice went, for the result line."""
        return {"chunks": self._chunks, "steps": self._chunks * CHUNK_STEPS,
                "start_s": self.start_s, "stop_s": self.stop_s,
                "clock_check_s": self.clock_check_s, "error": self.error}

    # -- the reduction ---------------------------------------------------------

    def reduce(self, top: int = 10) -> Optional[Slice]:
        """The device's busy time, its ops by time and its idle gaps by what
        the host was doing, over the slice; None when no slice was taken."""
        if self._prof is None or not self.done or not self._chunks:
            return None
        events = [e for e in self._prof.profiler.kineto_results.events()
                  if "cuda" in str(e.device_type()).lower()]
        offset = -self._wall_minus_mono  # trace clock -> the spans' clock
        marker = [e for e in events if "spin_kernel" in e.name()][:1]
        if marker:
            self.clock_check_s = marker[0].start_ns() / 1e9 + offset - self._marker_host
        ops = [(e.name(), e.start_ns() / 1e9 + offset, e.duration_ns() / 1e9)
               for e in events if not (marker and e is marker[0])]
        ops = [op for op in ops if self._t_start <= op[1] < self._t_stop]
        if not ops:
            return None
        by_name: dict = defaultdict(float)
        for name, _, dur in ops:
            by_name[name[:NAME_CHARS]] += dur
        intervals = _merge([(t, t + d) for _, t, d in ops])
        busy = sum(b - a for a, b in intervals)
        gaps = _gaps(intervals, self._t_start, self._t_stop)
        labelled: dict = defaultdict(float)
        for label, seconds in zip(self._host_doing([(a + b) / 2 for a, b in gaps]),
                                  [b - a for a, b in gaps]):
            labelled[label] += seconds
        # The engines' run() spans, less the time the profiler held (its
        # start, the slice, its stop), over the chunks outside the slice.
        held = (self._t_start - self.start_s, self._t_stop + self.stop_s)
        run_s = sum((b - a) - max(0.0, min(b, held[1]) - max(a, held[0]))
                    for name, a, b in self.spans if name == RUN_SPAN)
        chunks = sum(name == CHUNK_SPAN for name, _, _ in self.spans) - self._chunks
        return Slice(
            wall_s=self._t_stop - self._t_start,
            steps=self._chunks * CHUNK_STEPS,
            chunks=self._chunks,
            device_ops=len(ops),
            busy_s=busy,
            top_ops=sorted(([n, s] for n, s in by_name.items()), key=lambda x: -x[1])[:top],
            idle_gaps=sorted(([n, s] for n, s in labelled.items()), key=lambda x: -x[1])[:top],
            stall_s=self.stall_s,
            untraced_step_s=run_s / (chunks * CHUNK_STEPS) if chunks > 0 else None,
        )

    def _host_doing(self, times: list) -> list:
        """For each host time, the innermost engine span open then (the one
        that opened last)."""
        import numpy as np

        t = np.asarray(times)
        label = np.full(t.shape, "host: outside the engine's spans (service, drain, checker)",
                        dtype=object)
        spans = sorted((s for s in self.spans if s[2] >= self._t_start and s[1] <= self._t_stop),
                       key=lambda s: s[1])
        for name, t0, t1 in spans:
            label[(t >= t0) & (t <= t1)] = f"host: in {name}"
        return list(label)


def _merge(iv: list) -> list:
    out: list = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _gaps(intervals: list, start: float, stop: float) -> list:
    out, t = [], start
    for a, b in intervals:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if stop > t:
        out.append((t, stop))
    return out
