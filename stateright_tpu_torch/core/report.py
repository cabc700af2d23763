"""Progress reporting (ref: src/report.rs).

`WriteReporter` prints periodic "Checking. states=... unique=..." lines and a
final summary including discovered property paths; the `Done.` line is
byte-for-byte the JAX package's and the reference's (ref: src/report.rs:65-82).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, TextIO


@dataclass
class ReportData:
    """Snapshot of checker progress (ref: src/report.rs:10-21). `rate` is
    states/sec over the last reporting window, None on the first tick."""

    total_states: int
    unique_states: int
    max_depth: int
    duration: float  # seconds
    done: bool
    rate: Optional[float] = None


class Reporter:
    """Receives progress snapshots (ref: src/report.rs:35-48)."""

    def delay(self) -> float:
        return 1.0  # ref: src/report.rs:46 — 1s default

    def report_checking(self, data: ReportData) -> None:
        raise NotImplementedError

    def report_discoveries(self, model, discoveries: dict) -> None:
        raise NotImplementedError


class WriteReporter(Reporter):
    """Writes progress to a stream (ref: src/report.rs:50-98)."""

    def __init__(self, stream: Optional[TextIO] = None):
        import sys

        self.stream = stream if stream is not None else sys.stdout

    def report_checking(self, data: ReportData) -> None:
        if data.done:
            self.stream.write(
                f"Done. states={data.total_states}, unique={data.unique_states}, "
                f"depth={data.max_depth}, sec={data.duration:.6g}\n"
            )
        else:
            line = (
                f"Checking. states={data.total_states}, "
                f"unique={data.unique_states}, depth={data.max_depth}"
            )
            if data.rate is not None:
                line += f", rate={data.rate:.0f}"
            self.stream.write(line + "\n")
        self.stream.flush()

    def report_discoveries(self, model, discoveries: dict) -> None:
        # ref: src/report.rs:84-97
        for name, (classification, path) in sorted(discoveries.items()):
            self.stream.write(f'Discovered "{name}" {classification} {path}')
            self.stream.write(f"Fingerprint path: {path.encode()}\n")
        self.stream.flush()
