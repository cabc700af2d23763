"""The `Checker` interface: a handle to a (possibly still running) check
(ref: src/checker.rs:294-578).
"""

from __future__ import annotations

import time
from typing import Optional

from ..core.model import Expectation
from ..core.path import Path
from ..core.report import ReportData, Reporter


class DiscoveryClassification:
    EXAMPLE = "example"
    COUNTEREXAMPLE = "counterexample"


class Checker:
    """Base for checker runtimes. Subclasses implement the counters,
    `discoveries`, `join`, and `is_done`."""

    def __init__(self, model):
        self._model = model

    def state_count(self) -> int:
        """Total states generated including repeats (ref: src/checker.rs:308)."""
        raise NotImplementedError

    def unique_state_count(self) -> int:
        """Unique states generated (ref: src/checker.rs:312)."""
        raise NotImplementedError

    def max_depth(self) -> int:
        """Deepest depth explored (ref: src/checker.rs:317)."""
        raise NotImplementedError

    def discoveries(self) -> dict[str, Path]:
        """Map from property name to discovery path (ref: src/checker.rs:321)."""
        raise NotImplementedError

    def join(self) -> "Checker":
        """Block until checking completes (ref: src/checker.rs:327-335)."""
        raise NotImplementedError

    def is_done(self) -> bool:
        """All properties have discoveries or all reachable states visited
        (ref: src/checker.rs:342)."""
        raise NotImplementedError

    def discovery(self, name: str) -> Optional[Path]:
        return self.discoveries().get(name)

    def discovery_classification(self, name: str) -> str:
        """"example" vs "counterexample" (ref: src/checker.rs:455-464)."""
        prop = self._model.property_by_name(name)
        if prop.expectation in (Expectation.ALWAYS, Expectation.EVENTUALLY):
            return DiscoveryClassification.COUNTEREXAMPLE
        return DiscoveryClassification.EXAMPLE

    def report(self, reporter: Reporter) -> "Checker":
        """Periodically emit status until done, then a final line plus the
        discovery summary (ref: src/checker.rs:412-452)."""
        start = time.monotonic()
        prev: Optional[tuple] = None  # (states, t) of the previous tick
        while not self.is_done():
            now = time.monotonic()
            states = self.state_count()
            rate = (
                (states - prev[0]) / max(now - prev[1], 1e-9)
                if prev is not None
                else None
            )
            prev = (states, now)
            reporter.report_checking(
                ReportData(
                    total_states=states,
                    unique_states=self.unique_state_count(),
                    max_depth=self.max_depth(),
                    duration=now - start,
                    done=False,
                    rate=rate,
                )
            )
            time.sleep(reporter.delay())
        self.join()
        reporter.report_checking(
            ReportData(
                total_states=self.state_count(),
                unique_states=self.unique_state_count(),
                max_depth=self.max_depth(),
                duration=time.monotonic() - start,
                done=True,
            )
        )
        discoveries = {
            name: (self.discovery_classification(name), path)
            for name, path in self.discoveries().items()
        }
        reporter.report_discoveries(self._model, discoveries)
        return self

    # -- assertion helpers (test oracle API; ref: src/checker.rs:468-577) ------

    def assert_properties(self) -> None:
        for p in self._model.properties():
            if p.expectation == Expectation.SOMETIMES:
                self.assert_any_discovery(p.name)
            else:
                self.assert_no_discovery(p.name)

    def assert_any_discovery(self, name: str) -> Path:
        found = self.discovery(name)
        if found is not None:
            return found
        if not self.is_done():
            raise AssertionError(
                f'Discovery for "{name}" not found, but model checking is incomplete.'
            )
        raise AssertionError(f'Discovery for "{name}" not found.')

    def assert_no_discovery(self, name: str) -> None:
        found = self.discovery(name)
        if found is not None:
            raise AssertionError(
                f'Unexpected "{name}" {self.discovery_classification(name)} '
                f"{found.format(self._model)}\nLast state: {found.last_state()!r}"
            )
        if not self.is_done():
            raise AssertionError(
                f'Discovery for "{name}" not found, but model checking is incomplete.'
            )
