"""The `Checker` interface: a handle to a (possibly still running) check
(ref: src/checker.rs:294-578).
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

from ..core.fingerprint import Fingerprint
from ..core.model import Expectation
from ..core.path import Path
from ..core.report import ReportData, Reporter


class DiscoveryClassification:
    EXAMPLE = "example"
    COUNTEREXAMPLE = "counterexample"


class Checker:
    """Base for all checker runtimes. Subclasses implement the counters,
    `discoveries`, `join`, and `is_done`."""

    def __init__(self, model):
        self._model = model

    # -- core surface ----------------------------------------------------------

    @property
    def model(self):
        return self._model

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

    # -- on-demand hooks (ref: src/checker.rs:299-306) -------------------------

    def check_fingerprint(self, fingerprint: Fingerprint) -> None:
        pass

    def run_to_completion(self) -> None:
        pass

    # -- state-store introspection ---------------------------------------------

    def store_stats(self) -> Optional[dict]:
        """Per-tier occupancy counters of the checker's state store (the
        device engines' tiered store reports hot_fill / spilled_states /
        spill_events here); None for single-tier checkers."""
        return None

    def table_fill(self) -> Optional[float]:
        """Visited-table fill fraction (0..1) when the checker can report
        it cheaply; None otherwise. Feeds the WriteReporter `fill=` field
        and `/metrics`."""
        return None

    def drift_ratio(self) -> Optional[float]:
        """Measured/predicted step-cost ratio from the calibration
        comparator (obs/calib.py) when the checker runs one; None
        otherwise. Feeds the WriteReporter `drift=` field."""
        return None

    # -- conveniences ----------------------------------------------------------

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
            # rate: states/sec over the last reporting window (telemetry
            # satellite) — the live-progress twin of the bench's
            # states_per_sec, without waiting for the Done line. The first
            # tick has no window yet (the search started before this loop),
            # so it reports no rate rather than a microsecond-window blowup.
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
                    fill=self.table_fill(),
                    drift=self.drift_ratio(),
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

    def join_and_report(self, reporter: Reporter) -> "Checker":
        """Like `report` but joins concurrently for an accurate finish time
        (ref: src/checker.rs:351-409). With Python's GIL the polling loop in
        `report` already behaves this way, so this is an alias."""
        return self.report(reporter)

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

    def assert_discovery(self, name: str, actions: Sequence) -> None:
        """Panics unless `actions` also constitutes a valid discovery for the
        property, validated by re-execution (ref: src/checker.rs:521-577)."""
        additional_info: list[str] = []
        found = self.assert_any_discovery(name)
        model = self._model
        prop = model.property_by_name(name)
        for init_state in model.init_states():
            path = Path.from_actions(model, init_state, actions)
            if path is None:
                continue
            if prop.expectation == Expectation.ALWAYS:
                if not prop.condition(model, path.last_state()):
                    return
            elif prop.expectation == Expectation.EVENTUALLY:
                states = path.states()
                liveness_satisfied = any(
                    prop.condition(model, s) for s in states
                )
                last_actions: list = []
                model.actions(states[-1], last_actions)
                path_terminal = not last_actions
                if not liveness_satisfied and path_terminal:
                    return
                if liveness_satisfied:
                    additional_info.append(
                        "incorrect counterexample satisfies eventually property"
                    )
                if not path_terminal:
                    additional_info.append("incorrect counterexample is nonterminal")
            else:  # SOMETIMES
                if prop.condition(model, path.last_state()):
                    return
        extra = f" ({'; '.join(additional_info)})" if additional_info else ""
        raise AssertionError(
            f'Invalid discovery for "{name}"{extra}, but a valid one was found. '
            f"found={found.actions()!r}"
        )
