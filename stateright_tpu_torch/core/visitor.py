"""Per-evaluated-state callbacks (ref: src/checker/visitor.rs).

A visitor observes every state the checker evaluates, receiving a full `Path`
ending at that state. `PathRecorder` and `StateRecorder` are the test workhorses
(ref: src/checker/visitor.rs:40-111).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from .path import Path


class CheckerVisitor:
    def should_visit(self) -> bool:
        """Consulted by every checker BEFORE building the (expensive) visit
        Path; rate-limited visitors (e.g. the Explorer's recent-path
        snapshot) override it to skip the O(depth) reconstruction entirely
        between windows."""
        return True

    def visit(self, model, path: Path) -> None:
        raise NotImplementedError


class FnVisitor(CheckerVisitor):
    """Wrap a plain callable `(model, path) -> None`."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def visit(self, model, path: Path) -> None:
        self.fn(model, path)


class PathRecorder(CheckerVisitor):
    """Records every visited path (ref: src/checker/visitor.rs:40-63)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.paths: list[Path] = []

    def visit(self, model, path: Path) -> None:
        with self._lock:
            self.paths.append(path)


class StateRecorder(CheckerVisitor):
    """Records the final state of every visited path
    (ref: src/checker/visitor.rs:75-111)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.states: list = []

    def visit(self, model, path: Path) -> None:
        with self._lock:
            self.states.append(path.last_state())


def as_visitor(v) -> Optional[CheckerVisitor]:
    if v is None or isinstance(v, CheckerVisitor):
        return v
    if callable(v):
        return FnVisitor(v)
    raise TypeError(f"not a visitor: {v!r}")
