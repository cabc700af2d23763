"""Reconstructed traces through the state graph (ref: src/checker/path.rs).

A `Path` is a sequence `state --action--> state --action--> ...`. The device
checker stores only fingerprints (parent pointers in its visited table), so
paths are rebuilt by re-executing the model and matching digests — the
TLC-style technique the reference cites at src/checker/bfs.rs:380-409.
"""

from __future__ import annotations

from typing import Sequence

from .fingerprint import Fingerprint, fingerprint


class Path:
    """An ordered list of (state, action-or-None) pairs; the last pair's action
    is None (ref: src/checker/path.rs:16)."""

    def __init__(self, pairs: Sequence[tuple]):
        if not pairs:
            raise ValueError("empty path is invalid")
        self._pairs = list(pairs)

    def states(self) -> list:
        return [s for s, _ in self._pairs]

    def actions(self) -> list:
        return [a for _, a in self._pairs if a is not None]

    def last_state(self):
        return self._pairs[-1][0]

    def into_pairs(self) -> list:
        return list(self._pairs)

    def fingerprints(self) -> list[Fingerprint]:
        return [fingerprint(s) for s, _ in self._pairs]

    def encode(self) -> str:
        """URL-safe `fp/fp/...` form (ref: src/checker/path.rs:187-198)."""
        return "/".join(str(fp) for fp in self.fingerprints())

    def __len__(self) -> int:
        return len(self._pairs)

    def __iter__(self):
        return iter(self._pairs)

    def __eq__(self, other) -> bool:
        return isinstance(other, Path) and self._pairs == other._pairs

    def __repr__(self) -> str:
        return f"Path({self._pairs!r})"

    def __str__(self) -> str:
        # Matches the reference's Display impl (ref: src/checker/path.rs:207-221).
        lines = [f"Path[{len(self._pairs) - 1}]:"]
        for _state, action in self._pairs:
            if action is not None:
                lines.append(f"- {action!r}")
        return "\n".join(lines) + "\n"

    def format(self, model) -> str:
        """Human-readable dump: state, then action, alternating."""
        lines = []
        for state, action in self._pairs:
            lines.append(repr(state))
            if action is not None:
                lines.append(f"--> {model.format_action(action)}")
        return "\n".join(lines)
