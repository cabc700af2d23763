"""Reconstructed traces through the state graph (ref: src/checker/path.rs).

A `Path` is a sequence `state --action--> state --action--> ...`. Checkers store
only fingerprints (BFS parent pointers / DFS fingerprint stacks), so paths are
rebuilt by re-executing the model and matching digests — the TLC-style technique
the reference cites (Yu/Manolios/Lamport) at src/checker/bfs.rs:380-409.
"""

from __future__ import annotations

from typing import Generic, Optional, Sequence, TypeVar

from .fingerprint import Fingerprint, fingerprint

State = TypeVar("State")
Action = TypeVar("Action")


class Path(Generic[State, Action]):
    """An ordered list of (state, action-or-None) pairs; the last pair's action
    is None (ref: src/checker/path.rs:16)."""

    def __init__(self, pairs: Sequence[tuple]):
        if not pairs:
            raise ValueError("empty path is invalid")
        self._pairs = list(pairs)

    # -- construction ----------------------------------------------------------

    @staticmethod
    def from_fingerprints(model, fingerprints: Sequence[Fingerprint]) -> "Path":
        """Rebuild a path by re-executing `model` along a fingerprint trail
        (ref: src/checker/path.rs:20-97). Panics mirror the reference's
        nondeterminism diagnostics."""
        if not fingerprints:
            raise ValueError("empty fingerprint path is invalid")
        fps = list(fingerprints)
        init_fp = fps[0]
        state = None
        for s in model.init_states():
            if fingerprint(s) == init_fp:
                state = s
                break
        if state is None:
            raise RuntimeError(
                "Failed to reconstruct init state given fingerprint path. "
                "This usually implies a nondeterministic model (e.g. init_states "
                f"varying between calls). fingerprint={init_fp}"
            )
        pairs = []
        for next_fp in fps[1:]:
            found = None
            for action, next_state in model.next_steps(state):
                if fingerprint(next_state) == next_fp:
                    found = (action, next_state)
                    break
            if found is None:
                raise RuntimeError(
                    "Failed to reconstruct a step in a fingerprint path. This "
                    "usually implies a nondeterministic model (e.g. actions/"
                    f"next_state varying between calls). fingerprint={next_fp}"
                )
            pairs.append((state, found[0]))
            state = found[1]
        pairs.append((state, None))
        return Path(pairs)

    @staticmethod
    def from_actions(model, init_state, actions: Sequence) -> Optional["Path"]:
        """Rebuild a path from an initial state and a list of actions; None if
        some action is unavailable/ignored (ref: src/checker/path.rs:102-131)."""
        pairs = []
        state = init_state
        for action in actions:
            available: list = []
            model.actions(state, available)
            if not any(_action_eq(a, action) for a in available):
                return None
            next_state = model.next_state(state, action)
            if next_state is None:
                return None
            pairs.append((state, action))
            state = next_state
        pairs.append((state, None))
        return Path(pairs)

    @staticmethod
    def final_state(model, fingerprints: Sequence[Fingerprint]):
        """Just the last state of a fingerprint path, or None
        (ref: src/checker/path.rs:134-165). Used by the Explorer."""
        if not fingerprints:
            return None
        fps = list(fingerprints)
        state = None
        for s in model.init_states():
            if fingerprint(s) == fps[0]:
                state = s
                break
        if state is None:
            return None
        for next_fp in fps[1:]:
            nxt = None
            for next_state in model.next_states(state):
                if fingerprint(next_state) == next_fp:
                    nxt = next_state
                    break
            if nxt is None:
                return None
            state = nxt
        return state

    # -- accessors -------------------------------------------------------------

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

    def name(self) -> str:
        return self.encode()

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


def _action_eq(a, b) -> bool:
    try:
        return bool(a == b)
    except Exception:
        return False
