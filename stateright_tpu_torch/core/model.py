"""Property expectations and the host `Model` (ref: src/lib.rs:152-338).

The port's copy of what the device checker and the actor lowering need
from the host model module: how a property's condition relates to
discoveries, the named-predicate record, and the `Model` base that
`actor/model.py::ActorModel` subclasses (the lowering's exact closure walks
a host model breadth-first through `actions` / `next_state`). The host
checkers themselves are not part of the port, so a host model has no
`checker()` here: lower it (tensor/lowering.py) and check that.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Callable, Generic, TypeVar

State = TypeVar("State")
Action = TypeVar("Action")


class Expectation(enum.Enum):
    """How a property's condition relates to discoveries
    (ref: src/lib.rs:319-338)."""

    # Condition must hold on every reachable state; a state where it fails is a
    # counterexample.
    ALWAYS = "always"
    # Condition should hold on some reachable state; finding one is an example.
    SOMETIMES = "sometimes"
    # Condition must hold at some point on every path; a terminal state reached
    # without observing it is a counterexample (acyclic-path liveness).
    EVENTUALLY = "eventually"


@dataclass(frozen=True)
class Property:
    """A named predicate over (model, state) (ref: src/lib.rs:259-338)."""

    expectation: Expectation
    name: str
    condition: Callable[[Any, Any], bool]

    @staticmethod
    def always(name: str, condition: Callable[[Any, Any], bool]) -> "Property":
        return Property(Expectation.ALWAYS, name, condition)

    @staticmethod
    def sometimes(name: str, condition: Callable[[Any, Any], bool]) -> "Property":
        return Property(Expectation.SOMETIMES, name, condition)

    @staticmethod
    def eventually(name: str, condition: Callable[[Any, Any], bool]) -> "Property":
        return Property(Expectation.EVENTUALLY, name, condition)


class Model(Generic[State, Action]):
    """A nondeterministic transition system (ref: src/lib.rs:152-257).

    Subclasses implement `init_states`, `actions`, `next_state`; optionally
    `properties` and `within_boundary`. States must be encodable by
    `core/fingerprint.py::stable_encode` (immutable values: tuples,
    frozensets, frozen dataclasses, ...).
    """

    def init_states(self) -> list:
        """Initial states (ref: src/lib.rs:166)."""
        raise NotImplementedError

    def actions(self, state, actions: list) -> None:
        """Append the actions available in `state` (ref: src/lib.rs:169)."""
        raise NotImplementedError

    def next_state(self, state, action):
        """Apply `action` to `state`; return the successor or None if the action
        is ignored in this state (ref: src/lib.rs:173)."""
        raise NotImplementedError

    def properties(self) -> list[Property]:
        """Named properties to check (ref: src/lib.rs:227)."""
        return []

    def within_boundary(self, state) -> bool:
        """Search boundary: states outside it are not expanded
        (ref: src/lib.rs:245)."""
        return True
