"""The `Model` abstraction: a nondeterministic transition system plus properties.

Mirrors the reference's core trait (ref: src/lib.rs:152-338): implementations
define initial states, the actions available in a state, a (possibly ignored)
transition per action, named properties with always/sometimes/eventually
expectations, and an optional search boundary.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Callable, Generic, Iterable, Optional, TypeVar

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

    # -- display hooks (ref: src/lib.rs:176-196) ------------------------------

    def format_action(self, action) -> str:
        return repr(action)

    def format_step(self, last_state, action) -> Optional[str]:
        """Human-readable outcome of taking `action` in `last_state`, or None if
        the action is ignored."""
        next_state = self.next_state(last_state, action)
        return None if next_state is None else repr(next_state)

    def as_svg(self, path) -> Optional[str]:
        """Optional SVG visualization of a path (sequence diagrams for actor
        models; ref: src/lib.rs:194-196)."""
        return None

    # -- helpers (ref: src/lib.rs:199-224) ------------------------------------

    def next_steps(self, state) -> list:
        """All (action, next_state) pairs from `state`, ignored actions elided."""
        acts: list = []
        self.actions(state, acts)
        steps = []
        for a in acts:
            ns = self.next_state(state, a)
            if ns is not None:
                steps.append((a, ns))
        return steps

    def next_states(self, state) -> list:
        return [ns for _, ns in self.next_steps(state)]

    def property_by_name(self, name: str) -> Property:
        for p in self.properties():
            if p.name == name:
                return p
        raise KeyError(f"no property named {name!r}")

    def checker(self):
        """Begin configuring a checker run (ref: src/lib.rs:250-257)."""
        from ..checker.builder import CheckerBuilder

        return CheckerBuilder(self)


@dataclass
class FnModel(Model):
    """A model from plain functions — the reference implements `Model` for
    `fn(Option<&T>, &mut Vec<T>)` generators (ref: src/test_util.rs:118-137);
    this is the explicit equivalent, handy for tests and quick experiments."""

    init: Callable[[], Iterable]
    step: Callable[[Any], Iterable]  # state -> iterable of successor states
    props: list[Property] = field(default_factory=list)
    boundary: Optional[Callable[[Any], bool]] = None

    def init_states(self) -> list:
        return list(self.init())

    def actions(self, state, actions: list) -> None:
        # The "action" is the index of the chosen successor.
        actions.extend(range(len(list(self.step(state)))))

    def next_state(self, state, action):
        succs = list(self.step(state))
        return succs[action] if action < len(succs) else None

    def properties(self) -> list[Property]:
        return self.props

    def within_boundary(self, state) -> bool:
        return True if self.boundary is None else self.boundary(state)
