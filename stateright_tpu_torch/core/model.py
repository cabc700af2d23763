"""Property expectations (ref: src/lib.rs:259-338).

The port's copy of the two names the device checker needs from the host
model module: how a property's condition relates to discoveries, and the
named-predicate record itself.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Callable


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
