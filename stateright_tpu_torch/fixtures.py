"""Tiny deterministic fixture models used across the test suite
(ref: src/test_util.rs).

These are the "fake backends" of the reference's test strategy: cheap models
with exactly known state spaces, giving dense signal on checker semantics. They
are shipped in the package (not buried in tests/) because the Explorer demo and
the tensor-checker parity tests use them too.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from .core.model import Model, Property


class BinaryClock(Model):
    """A machine that cycles between two states (ref: src/test_util.rs:4-47)."""

    GO_LOW = "GoLow"
    GO_HIGH = "GoHigh"

    def init_states(self):
        return [0, 1]

    def actions(self, state, actions):
        actions.append(self.GO_HIGH if state == 0 else self.GO_LOW)

    def next_state(self, state, action):
        return 1 if action == self.GO_HIGH else 0

    def properties(self):
        return [Property.always("in [0, 1]", lambda _, s: 0 <= s <= 1)]


@dataclass
class DGraph(Model):
    """A directed graph specified via paths from initial states; the canonical
    harness for eventually-property semantics tests
    (ref: src/test_util.rs:50-116)."""

    inits: set = field(default_factory=set)
    edges: dict = field(default_factory=dict)  # src -> sorted set of dsts
    property: Property = None

    @staticmethod
    def with_property(prop: Property) -> "DGraph":
        return DGraph(property=prop)

    def with_path(self, path: list) -> "DGraph":
        src = path[0]
        self.inits.add(src)
        for dst in path[1:]:
            self.edges.setdefault(src, set()).add(dst)
            src = dst
        return self

    def init_states(self):
        return sorted(self.inits)

    def actions(self, state, actions):
        actions.extend(sorted(self.edges.get(state, ())))

    def next_state(self, state, action):
        return action

    def properties(self):
        return [self.property]

    def check(self):
        return self.checker().spawn_bfs().join()


class Guess(enum.Enum):
    INCREASE_X = "IncreaseX"
    INCREASE_Y = "IncreaseY"

    def __repr__(self):
        return self.value


@dataclass
class LinearEquation(Model):
    """Finds x, y in u8 with a*x + b*y == c (mod 256) — the canonical checker
    workload: full space is 256*256 = 65,536 states
    (ref: src/test_util.rs:140-192)."""

    a: int
    b: int
    c: int

    def init_states(self):
        return [(0, 0)]

    def actions(self, state, actions):
        actions.append(Guess.INCREASE_X)
        actions.append(Guess.INCREASE_Y)

    def next_state(self, state, action):
        x, y = state
        if action == Guess.INCREASE_X:
            return ((x + 1) % 256, y)
        return (x, (y + 1) % 256)

    def properties(self):
        def solvable(model, solution):
            x, y = solution
            return (model.a * x + model.b * y) % 256 == model.c % 256

        return [Property.sometimes("solvable", solvable)]


class Panicker(Model):
    """Raises mid-check, exercising clean market shutdown on worker panic
    (ref: src/test_util.rs:194-228)."""

    def init_states(self):
        return [0]

    def actions(self, state, actions):
        actions.append(1)

    def next_state(self, state, action):
        if state == 5:
            raise RuntimeError("reached panic state")
        return state + action

    def properties(self):
        return [Property.always("true", lambda _, __: True)]
