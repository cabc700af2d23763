"""Shared-memory interleaving models: a data-race demo and its lock fix
(ref: examples/increment.rs, examples/increment_lock.rs).

`IncrementSys` exhibits the classic lost-update race (the "fin" invariant is
violated when two threads read the same shared value). With 2 threads the
space is exactly 13 states, 8 under symmetry reduction — the walkthrough the
reference documents at examples/increment.rs:32-105.

`IncrementLockSys` adds a global lock, restoring the invariant and adding a
"mutex" property.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.model import Model, Property

# Thread state is (t, pc): thread-local value and program counter.


@dataclass(frozen=True)
class IncrementState:
    i: int  # shared
    s: tuple  # per-thread (t, pc)

    def representative(self) -> "IncrementState":
        return IncrementState(self.i, tuple(sorted(self.s)))


@dataclass
class IncrementSys(Model):
    """ref: examples/increment.rs:108-202"""

    thread_count: int

    def init_states(self):
        return [IncrementState(0, ((0, 1),) * self.thread_count)]

    def actions(self, state: IncrementState, actions: list):
        for tid in range(self.thread_count):
            pc = state.s[tid][1]
            if pc == 1:
                actions.append(("read", tid))
            elif pc == 2:
                actions.append(("write", tid))

    def next_state(self, state: IncrementState, action):
        kind, tid = action
        s = list(state.s)
        if kind == "read":
            s[tid] = (state.i, 2)
            return IncrementState(state.i, tuple(s))
        t = state.s[tid][0]
        s[tid] = (t, 3)
        return IncrementState(t + 1, tuple(s))

    def properties(self):
        return [
            Property.always(
                "fin",
                lambda m, s: sum(1 for (t, pc) in s.s if pc == 3) == s.i,
            )
        ]


@dataclass(frozen=True)
class IncrementLockState:
    i: int
    lock: bool
    s: tuple

    def representative(self) -> "IncrementLockState":
        return IncrementLockState(self.i, self.lock, tuple(sorted(self.s)))


@dataclass
class IncrementLockSys(Model):
    """ref: examples/increment_lock.rs"""

    thread_count: int

    def init_states(self):
        return [IncrementLockState(0, False, ((0, 0),) * self.thread_count)]

    def actions(self, state: IncrementLockState, actions: list):
        for tid in range(self.thread_count):
            pc = state.s[tid][1]
            if pc == 0 and not state.lock:
                actions.append(("lock", tid))
            elif pc == 1:
                actions.append(("read", tid))
            elif pc == 2:
                actions.append(("write", tid))
            elif pc == 3 and state.lock:
                actions.append(("release", tid))

    def next_state(self, state: IncrementLockState, action):
        kind, tid = action
        s = list(state.s)
        t, pc = s[tid]
        if kind == "lock":
            s[tid] = (t, 1)
            return IncrementLockState(state.i, True, tuple(s))
        if kind == "read":
            s[tid] = (state.i, 2)
            return IncrementLockState(state.i, state.lock, tuple(s))
        if kind == "write":
            s[tid] = (t, 3)
            return IncrementLockState(t + 1, state.lock, tuple(s))
        s[tid] = (t, 4)
        return IncrementLockState(state.i, False, tuple(s))

    def properties(self):
        return [
            Property.always(
                "fin",
                lambda m, s: sum(1 for (t, pc) in s.s if pc >= 3) == s.i,
            ),
            Property.always(
                "mutex",
                lambda m, s: sum(1 for (t, pc) in s.s if 1 <= pc < 4) <= 1,
            ),
        ]
