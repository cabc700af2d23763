"""Two-phase commit, transcribed from the TLA+ spec in "Consensus on
Transaction Commit" (Gray & Lamport) — a raw `Model`, no actors
(ref: examples/2pc.rs).

Golden counts: 288 unique states with 3 RMs; 8,832 with 5 (665 with symmetry
reduction) (ref: examples/2pc.rs:149-170).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.model import Model, Property
from ..symmetry import RewritePlan

WORKING, PREPARED, COMMITTED, ABORTED = "working", "prepared", "committed", "aborted"
TM_INIT, TM_COMMITTED, TM_ABORTED = "init", "committed", "aborted"

# Messages: ("prepared", rm) | "commit" | "abort"


@dataclass(frozen=True)
class TwoPhaseState:
    rm_state: tuple  # per-RM state
    tm_state: str
    tm_prepared: tuple  # per-RM bool
    msgs: frozenset

    def representative(self) -> "TwoPhaseState":
        """Canonicalize under RM permutation (ref: examples/2pc.rs:203-223)."""
        plan = RewritePlan.from_values_to_sort(self.rm_state)
        return TwoPhaseState(
            rm_state=plan.reindex(self.rm_state),
            tm_state=self.tm_state,
            tm_prepared=plan.reindex(self.tm_prepared),
            msgs=frozenset(
                ("prepared", plan.inverse[m[1]]) if isinstance(m, tuple) else m
                for m in self.msgs
            ),
        )


@dataclass
class TwoPhaseSys(Model):
    """ref: examples/2pc.rs:59-147"""

    rm_count: int

    def init_states(self):
        return [
            TwoPhaseState(
                rm_state=(WORKING,) * self.rm_count,
                tm_state=TM_INIT,
                tm_prepared=(False,) * self.rm_count,
                msgs=frozenset(),
            )
        ]

    def actions(self, state: TwoPhaseState, actions: list):
        if state.tm_state == TM_INIT and all(state.tm_prepared):
            actions.append("tm_commit")
        if state.tm_state == TM_INIT:
            actions.append("tm_abort")
        for rm in range(self.rm_count):
            if state.tm_state == TM_INIT and ("prepared", rm) in state.msgs:
                actions.append(("tm_rcv_prepared", rm))
            if state.rm_state[rm] == WORKING:
                actions.append(("rm_prepare", rm))
                actions.append(("rm_choose_abort", rm))
            if "commit" in state.msgs:
                actions.append(("rm_rcv_commit", rm))
            if "abort" in state.msgs:
                actions.append(("rm_rcv_abort", rm))

    def next_state(self, state: TwoPhaseState, action):
        rm_state = list(state.rm_state)
        tm_prepared = list(state.tm_prepared)
        tm_state = state.tm_state
        msgs = state.msgs
        if action == "tm_commit":
            tm_state = TM_COMMITTED
            msgs = msgs | {"commit"}
        elif action == "tm_abort":
            tm_state = TM_ABORTED
            msgs = msgs | {"abort"}
        else:
            kind, rm = action
            if kind == "tm_rcv_prepared":
                tm_prepared[rm] = True
            elif kind == "rm_prepare":
                rm_state[rm] = PREPARED
                msgs = msgs | {("prepared", rm)}
            elif kind == "rm_choose_abort":
                rm_state[rm] = ABORTED
            elif kind == "rm_rcv_commit":
                rm_state[rm] = COMMITTED
            elif kind == "rm_rcv_abort":
                rm_state[rm] = ABORTED
        return TwoPhaseState(tuple(rm_state), tm_state, tuple(tm_prepared), msgs)

    def properties(self):
        return [
            Property.sometimes(
                "abort agreement",
                lambda m, s: all(r == ABORTED for r in s.rm_state),
            ),
            Property.sometimes(
                "commit agreement",
                lambda m, s: all(r == COMMITTED for r in s.rm_state),
            ),
            Property.always(
                "consistent",
                lambda m, s: not (
                    ABORTED in s.rm_state and COMMITTED in s.rm_state
                ),
            ),
        ]
