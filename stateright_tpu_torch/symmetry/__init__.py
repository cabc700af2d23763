"""Symmetry reduction (ref: src/checker/{representative,rewrite,rewrite_plan}.rs).

Many actor systems are invariant under permutations of actor identity: checking
one member of each equivalence class ("representative") can shrink the state
space dramatically (the Symmetric-Spin technique the reference cites at
src/checker/representative.rs:7-16; e.g. 2PC with 5 RMs: 8,832 → 665 states).

`RewritePlan.from_values_to_sort` derives the canonicalizing permutation by
sorting values — a double argsort (ref: src/checker/rewrite_plan.rs:81-107),
which is exactly the argsort+gather shape the device canonicalization kernel
uses in `tensor/symmetry.py`.

`rewrite(value, plan)` structurally recurses, remapping every `Id` it finds
(ref: src/checker/rewrite.rs). Scalars pass through; `Timers` contents are
deliberately NOT rewritten, matching the reference's clone-only impl
(ref: src/actor/timers.rs:46-53).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from ..core.fingerprint import stable_encode
from ..actor import Id


class Representative:
    """States implementing `representative()` opt into symmetry reduction via
    `CheckerBuilder.symmetry()` (ref: src/checker/representative.rs:65-68)."""

    def representative(self):
        raise NotImplementedError


class RewritePlan:
    """A permutation of dense-nat `Id`s derived by sorting values
    (ref: src/checker/rewrite_plan.rs)."""

    __slots__ = ("order", "inverse")

    def __init__(self, order: Sequence[int], inverse: Sequence[int]):
        self.order = tuple(order)  # new index -> old index
        self.inverse = tuple(inverse)  # old id -> new id

    @staticmethod
    def from_values_to_sort(values: Sequence) -> "RewritePlan":
        """Plan that sorts `values` (by canonical encoding — any total order
        yields a valid canonical form; ref: src/checker/rewrite_plan.rs:81-107)."""
        order = sorted(range(len(values)), key=lambda i: stable_encode(values[i]))
        inverse = [0] * len(order)
        for new_i, old_i in enumerate(order):
            inverse[old_i] = new_i
        return RewritePlan(order, inverse)

    def reindex(self, seq: Sequence) -> tuple:
        """Permute a vec-like indexed by actor id (ref: rewrite_plan.rs:110-124)."""
        return tuple(seq[i] for i in self.order)

    def rewrite_id(self, id: Id) -> Id:
        # srlint: host-ok host-state symmetry; a step reaches it only by the method name `representative`
        return Id(self.inverse[int(id)])

    def __repr__(self):
        return f"RewritePlan(order={self.order!r})"


def rewrite(value: Any, plan: RewritePlan) -> Any:
    """Structural recursion applying a plan (ref: src/checker/rewrite.rs).

    - `Id` values are remapped; all other scalars pass through unchanged.
    - Containers recurse (tuple/list/set/frozenset/dict).
    - `Envelope`s and frozen dataclasses recurse over fields.
    - Objects may customize via `__rewrite__(plan)` (e.g. `Network`).
    """
    if isinstance(value, Id):
        return plan.rewrite_id(value)
    if value is None or isinstance(value, (bool, int, float, str, bytes)):
        return value
    if hasattr(value, "__rewrite__"):
        return value.__rewrite__(plan)
    if isinstance(value, tuple):
        return tuple(rewrite(v, plan) for v in value)
    if isinstance(value, list):
        return [rewrite(v, plan) for v in value]
    if isinstance(value, frozenset):
        return frozenset(rewrite(v, plan) for v in value)
    if isinstance(value, set):
        return {rewrite(v, plan) for v in value}
    if isinstance(value, dict):
        return {rewrite(k, plan): rewrite(v, plan) for k, v in value.items()}
    if dataclasses.is_dataclass(value):
        return type(value)(
            **{
                f.name: rewrite(getattr(value, f.name), plan)
                for f in dataclasses.fields(value)
            }
        )
    return value  # opaque: pass through (mirrors the reference's no-op impls)
