"""Early-finish policies (ref: src/has_discoveries.rs:5-42).

`HasDiscoveries` decides when a checker may stop before exhausting the state
space, given the set of discovered property names so far.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import ClassVar, FrozenSet, Iterable

from .model import Expectation, Property


def _is_failure(prop: Property, discovered: bool) -> bool:
    # A discovery for always/eventually is a counterexample (failure); a missing
    # discovery for sometimes is also a failure, but "failures so far" only
    # counts realized counterexamples (ref: src/has_discoveries.rs:24-33).
    return discovered and prop.expectation in (
        Expectation.ALWAYS,
        Expectation.EVENTUALLY,
    )


@dataclass(frozen=True)
class HasDiscoveries:
    kind: str
    names: FrozenSet[str] = field(default_factory=frozenset)

    # Sentinels, filled in below the class definition.
    ALL: ClassVar["HasDiscoveries"]
    ANY: ClassVar["HasDiscoveries"]
    ANY_FAILURES: ClassVar["HasDiscoveries"]
    ALL_FAILURES: ClassVar["HasDiscoveries"]

    @staticmethod
    def all_of(names: Iterable[str]) -> "HasDiscoveries":
        return HasDiscoveries("all_of", frozenset(names))

    @staticmethod
    def any_of(names: Iterable[str]) -> "HasDiscoveries":
        return HasDiscoveries("any_of", frozenset(names))

    def matches(self, properties: list[Property], discovered_names: set[str]) -> bool:
        """Whether the finish condition is met (ref: src/has_discoveries.rs:13-41)."""
        k = self.kind
        if k == "all":
            return all(p.name in discovered_names for p in properties)
        if k == "any":
            return bool(discovered_names)
        if k == "any_failures":
            return any(
                _is_failure(p, p.name in discovered_names) for p in properties
            )
        if k == "all_failures":
            failures = [
                p
                for p in properties
                if p.expectation in (Expectation.ALWAYS, Expectation.EVENTUALLY)
            ]
            return all(p.name in discovered_names for p in failures)
        if k == "all_of":
            return self.names <= discovered_names
        if k == "any_of":
            return bool(self.names & discovered_names)
        raise ValueError(f"unknown HasDiscoveries kind {k!r}")


HasDiscoveries.ALL = HasDiscoveries("all")
HasDiscoveries.ANY = HasDiscoveries("any")
HasDiscoveries.ANY_FAILURES = HasDiscoveries("any_failures")
HasDiscoveries.ALL_FAILURES = HasDiscoveries("all_failures")
