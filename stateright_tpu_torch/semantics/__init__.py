"""Consistency semantics: reference objects and concurrent-history testers
(ref: src/semantics.rs) — the port's copy of the JAX package's
`semantics/`, whose testers are the histories of the lowered register
models (tensor/lowering.py evaluates their verdicts once per history id).

`SequentialSpec` defines correctness via a reference implementation ("this
system should behave like a register/stack"). A `ConsistencyTester` records a
potentially concurrent history of per-thread invocations/returns and decides
whether it can be serialized under a consistency model — linearizability
(real-time order respected) or sequential consistency (per-thread order only).

Unlike the reference's mutate-in-place specs, specs and testers here are
IMMUTABLE: `invoke` returns `(ret, new_spec)` and tester recorders return new
testers, so they can live inside checker states directly (the tester IS the
`ActorModel` history type, hashed into the state fingerprint — see
actor/register.py for the wiring, and SURVEY.md §2.5 for the
integration pattern).
"""

from __future__ import annotations

from typing import Any, Iterable, Optional, Tuple


class SequentialSpec:
    """A sequential reference object (ref: src/semantics.rs:73-98)."""

    def invoke(self, op) -> Tuple[Any, "SequentialSpec"]:
        """Apply `op`; return (ret, next_spec)."""
        raise NotImplementedError

    def is_valid_step(self, op, ret) -> Optional["SequentialSpec"]:
        """If invoking `op` can return `ret`, the next spec state; else None."""
        actual_ret, next_spec = self.invoke(op)
        return next_spec if actual_ret == ret else None

    def is_valid_history(self, pairs: Iterable[tuple]) -> bool:
        spec: Optional[SequentialSpec] = self
        for op, ret in pairs:
            spec = spec.is_valid_step(op, ret)
            if spec is None:
                return False
        return True


class ConsistencyTester:
    """Records per-thread operation histories
    (ref: src/semantics/consistency_tester.rs:15-43).

    Recorders return a NEW tester; an invalid recording (double in-flight op,
    return without invocation) yields a tester whose histories can never
    serialize."""

    def on_invoke(self, thread_id, op) -> "ConsistencyTester":
        raise NotImplementedError

    def on_return(self, thread_id, ret) -> "ConsistencyTester":
        raise NotImplementedError

    def on_invret(self, thread_id, op, ret) -> "ConsistencyTester":
        return self.on_invoke(thread_id, op).on_return(thread_id, ret)

    def is_consistent(self) -> bool:
        raise NotImplementedError


from .register import (  # noqa: E402
    Register,
    WORegister,
    Write,
    Read,
    WriteOk,
    WriteFail,
    ReadOk,
)
from .vec import VecSpec, Push, Pop, Len, PushOk, PopOk, LenOk  # noqa: E402
from .linearizability import LinearizabilityTester  # noqa: E402
from .sequential_consistency import SequentialConsistencyTester  # noqa: E402


__all__ = [
    "SequentialSpec",
    "ConsistencyTester",
    "Register",
    "WORegister",
    "Write",
    "Read",
    "WriteOk",
    "WriteFail",
    "ReadOk",
    "VecSpec",
    "Push",
    "Pop",
    "Len",
    "PushOk",
    "PopOk",
    "LenOk",
    "LinearizabilityTester",
    "SequentialConsistencyTester",
    "clear_serialization_caches",
    "maintain_caches",
]


def clear_serialization_caches() -> None:
    """Drop the memoized serialization verdicts: the per-identity lru memos
    and the canonical verdict cache, witnesses included (they pin tester
    histories for the process's life otherwise)."""
    from . import canonical, linearizability, sequential_consistency

    linearizability._serialized_cached.cache_clear()
    sequential_consistency._serialized_cached.cache_clear()
    canonical.CACHE.clear()


#: `maintain_caches` trims the canonical plane back under this many entries
#: and clears a legacy lru memo that crossed the same bar. The legacy memos
#: pin whole histories (tester objects are their keys), so a long-lived
#: service replica serving thousands of register jobs would otherwise hold
#: up to the lru maxsize (2^15 testers) of histories in each memo.
MAINTAIN_MAX_ENTRIES = 1 << 14


def maintain_caches(max_entries: Optional[int] = None) -> dict:
    """Bound the verdict caches of a long-lived service: the check service
    calls it whenever a job retires (service/scheduler.py). The canonical
    cache trims its least recently used entries; an oversized legacy lru
    memo is cleared whole (functools.lru_cache cannot shrink in part).
    `max_entries` defaults to MAINTAIN_MAX_ENTRIES, read at the call.
    Returns {trimmed, legacy_cleared}; both are counted through the
    "semantics" REGISTRY source."""
    from . import canonical, linearizability, sequential_consistency

    if max_entries is None:
        max_entries = MAINTAIN_MAX_ENTRIES
    trimmed = 0
    if len(canonical.CACHE) > max_entries:
        trimmed = canonical.CACHE.trim(max_entries)
    legacy_cleared = 0
    for mod in (linearizability, sequential_consistency):
        if mod._serialized_cached.cache_info().currsize > max_entries:
            mod._serialized_cached.cache_clear()
            legacy_cleared += 1
    if legacy_cleared:
        canonical.CACHE._count("legacy_clears", legacy_cleared)
    return {"trimmed": trimmed, "legacy_cleared": legacy_cleared}
