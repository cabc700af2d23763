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
]


def clear_serialization_caches() -> None:
    """Drop the memoized serialization verdicts: the per-identity lru memos
    and the canonical verdict cache, witnesses included (they pin tester
    histories for the process's life otherwise)."""
    from . import canonical, linearizability, sequential_consistency

    linearizability._serialized_cached.cache_clear()
    sequential_consistency._serialized_cached.cache_clear()
    canonical.CACHE.clear()
