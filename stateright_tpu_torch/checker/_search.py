"""Shared search-loop machinery for the host checkers.

BFS and DFS are semantic twins differing only in queue discipline and dedup
bookkeeping (the reference keeps two near-identical files and defers the lift
until DPOR, ref: src/checker/bfs.rs:17-18); here the worker shutdown protocol
and the property/ebits evaluation — the parts that MUST stay in lockstep — live
in one place.
"""

from __future__ import annotations

from ..core.model import Expectation


def plane_activity() -> int:
    """Monotonic count of THIS thread's dedup-first-plane consultations —
    the feedback signal for the prefetch gate below: if a whole prefetched
    block's serial property loop moves this by nothing, the properties no
    longer consult the plane (the consistency property already has a
    discovery, or never existed) and prefetching would be pure speculative
    search work the pre-plane checker never did. Thread-local on purpose:
    sibling worker threads' consultations must not mask this worker's block
    going unconsumed."""
    from ..semantics.canonical import local_consultations

    return local_consultations()


def state_carries_tester(state) -> bool:
    """Whether a state's `.history` is a consistency tester — the one-time
    peek that decides if block prefetching can ever pay off for this model
    (checked on the next-popped state BEFORE materializing a block copy)."""
    from ..semantics import ConsistencyTester

    return isinstance(getattr(state, "history", None), ConsistencyTester)


def prefetch_block_verdicts(block) -> int:
    """Dedup-first semantics plane (semantics/batch.py): before a worker
    walks a block of states one-by-one, gather the block's consistency
    testers (actor-model states carry one as `.history`) and resolve their
    verdicts in ONE batched call — canonical-class collapse + witness
    guidance + (native) parallel search — so the per-state property lambdas
    hit a warm cache instead of probing (and too often searching) serially
    mid-loop. Pure optimization: property evaluation still decides on its
    own; a model without testers costs one getattr on the first state."""
    if not block:
        return 0
    probe = getattr(block[0][0], "history", None)
    from ..semantics import ConsistencyTester

    if not isinstance(probe, ConsistencyTester):
        return 0
    from ..semantics.batch import prefetch_verdicts

    return prefetch_verdicts(
        h
        for h in (getattr(item[0], "history", None) for item in block)
        if isinstance(h, ConsistencyTester)
    )


class WorkerLoopMixin:
    """The per-thread job loop (ref: src/checker/bfs.rs:103-160 and the
    identical src/checker/dfs.rs:106-164).

    Hosts must provide: _broker, _lock, _properties, _discoveries,
    _finish_when, _target_state_count, _state_count, and _check_block.
    """

    def _worker(self) -> None:
        broker = self._broker
        panic = None
        try:
            from collections import deque

            pending = deque()
            while True:
                if not pending:
                    pending = broker.pop()
                    if not pending:
                        return
                self._check_block(pending, self.BLOCK_SIZE)
                if broker.deadline_passed():
                    return
                with self._lock:
                    discovered = set(self._discoveries)
                if self._finish_when.matches(self._properties, discovered):
                    return
                if (
                    self._target_state_count is not None
                    and self._target_state_count <= self._state_count
                ):
                    return
                if len(pending) > 1:
                    broker.split_and_push(pending)
        except BaseException as e:  # noqa: BLE001 — propagate via join()
            panic = e
        finally:
            # Any exit — early finish or panic — closes the market so peers
            # stop too (the reference does this in JobBroker::drop).
            broker.thread_exited(panic=panic)


def evaluate_properties(model, properties, state, discoveries, lock, token, ebits):
    """Evaluate every undiscovered property on `state`
    (ref: src/checker/bfs.rs:230-280 == dfs.rs:234-281 == simulation.rs:305-352).

    `token` is what a discovery records (BFS: the state's fingerprint; DFS and
    simulation: the full fingerprint path). Returns
    ``(is_awaiting_discoveries, ebits)`` where `ebits` has the indices of
    `eventually` properties observed on this state removed.
    """
    is_awaiting = False
    for i, prop in enumerate(properties):
        if prop.name in discoveries:
            continue
        if prop.expectation == Expectation.ALWAYS:
            if not prop.condition(model, state):
                with lock:
                    discoveries.setdefault(prop.name, token)
            else:
                is_awaiting = True
        elif prop.expectation == Expectation.SOMETIMES:
            if prop.condition(model, state):
                with lock:
                    discoveries.setdefault(prop.name, token)
            else:
                is_awaiting = True
        else:
            # EVENTUALLY discoveries are only identified at terminal states; a
            # satisfying state merely clears the path's pending bit.
            is_awaiting = True
            if prop.condition(model, state):
                ebits = ebits - {i}
    return is_awaiting, ebits


def record_terminal_ebits(properties, ebits, discoveries, lock, token) -> None:
    """At a terminal state, every still-set eventually bit is a counterexample
    (ref: src/checker/bfs.rs:326-333)."""
    for i, prop in enumerate(properties):
        if i in ebits:
            with lock:
                discoveries.setdefault(prop.name, token)
