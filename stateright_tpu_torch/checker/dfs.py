"""Host depth-first checker (ref: src/checker/dfs.rs).

Uses dramatically less memory than BFS (visited set of fingerprints only; jobs
carry their full fingerprint path instead of relying on parent pointers) at the
cost of longer discovery paths. This is the only checker supporting symmetry
reduction: on insert, the fingerprint of the *representative* is recorded, but
the search continues from the original state/fingerprint so the collected path
remains extendable — the subtle bug-fix the reference documents at
src/checker/dfs.rs:315-318.
"""

from __future__ import annotations

import threading
from collections import deque

from ..core.fingerprint import Fingerprint, fingerprint
from ..core.model import Expectation
from ..core.path import Path
from itertools import islice

from ._search import (
    WorkerLoopMixin,
    evaluate_properties,
    plane_activity,
    prefetch_block_verdicts,
    state_carries_tester,
    record_terminal_ebits,
)
from .base import Checker
from .job_market import JobBroker


class DfsChecker(WorkerLoopMixin, Checker):
    BLOCK_SIZE = 1500  # ref: src/checker/dfs.rs:133

    def __init__(self, options):
        super().__init__(options.model)
        model = options.model
        self._lock = threading.Lock()
        self._properties = model.properties()
        self._symmetry = options.symmetry_fn_
        self._visitor = options.visitor_
        self._finish_when = options.finish_when_
        self._target_state_count = options.target_state_count_
        self._target_max_depth = options.target_max_depth_

        init_states = [s for s in model.init_states() if model.within_boundary(s)]
        self._state_count = len(init_states)
        self._max_depth = 0
        self._generated: set[Fingerprint] = set()
        for s in init_states:
            if self._symmetry is not None:
                self._generated.add(fingerprint(self._symmetry(s)))
            else:
                self._generated.add(fingerprint(s))
        # name -> full fingerprint path (ref: src/checker/dfs.rs:29)
        self._discoveries: dict[str, list[Fingerprint]] = {}

        ebits = frozenset(
            i
            for i, p in enumerate(self._properties)
            if p.expectation == Expectation.EVENTUALLY
        )
        pending = deque()
        for s in init_states:
            pending.append((s, [fingerprint(s)], ebits, 1))

        self._broker: JobBroker = JobBroker.new(options.thread_count_, options.close_at)
        self._broker.push(pending)
        self._threads = []
        for t in range(options.thread_count_):
            th = threading.Thread(target=self._worker, name=f"checker-{t}", daemon=True)
            th.start()
            self._threads.append(th)

    def _check_block(self, pending: deque, max_count: int) -> None:
        """The hot loop (ref: src/checker/dfs.rs:182-358)."""
        model = self._model
        properties = self._properties
        symmetry = self._symmetry
        # Chunk-boundary verdict prefetch (dedup-first semantics),
        # feedback-gated exactly like bfs.py: a block whose property loop
        # never consults the plane disables further prefetching.
        probe_mark = None
        if getattr(self, "_plane_prefetch", True) and pending:
            if not state_carries_tester(pending[-1][0]):
                # Tester-less model: prefetching can never pay off — disable
                # before ever materializing a block copy.
                self._plane_prefetch = False
            else:
                prefetched = prefetch_block_verdicts(
                    list(islice(reversed(pending), max_count))
                )
                if prefetched:
                    probe_mark = plane_activity()
        while max_count > 0 and pending:
            max_count -= 1
            state, fingerprints, ebits, depth = pending.pop()

            if depth > self._max_depth:
                with self._lock:
                    self._max_depth = max(self._max_depth, depth)
            if self._target_max_depth is not None and depth >= self._target_max_depth:
                continue

            if self._visitor is not None and self._visitor.should_visit():
                self._visitor.visit(
                    model, Path.from_fingerprints(model, fingerprints)
                )

            is_awaiting_discoveries, ebits = evaluate_properties(
                model,
                properties,
                state,
                self._discoveries,
                self._lock,
                list(fingerprints),
                ebits,
            )
            if not is_awaiting_discoveries:
                return

            is_terminal = True
            actions: list = []
            model.actions(state, actions)
            for action in actions:
                next_state = model.next_state(state, action)
                if next_state is None:
                    continue
                if not model.within_boundary(next_state):
                    continue
                with self._lock:
                    self._state_count += 1
                if symmetry is not None:
                    # Dedup on the canonical member, continue with the original
                    # (ref: src/checker/dfs.rs:309-318).
                    rep_fp = fingerprint(symmetry(next_state))
                    with self._lock:
                        if rep_fp in self._generated:
                            is_terminal = False
                            continue
                        self._generated.add(rep_fp)
                    next_fp = fingerprint(next_state)
                else:
                    next_fp = fingerprint(next_state)
                    with self._lock:
                        if next_fp in self._generated:
                            is_terminal = False
                            continue
                        self._generated.add(next_fp)
                is_terminal = False
                pending.append(
                    (next_state, fingerprints + [next_fp], ebits, depth + 1)
                )
            if is_terminal:
                record_terminal_ebits(
                    properties, ebits, self._discoveries, self._lock, list(fingerprints)
                )
        if probe_mark is not None and plane_activity() == probe_mark:
            self._plane_prefetch = False  # block went unconsumed: stop

    # -- Checker interface -----------------------------------------------------

    def state_count(self) -> int:
        return self._state_count

    def unique_state_count(self) -> int:
        return len(self._generated)

    def max_depth(self) -> int:
        return self._max_depth

    def discoveries(self) -> dict[str, Path]:
        with self._lock:
            items = list(self._discoveries.items())
        return {
            name: Path.from_fingerprints(self._model, fps) for name, fps in items
        }

    def join(self) -> "DfsChecker":
        for th in self._threads:
            th.join()
        if self._broker.market.panic is not None:
            raise self._broker.market.panic
        return self

    def is_done(self) -> bool:
        return (
            self._broker.is_closed()
            or len(self._discoveries) == len(self._properties)
            or all(not th.is_alive() for th in self._threads)
        )
