"""Host breadth-first checker (ref: src/checker/bfs.rs).

Finds the shortest path to each discovery when single-threaded. Dedup is a
shared `{fingerprint: parent_fingerprint}` map whose parent pointers drive path
reconstruction (the TLC fingerprint-stack technique, ref: src/checker/bfs.rs:380-409).

This is the correctness oracle and API twin of the device checker
(`checker/cuda.py`); the semantics here — property evaluation on each
unique state, eventually-bits lifecycle, boundary/depth/target cutoffs, including
the reference's documented DAG-join/cycle false negatives for `eventually`
(ref: src/checker.rs:580-587) — are the contract both must satisfy.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional

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


class BfsChecker(WorkerLoopMixin, Checker):
    BLOCK_SIZE = 1500  # states per block before re-sync (ref: src/checker/bfs.rs:130)

    def __init__(self, options):
        super().__init__(options.model)
        model = options.model
        self._lock = threading.Lock()
        self._properties = model.properties()
        self._visitor = options.visitor_
        self._finish_when = options.finish_when_
        self._target_state_count = options.target_state_count_
        self._target_max_depth = options.target_max_depth_

        init_states = [s for s in model.init_states() if model.within_boundary(s)]
        self._state_count = len(init_states)
        self._max_depth = 0
        # fp -> parent fp (None for init states); doubles as the visited set
        # (ref: src/checker/bfs.rs:29-30, 56-62).
        self._generated: dict[Fingerprint, Optional[Fingerprint]] = {}
        self._discoveries: dict[str, Fingerprint] = {}

        ebits = frozenset(
            i
            for i, p in enumerate(self._properties)
            if p.expectation == Expectation.EVENTUALLY
        )
        pending = deque()
        for s in init_states:
            fp = fingerprint(s)
            self._generated[fp] = None
            pending.append((s, fp, ebits, 1))

        self._broker: JobBroker = JobBroker.new(options.thread_count_, options.close_at)
        self._broker.push(pending)
        self._threads = []
        for t in range(options.thread_count_):
            th = threading.Thread(target=self._worker, name=f"checker-{t}", daemon=True)
            th.start()
            self._threads.append(th)

    def _check_block(self, pending: deque, max_count: int) -> None:
        """The hot loop (ref: src/checker/bfs.rs:177-335). Each popped state:
        depth bookkeeping, visitor, property evaluation, expansion with dedup."""
        model = self._model
        properties = self._properties
        # Chunk-boundary verdict prefetch (dedup-first semantics): resolve
        # the block's consistency-tester verdicts in one batched call before
        # the serial per-state loop below probes them. Feedback-gated: once
        # a prefetched block's property loop consults the plane zero times
        # (the consistency property has its discovery, or no property reads
        # the testers), prefetching stops — speculative searches the
        # pre-plane checker never ran must not outlive their consumer.
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
            state, state_fp, ebits, depth = pending.pop()

            if depth > self._max_depth:
                with self._lock:
                    self._max_depth = max(self._max_depth, depth)
            if self._target_max_depth is not None and depth >= self._target_max_depth:
                continue

            if self._visitor is not None and self._visitor.should_visit():
                self._visitor.visit(model, self._reconstruct_path(state_fp))

            is_awaiting_discoveries, ebits = evaluate_properties(
                model, properties, state, self._discoveries, self._lock, state_fp, ebits
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
                next_fp = fingerprint(next_state)
                with self._lock:
                    if next_fp in self._generated:
                        # Revisit: may be a cycle or a DAG join. Like the
                        # reference, treat as non-terminal and do not merge
                        # ebits — the documented eventually-property false
                        # negative (ref: src/checker/bfs.rs:293-315).
                        is_terminal = False
                        continue
                    self._generated[next_fp] = state_fp
                is_terminal = False
                pending.appendleft((next_state, next_fp, ebits, depth + 1))
            if is_terminal:
                record_terminal_ebits(
                    properties, ebits, self._discoveries, self._lock, state_fp
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
        return {name: self._reconstruct_path(fp) for name, fp in items}

    def join(self) -> "BfsChecker":
        for th in self._threads:
            th.join()
        if self._broker.market.panic is not None:
            raise self._broker.market.panic
        return self

    def is_done(self) -> bool:
        return self._broker.is_closed() or len(self._discoveries) == len(
            self._properties
        ) or all(not th.is_alive() for th in self._threads)

    def _reconstruct_path(self, fp: Fingerprint) -> Path:
        """Walk parent pointers to the init state, then re-execute
        (ref: src/checker/bfs.rs:380-409)."""
        fingerprints: deque = deque()
        next_fp: Optional[Fingerprint] = fp
        while next_fp is not None:
            with self._lock:
                if next_fp not in self._generated:
                    break
                source = self._generated[next_fp]
            fingerprints.appendleft(next_fp)
            next_fp = source
        return Path.from_fingerprints(self._model, list(fingerprints))
