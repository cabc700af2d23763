"""On-demand (lazy BFS) checker — the engine behind the Explorer
(ref: src/checker/on_demand.rs).

Where the eager checkers race to exhaustion, this one expands states only
when asked: a background worker blocks on a control channel and handles
`CheckFingerprint(fp)` (expand that single known state) and
`RunToCompletion` (switch to ordinary BFS until the space is exhausted)
messages — the same control-flow protocol the reference threads wait on
(ref: src/checker/on_demand.rs:136-177, 406-415). Property evaluation,
eventually-bit bookkeeping, dedup-with-parent-pointers, and boundary/depth
cutoffs are shared with the eager BFS checker so verdicts agree.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from typing import Optional

from ..core.fingerprint import Fingerprint, fingerprint
from ..core.model import Expectation
from ..core.path import Path
from ._search import evaluate_properties, record_terminal_ebits
from .base import Checker


class OnDemandChecker(Checker):
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
        self._generated: dict[Fingerprint, Optional[Fingerprint]] = {}
        self._discoveries: dict[str, Fingerprint] = {}
        # Pending (unexpanded) states by fingerprint, so CheckFingerprint can
        # find its target; insertion order preserves BFS order for
        # RunToCompletion (dicts are ordered).
        self._jobs: dict[Fingerprint, tuple] = {}

        ebits = frozenset(
            i
            for i, p in enumerate(self._properties)
            if p.expectation == Expectation.EVENTUALLY
        )
        for s in init_states:
            fp = fingerprint(s)
            if fp not in self._generated:
                self._generated[fp] = None
                self._jobs[fp] = (s, ebits, 1)

        self._control: queue.Queue = queue.Queue()
        self._ran_to_completion = False
        self._closed = False
        self._panic: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._worker, name="on-demand-checker", daemon=True
        )
        self._thread.start()

    # -- control channel (ref: src/checker/on_demand.rs:406-415) ---------------

    def check_fingerprint(self, fingerprint: Fingerprint) -> None:
        """Ask the worker to expand the pending state with this fingerprint
        (no-op if unknown or already expanded)."""
        self._control.put(("check", fingerprint))

    def run_to_completion(self) -> None:
        self._control.put(("run", None))

    # -- worker ----------------------------------------------------------------

    def _worker(self) -> None:
        try:
            while True:
                msg, arg = self._control.get()
                if msg == "close":
                    return
                if msg == "check":
                    with self._lock:
                        job = self._jobs.pop(arg, None)
                    if job is not None:
                        state, ebits, depth = job
                        self._expand(state, arg, ebits, depth)
                elif msg == "run":
                    self._run_all()
                    self._ran_to_completion = True
                    return
        except BaseException as e:  # noqa: BLE001 — surfaced by join()
            self._panic = e
        finally:
            self._closed = True

    def _run_all(self) -> None:
        """Ordinary BFS over whatever is still pending
        (ref: on_demand.rs RunToCompletion handling)."""
        while True:
            with self._lock:
                if not self._jobs:
                    return
                fp, (state, ebits, depth) = next(iter(self._jobs.items()))
                del self._jobs[fp]
            self._expand(state, fp, ebits, depth)
            if len(self._discoveries) == len(self._properties) and self._properties:
                return
            if self._finish_when.matches(self._properties, set(self._discoveries)):
                return
            if (
                self._target_state_count is not None
                and self._target_state_count <= self._state_count
            ):
                return

    def _expand(self, state, state_fp, ebits, depth) -> None:
        """Evaluate + expand ONE state; successors become pending jobs.
        Mirrors one iteration of the BFS hot loop (src/checker/bfs.rs:196-334)."""
        model = self._model
        if depth > self._max_depth:
            with self._lock:
                self._max_depth = max(self._max_depth, depth)
        if self._target_max_depth is not None and depth >= self._target_max_depth:
            return
        if self._visitor is not None and self._visitor.should_visit():
            # should_visit lets rate-limited visitors (the Explorer's
            # recent-path snapshot) skip the O(depth) path reconstruction
            # entirely between windows.
            self._visitor.visit(model, self._reconstruct_path(state_fp))
        is_awaiting, ebits = evaluate_properties(
            model, self._properties, state, self._discoveries, self._lock,
            state_fp, ebits,
        )
        if not is_awaiting:
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
                if next_fp in self._generated:
                    is_terminal = False
                    continue
                self._generated[next_fp] = state_fp
                self._jobs[next_fp] = (next_state, ebits, depth + 1)
            is_terminal = False
        if is_terminal:
            record_terminal_ebits(
                self._properties, ebits, self._discoveries, self._lock, state_fp
            )

    # -- Checker interface -----------------------------------------------------

    def state_count(self) -> int:
        return self._state_count

    def unique_state_count(self) -> int:
        with self._lock:
            return len(self._generated)

    def max_depth(self) -> int:
        return self._max_depth

    def discoveries(self) -> dict[str, Path]:
        with self._lock:
            items = list(self._discoveries.items())
        return {name: self._reconstruct_path(fp) for name, fp in items}

    def join(self) -> "OnDemandChecker":
        """Joining an on-demand check runs it to completion first (a blocked
        lazy checker would otherwise never finish)."""
        if not self._closed:
            self.run_to_completion()
        self._thread.join()
        if self._panic is not None:
            raise self._panic
        return self

    def is_done(self) -> bool:
        if self._panic is not None or self._ran_to_completion:
            return True
        if self._properties and len(self._discoveries) == len(self._properties):
            return True
        with self._lock:
            return not self._jobs

    def _reconstruct_path(self, fp: Fingerprint) -> Path:
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
