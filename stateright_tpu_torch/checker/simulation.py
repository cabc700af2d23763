"""Simulation checkers: repeated random root-to-terminal traversals
(ref: src/checker/simulation.rs).

The host walker (`SimulationChecker`, `spawn_simulation()`) aims for fast
coverage of deep states in models too large to check exhaustively. Each
trace keeps a local visited set for cycle detection; there is no global
dedup, so `unique_state_count` equals `state_count`
(ref: src/checker/simulation.rs:413-417). Its choosers draw from Python's
`random.Random(seed)`, so a seed gives the same walks in every run (the
reference FIXMEs its nonreproducible StdRng, ref:
src/checker/simulation.rs:47,154).

The device random-walk engine behind the same handle
(`DeviceSimulationChecker`): `spawn_simulation(device=True)` or
`spawn_cuda(mode="simulation")`. The builder's config maps onto the rounds
loop (tensor/simulation.py): `finish_when` stops the rounds once matched,
`target_state_count` bounds the generated states, `target_max_depth` caps
the walk depth, and `timeout` bounds the wall time between rounds. With no
properties and no target or timeout the checker runs exactly one round
(the host checker would walk forever).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Optional

from ..core.fingerprint import Fingerprint, fingerprint
from ..core.model import Expectation
from ..core.path import Path
from ._search import evaluate_properties, record_terminal_ebits
from .base import Checker


class Chooser:
    """Chooses transitions during a simulation run; created per thread
    (ref: src/checker/simulation.rs:22-39)."""

    def new_state(self, seed: int):
        raise NotImplementedError

    def choose_initial_state(self, chooser_state, init_states: list) -> int:
        raise NotImplementedError

    def choose_action(self, chooser_state, current_state, actions: list) -> int:
        raise NotImplementedError


class UniformChooser(Chooser):
    """Uniform random choices (ref: src/checker/simulation.rs:41-79)."""

    def new_state(self, seed: int):
        return random.Random(seed)

    def choose_initial_state(self, rng: random.Random, init_states: list) -> int:
        return rng.randrange(len(init_states))

    def choose_action(self, rng: random.Random, current_state, actions: list) -> int:
        return rng.randrange(len(actions))


class SimulationChecker(Checker):
    def __init__(self, options, seed: int, chooser: Chooser):
        super().__init__(options.model)
        model = options.model
        self._lock = threading.Lock()
        self._properties = model.properties()
        self._symmetry = options.symmetry_fn_
        self._visitor = options.visitor_
        self._finish_when = options.finish_when_
        self._target_state_count = options.target_state_count_
        self._target_max_depth = options.target_max_depth_
        self._timeout = options.timeout_
        self._state_count = 0
        self._max_depth = 0
        self._discoveries: dict[str, list[Fingerprint]] = {}
        self._shutdown = False
        self._threads = []
        self._panic = None
        for t in range(options.thread_count_):
            th = threading.Thread(
                target=self._worker,
                args=(seed + t, chooser),
                name=f"checker-{t}",
                daemon=True,
            )
            th.start()
            self._threads.append(th)

    def _worker(self, seed: int, chooser: Chooser) -> None:
        """Per-thread loop: run traces with fresh seeds until a finish condition
        (ref: src/checker/simulation.rs:151-196)."""
        deadline = (
            time.monotonic() + self._timeout if self._timeout is not None else None
        )
        rng = random.Random(seed)
        try:
            while True:
                if self._shutdown:
                    return
                if deadline is not None and time.monotonic() >= deadline:
                    return
                self._check_trace_from_initial(seed, chooser)
                with self._lock:
                    discovered = set(self._discoveries)
                if self._finish_when.matches(self._properties, discovered):
                    return
                if (
                    self._target_state_count is not None
                    and self._target_state_count <= self._state_count
                ):
                    return
                seed = rng.getrandbits(63)
        except BaseException as e:  # noqa: BLE001
            with self._lock:
                if self._panic is None:
                    self._panic = e
        finally:
            self._shutdown = True

    def _check_trace_from_initial(self, seed: int, chooser: Chooser) -> None:
        """One random walk from an initial state to a terminal/loop/boundary
        (ref: src/checker/simulation.rs:213-397)."""
        model = self._model
        properties = self._properties
        chooser_state = chooser.new_state(seed)

        init_states = model.init_states()
        state = init_states[chooser.choose_initial_state(chooser_state, init_states)]

        fingerprint_path: list[Fingerprint] = []
        generated: set[Fingerprint] = set()
        ebits = frozenset(
            i
            for i, p in enumerate(properties)
            if p.expectation == Expectation.EVENTUALLY
        )

        while True:
            if len(fingerprint_path) > self._max_depth:
                with self._lock:
                    self._max_depth = max(self._max_depth, len(fingerprint_path))
            if (
                self._target_max_depth is not None
                and len(fingerprint_path) >= self._target_max_depth
            ):
                # Not known to be terminal: skip the eventually check entirely
                # (the reference `return`s rather than `break`s here,
                # ref: src/checker/simulation.rs:264-274).
                return

            if not model.within_boundary(state):
                break

            fp = fingerprint(state)
            fingerprint_path.append(fp)
            canonical_fp = (
                fingerprint(self._symmetry(state))
                if self._symmetry is not None
                else fp
            )
            if canonical_fp in generated:
                break  # found a loop
            generated.add(canonical_fp)

            with self._lock:
                self._state_count += 1

            if self._visitor is not None and self._visitor.should_visit():
                self._visitor.visit(
                    model, Path.from_fingerprints(model, fingerprint_path)
                )

            is_awaiting_discoveries, ebits = evaluate_properties(
                model,
                properties,
                state,
                self._discoveries,
                self._lock,
                list(fingerprint_path),
                ebits,
            )
            if not is_awaiting_discoveries:
                break

            actions: list = []
            model.actions(state, actions)
            advanced = False
            while actions:
                index = chooser.choose_action(chooser_state, state, actions)
                action = actions[index]
                actions[index] = actions[-1]
                actions.pop()  # swap_remove
                next_state = model.next_state(state, action)
                if next_state is not None:
                    state = next_state
                    advanced = True
                    break
            if not advanced:
                break  # no actions: genuine terminal

        # Check the eventually properties at the end of the walk; the reference
        # reaches this on every break — loop, boundary, or terminal
        # (ref: src/checker/simulation.rs:390-397).
        record_terminal_ebits(
            properties, ebits, self._discoveries, self._lock, list(fingerprint_path)
        )

    # -- Checker interface -----------------------------------------------------

    def state_count(self) -> int:
        return self._state_count

    def unique_state_count(self) -> int:
        return self._state_count  # no global dedup

    def max_depth(self) -> int:
        return self._max_depth

    def discoveries(self) -> dict[str, Path]:
        with self._lock:
            items = list(self._discoveries.items())
        return {
            name: Path.from_fingerprints(self._model, fps)
            for name, fps in items
            if fps
        }

    def join(self) -> "SimulationChecker":
        for th in self._threads:
            th.join()
        if self._panic is not None:
            raise self._panic
        return self

    def is_done(self) -> bool:
        return all(not th.is_alive() for th in self._threads)


class DeviceSimulationChecker(Checker):
    def __init__(self, options, seed: int = 0, **kwargs):
        """The engine is built here, on the caller's thread, so a bad
        option or a missing CUDA device raises from the spawn."""
        from ..tensor.model import TensorModel
        from ..tensor.simulation import DeviceSimulation

        model = options.model
        if not isinstance(model, TensorModel):
            raise TypeError(
                "spawn_simulation(device=True) requires a stateright_tpu_torch "
                f"TensorModel; got {type(model).__name__}"
            )
        if options.visitor_ is not None:
            raise NotImplementedError(
                "visitors are not supported on the device simulation engine; "
                "use spawn_cuda()"
            )
        if options.symmetry_fn_ is not None:
            raise NotImplementedError(
                "the builder's symmetry_fn is a host-level callable; device "
                "symmetry reduction is the TensorModel.representative "
                "canonicalization (see spawn_cuda)"
            )
        super().__init__(model)
        if options.target_max_depth_ is not None:
            kwargs.setdefault("max_depth", options.target_max_depth_)
        self._sim = DeviceSimulation(model, seed=seed, **kwargs)
        self._options = options
        self._result = None
        self._discovery_paths = None
        self._panic: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        options = self._options
        finish = options.finish_when_
        target = options.target_state_count_
        deadline = (time.monotonic() + options.timeout_
                    if options.timeout_ is not None else None)
        props = self._sim.props
        try:
            while True:
                r = self._sim.run(finish_when=finish)
                self._result = r
                if finish.matches(props, set(r.discoveries)):
                    return
                if target is not None and r.state_count >= target:
                    return
                if deadline is not None and time.monotonic() >= deadline:
                    return
                if not props and target is None and deadline is None:
                    return  # nothing to converge on: one round
        except BaseException as e:  # noqa: BLE001 — surfaced by join()
            self._panic = e

    # -- Checker interface -----------------------------------------------------

    def state_count(self) -> int:
        r = self._result
        return r.state_count if r is not None else 0

    def unique_state_count(self) -> int:
        r = self._result
        return r.unique_state_count if r is not None else 0

    def max_depth(self) -> int:
        r = self._result
        return r.max_depth if r is not None else 0

    def table_fill(self) -> Optional[float]:
        """Shared-table coverage fill (None with dedup="trace", which has
        no shared table)."""
        if self._sim.table is None:
            return None
        return min(self.unique_state_count() / (1 << self._sim.table_log2), 1.0)

    def telemetry_summary(self) -> Optional[dict]:
        """The engine's walk digest (None with telemetry off)."""
        return self._sim.telemetry_summary()

    def discoveries(self) -> dict[str, Path]:
        if self._result is None:
            return {}
        if self._discovery_paths is not None:
            return dict(self._discovery_paths)
        paths = {name: self._sim.discovery_path(name) for name in self._result.discoveries}
        if self.is_done():
            # Only the final set is kept: later rounds may add discoveries.
            self._discovery_paths = paths
        return paths

    def join(self) -> "DeviceSimulationChecker":
        self._thread.join()
        if self._panic is not None:
            raise self._panic
        return self

    def is_done(self) -> bool:
        return not self._thread.is_alive()
