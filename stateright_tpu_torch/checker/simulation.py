"""The device random-walk engine behind the standard `Checker` handle (the
JAX package's `checker/simulation.py::DeviceSimulationChecker`):
`spawn_simulation(device=True)` or `spawn_cuda(mode="simulation")`.

The builder's config maps onto the rounds loop (tensor/simulation.py):
`finish_when` stops the rounds once matched, `target_state_count` bounds
the generated states, `target_max_depth` caps the walk depth, and `timeout`
bounds the wall time between rounds. With no properties and no target or
timeout the checker runs exactly one round (the host checker would walk
forever).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..core.path import Path
from .base import Checker


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
