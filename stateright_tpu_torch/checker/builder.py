"""Checker configuration builder (ref: src/checker.rs:65-288).

Instantiated via `TensorModel.checker()`; fluent config, then `spawn_cuda()`
starts the batched device search (or, with `mode="simulation"`, the device
random walks) behind the standard `Checker` interface.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..core.discovery import HasDiscoveries
from ..core.visitor import as_visitor


class CheckerBuilder:
    def __init__(self, model):
        self.model = model
        self.symmetry_fn_: Optional[Callable] = None
        self.target_state_count_: Optional[int] = None
        self.target_max_depth_: Optional[int] = None
        self.thread_count_: int = 1
        self.visitor_ = None
        self.finish_when_: HasDiscoveries = HasDiscoveries.ALL
        self.timeout_: Optional[float] = None
        self.trace_out_: Optional[str] = None

    def symmetry(self) -> "CheckerBuilder":
        """Symmetry reduction through the state's `representative()`
        (ref: src/checker.rs:222-227). A host-level callable: the device
        checkers refuse it; a tensor model reduces through its
        `representative` instead."""
        return self.symmetry_fn(lambda state: state.representative())

    def symmetry_fn(self, representative: Callable) -> "CheckerBuilder":
        self.symmetry_fn_ = representative
        return self

    def finish_when(self, has_discoveries: HasDiscoveries) -> "CheckerBuilder":
        self.finish_when_ = has_discoveries
        return self

    def target_state_count(self, count: int) -> "CheckerBuilder":
        self.target_state_count_ = count if count > 0 else None
        return self

    def target_max_depth(self, depth: int) -> "CheckerBuilder":
        self.target_max_depth_ = depth if depth > 0 else None
        return self

    def threads(self, thread_count: int) -> "CheckerBuilder":
        self.thread_count_ = max(1, thread_count)
        return self

    def visitor(self, visitor) -> "CheckerBuilder":
        self.visitor_ = as_visitor(visitor)
        return self

    def timeout(self, seconds: float) -> "CheckerBuilder":
        self.timeout_ = seconds
        return self

    def trace_out(self, path: str) -> "CheckerBuilder":
        """Record the spawned search's host phases (chunks of steps, the
        tiered store's service, checkpoints) as Chrome trace-event JSON at
        `path`, viewable in Perfetto (obs/trace.py). Honored by
        `spawn_cuda()`'s search mode."""
        self.trace_out_ = path
        return self

    def spawn_cuda(self, mode: str = "search", **kwargs):
        """Spawn a batched device checker. It runs on the CUDA card unless
        `device="cpu"` is passed; with no CUDA device the default raises
        instead of running elsewhere. `mode` picks the engine
        (knobs.CHECKER_MODES): "search" (default) is the exhaustive BFS
        (checker/cuda.py: the resident engine, or with `resident=False` the
        host-driven one); "simulation" is the device random-walk engine,
        as `spawn_simulation(device=True, **kwargs)`. The other options go
        to the engine (batch_size, table_log2, queue_log2, store,
        high_water, low_water, summary_log2, telemetry, telemetry_log2);
        an unknown one raises here."""
        from ..knobs import CHECKER_MODES

        if mode not in CHECKER_MODES:  # knob universe: knobs.py
            raise ValueError(f"mode must be one of {CHECKER_MODES}, got {mode!r}")
        if mode == "simulation":
            return self.spawn_simulation(device=kwargs.pop("device", True), **kwargs)
        from .cuda import CudaChecker

        if self.trace_out_ is not None:
            kwargs.setdefault("trace_out", self.trace_out_)
        return CudaChecker(self, **kwargs)

    def spawn_simulation(self, seed: int = 0, chooser=None, device=False, **kwargs):
        """Spawn the random-simulation checker (ref: src/checker/simulation.rs).
        `device=True` runs the device walk engine (tensor/simulation.py) on
        the CUDA card (raising without one), and `device="cuda"` or
        `device="cpu"` on that torch device; `kwargs` go to
        `DeviceSimulation` (traces, max_depth, dedup, cycle_log2, ring,
        table_log2, walks, stale_limit, continuous, telemetry).
        `device=False` is the host walker, which this package does not have
        yet (ROADMAP A17): it raises NotImplementedError, and device knobs
        without a device raise TypeError."""
        if device is False:
            if kwargs:
                raise TypeError(
                    f"options {sorted(kwargs)} require the device engine "
                    "(spawn_simulation(device=True, ...))"
                )
            raise NotImplementedError(
                "the host simulation walker is not ported yet (ROADMAP A17); "
                "pass device=True for the device engine"
            )
        if chooser is not None:
            raise ValueError(
                "chooser is a host-walker hook; the device engine draws from "
                "counter-based threefry streams (tensor/prng.py)"
            )
        from .simulation import DeviceSimulationChecker

        return DeviceSimulationChecker(
            self, seed=seed, device="cuda" if device is True else device, **kwargs)
