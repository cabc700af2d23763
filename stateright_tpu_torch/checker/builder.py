"""Checker configuration builder (ref: src/checker.rs:65-288).

Instantiated via `Model.checker()` or `TensorModel.checker()`; fluent
config, then one of the spawns, each behind the standard `Checker`
interface. A host `Model` runs on the host checkers of the reference
(`spawn_bfs`, `spawn_dfs`, `spawn_on_demand`, `spawn_simulation()`) or
behind the Explorer (`serve`); a `TensorModel` runs the batched device
search (`spawn_cuda()`, or with `mode="simulation"` the device random
walks), or is submitted as a job of a shared check service
(`spawn_service(service)`). `tensor/adapter.py::as_host_model` puts a
tensor model behind the host checkers too.

Memory note: consistency-tester properties (linearizability / sequential
consistency) memoize serialization verdicts in bounded process-global caches
that retain tester histories after a run completes; a long-lived process
checking many unrelated models can call
`semantics.clear_serialization_caches()` between runs to release them.
"""

from __future__ import annotations

import time
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
        (ref: src/checker.rs:222-227). A host-level callable, honored by
        the DFS and simulation checkers; the device checkers refuse it, and
        a tensor model reduces through its `representative` instead."""
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
        `spawn_cuda()`'s search mode; the host checkers ignore it."""
        self.trace_out_ = path
        return self

    @property
    def close_at(self) -> Optional[float]:
        return None if self.timeout_ is None else time.monotonic() + self.timeout_

    # -- the host checkers (ref: src/checker.rs:144-217) -----------------------

    def spawn_bfs(self):
        from .bfs import BfsChecker

        return BfsChecker(self)

    def spawn_dfs(self):
        from .dfs import DfsChecker

        return DfsChecker(self)

    def spawn_on_demand(self):
        from .on_demand import OnDemandChecker

        return OnDemandChecker(self)

    def serve(self, address: str = "localhost:3000", block: bool = False):
        """Start the Explorer web service over an on-demand check
        (ref: src/checker.rs:144-151)."""
        from ..explorer.server import serve

        return serve(self, address, block=block)

    def spawn_cuda(self, mode: str = "search", **kwargs):
        """Spawn a batched device checker. It runs on the CUDA card unless
        `device="cpu"` is passed; with no CUDA device the default raises
        instead of running elsewhere. `mode` picks the engine
        (knobs.CHECKER_MODES): "search" (default) is the exhaustive BFS
        (checker/cuda.py: the resident engine, or with `resident=False` the
        host-driven one); "simulation" is the device random-walk engine,
        as `spawn_simulation(device=True, **kwargs)`. The other options go
        to the engine (batch_size, table_log2, queue_log2, insert_variant,
        table_layout, append, store, high_water, low_water, summary_log2,
        telemetry, telemetry_log2); an unknown one raises here."""
        from ..knobs import CHECKER_MODES

        if mode not in CHECKER_MODES:  # knob universe: knobs.py
            raise ValueError(f"mode must be one of {CHECKER_MODES}, got {mode!r}")
        if mode == "simulation":
            return self.spawn_simulation(device=kwargs.pop("device", True), **kwargs)
        from .cuda import CudaChecker

        if self.trace_out_ is not None:
            kwargs.setdefault("trace_out", self.trace_out_)
        return CudaChecker(self, **kwargs)

    def run_supervised(
        self,
        engine: str = "resident",
        plan=None,
        config=None,
        checkpoint_path: Optional[str] = None,
        **engine_kwargs,
    ):
        """Run this check under the self-healing supervisor
        (stateright_tpu_torch/faults/supervisor.py): checkpointed slices,
        bounded retry with backoff, the degrade ladder and the watchdog,
        with fault injection when a `FaultPlan` is passed (or
        ``SR_TPU_FAULTS=`` is set). Blocking; returns the engine's
        `SearchResult` with the recovery counters in `detail["faults"]`.
        The builder's finish_when and targets map onto the run; the engine
        options (`device` among them: the card unless "cpu") go to every
        engine the run builds. The model must be a TensorModel."""
        from ..faults import run_supervised as _run_supervised
        from ..tensor.model import TensorModel

        if not isinstance(self.model, TensorModel):
            raise TypeError(
                "run_supervised requires a stateright_tpu_torch TensorModel; "
                f"got {type(self.model).__name__}"
            )
        run_kwargs = {"finish_when": self.finish_when_}
        if self.target_state_count_ is not None:
            run_kwargs["target_state_count"] = self.target_state_count_
        if self.target_max_depth_ is not None:
            run_kwargs["target_max_depth"] = self.target_max_depth_
        return _run_supervised(
            self.model,
            engine=engine,
            plan=plan,
            config=config,
            checkpoint_path=checkpoint_path,
            engine_kwargs=engine_kwargs,
            run_kwargs=run_kwargs,
        )

    def spawn_service(self, service, priority: int = 0):
        """Submit this check as a job of a shared `CheckService`
        (stateright_tpu_torch/service/) and return the `Checker` surface
        `spawn_cuda` gives, served from the service's shared table. The
        builder's finish_when, targets and timeout become the job's
        options; visitors and symmetry_fn are refused, as on spawn_cuda's
        device engines."""
        if self.visitor_ is not None:
            raise NotImplementedError("visitors are not supported on service jobs; use spawn_cuda")
        if self.symmetry_fn_ is not None:
            raise NotImplementedError(
                "symmetry_fn is host-level; device symmetry is the "
                "TensorModel.representative kernel (see spawn_cuda)"
            )
        handle = service.submit(
            self.model,
            finish_when=self.finish_when_,
            target_state_count=self.target_state_count_,
            target_max_depth=self.target_max_depth_,
            timeout=self.timeout_,
            priority=priority,
        )
        return handle.as_checker()

    def spawn_simulation(self, seed: int = 0, chooser=None, device=False, **kwargs):
        """Spawn the random-simulation checker (ref: src/checker/simulation.rs).
        `device=False` (the default) runs the host walker over a host
        `Model`, on `chooser` (a `UniformChooser` when None) and the
        builder's thread count. `device=True` runs the device walk engine
        (tensor/simulation.py) over a `TensorModel` on the CUDA card
        (raising without one), and `device="cuda"` or `device="cpu"` on that
        torch device; `kwargs` go to `DeviceSimulation` (traces, max_depth,
        dedup, cycle_log2, ring, table_log2, walks, stale_limit, continuous,
        telemetry). Device options without a device raise TypeError, and a
        chooser with one ValueError."""
        if device is False:
            from .simulation import SimulationChecker, UniformChooser

            if kwargs:
                raise TypeError(
                    f"options {sorted(kwargs)} require the device engine "
                    "(spawn_simulation(device=True, ...))"
                )
            return SimulationChecker(self, seed, chooser or UniformChooser())
        if chooser is not None:
            raise ValueError(
                "chooser is a host-walker hook; the device engine draws from "
                "counter-based threefry streams (tensor/prng.py)"
            )
        from .simulation import DeviceSimulationChecker

        return DeviceSimulationChecker(
            self, seed=seed, device="cuda" if device is True else device, **kwargs)
