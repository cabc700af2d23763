"""stateright_tpu_torch — the PyTorch/CUDA port of the stateright_tpu model
checker, for NVIDIA Hopper cards.

The host checkers of the reference run a plain `Model` on the host
(`Model.checker()`: `spawn_bfs`, `spawn_dfs`, `spawn_on_demand`,
`spawn_simulation()`, and the Explorer web UI through `serve`); they import
no torch. The port runs the breadth-first device search: a `TensorModel`'s
`checker().spawn_cuda()` starts it on the CUDA card (or on the CPU with
`device="cpu"`), with the visited-set insert as a hand-written CUDA kernel
(csrc/visited_insert.cu), in the resident engine or, with
`resident=False`, the host-driven one; `spawn_simulation(device=True)`
runs random walks on the card instead (tensor/simulation.py). Telemetry
and Chrome-trace spans come from obs/. Its models are those of tensor/models.py
(linear equation, two-phase commit, increment, increment-lock, Raft) and
tensor/paxos.py, with symmetry reduction through a model's
`representative`. Any bounded actor system (actor/, with the consistency
testers of semantics/ as its history) lowers to a tensor model through
`tensor.lower_actor_model` or `tensor.refine_check` and is checked the same
way, and `tensor.as_host_model` puts a tensor model behind the host
checkers and the Explorer, its expands on the card. It imports torch, never
jax, and nothing of the stateright_tpu package.
"""

from .core.model import Model, Property, Expectation
from .core.fingerprint import fingerprint, fingerprint_bytes, stable_encode
from .core.path import Path
from .core.visitor import CheckerVisitor, PathRecorder, StateRecorder
from .core.report import Reporter, WriteReporter, ReportData
from .core.discovery import HasDiscoveries
from .checker.builder import CheckerBuilder
from .checker.base import Checker


def __getattr__(name):
    # Lazy: the tensor model and the check service import torch; a
    # host-only user (a plain `Model` on the host checkers) and the lint
    # pass of analysis/ load without it.
    if name in ("TensorModel", "TensorProperty"):
        from .tensor import model

        return getattr(model, name)
    if name in ("CheckService", "JobHandle", "ServiceChecker"):
        from . import service

        return getattr(service, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Model",
    "Property",
    "Expectation",
    "fingerprint",
    "fingerprint_bytes",
    "stable_encode",
    "Path",
    "CheckerVisitor",
    "PathRecorder",
    "StateRecorder",
    "Reporter",
    "WriteReporter",
    "ReportData",
    "HasDiscoveries",
    "CheckerBuilder",
    "Checker",
    "TensorModel",
    "TensorProperty",
]
