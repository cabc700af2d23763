"""stateright_tpu_torch — the PyTorch/CUDA port of the stateright_tpu model
checker, for NVIDIA Hopper cards.

The port runs the breadth-first device search: a `TensorModel`'s
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
way. It imports torch, never jax, and nothing of the stateright_tpu
package.
"""

from .core.discovery import HasDiscoveries
from .core.model import Expectation
from .core.path import Path
from .core.report import ReportData, Reporter, WriteReporter
from .tensor.model import TensorModel, TensorProperty

__all__ = [
    "Expectation",
    "HasDiscoveries",
    "Path",
    "ReportData",
    "Reporter",
    "TensorModel",
    "TensorProperty",
    "WriteReporter",
]
