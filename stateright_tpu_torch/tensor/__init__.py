"""The batched device search: tensor models (Paxos among them), symmetry
reduction, fingerprints, the visited-set insert (a CUDA kernel on the card),
the resident and host-driven BFS engines, the device random simulation, and
the lowering of any bounded actor system to a tensor model
(tensor/lowering.py)."""

from .fingerprint import device_fingerprint, pack_fp, unpack_fp
from .frontier import FrontierSearch
from .lowering import LoweredActorModel, LoweringError, lower_actor_model, refine_check
from .model import TensorModel, TensorProperty
from .paxos import TensorPaxos
from .resident import ResidentSearch
from .simulation import DeviceSimulation

__all__ = [
    "DeviceSimulation",
    "FrontierSearch",
    "LoweredActorModel",
    "LoweringError",
    "ResidentSearch",
    "TensorModel",
    "TensorPaxos",
    "TensorProperty",
    "device_fingerprint",
    "lower_actor_model",
    "pack_fp",
    "refine_check",
    "unpack_fp",
]
