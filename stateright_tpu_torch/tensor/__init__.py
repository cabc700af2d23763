"""The batched device search: tensor models (Paxos among them), symmetry
reduction, fingerprints, the visited-set insert (a CUDA kernel on the card)
and the resident BFS engine."""

from .fingerprint import device_fingerprint, pack_fp, unpack_fp
from .model import TensorModel, TensorProperty
from .paxos import TensorPaxos
from .resident import ResidentSearch

__all__ = [
    "ResidentSearch",
    "TensorModel",
    "TensorPaxos",
    "TensorProperty",
    "device_fingerprint",
    "pack_fp",
    "unpack_fp",
]
