"""Crash-safe checkpoint files (the JAX package's `stateright_tpu/faults/`,
the part the resident engine's checkpoint needs): `ckptio` writes and reads
one generation of an engine checkpoint on the local file system, with the
JAX package's CRC footer byte for byte, so a file written by either package
is read by the other."""

from .ckptio import (
    CheckpointCorrupt,
    atomic_savez,
    load_latest,
    normalize_ckpt_path,
    read_verified,
)

__all__ = [
    "CheckpointCorrupt",
    "atomic_savez",
    "load_latest",
    "normalize_ckpt_path",
    "read_verified",
]
