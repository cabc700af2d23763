"""Crash-safe checkpoint files and the chaos plane (the JAX package's
`stateright_tpu/faults/`, the parts the port's engines and check service
use): `ckptio` writes and reads one generation of an engine checkpoint on
the local file system, with the JAX package's CRC footer byte for byte, so
a file written by either package is read by the other; `plan` is the
seeded fault-injection plane (`FaultPlan`, `maybe_fault`)."""

from .ckptio import (
    CheckpointCorrupt,
    atomic_savez,
    load_latest,
    normalize_ckpt_path,
    read_verified,
)
from .plan import (
    KINDS,
    DeviceOOM,
    FaultError,
    FaultPlan,
    FaultRule,
    HttpFault,
    PoisonFault,
    WatchdogTimeout,
    XlaError,
    active,
    active_plan,
    install_plan,
    maybe_fault,
)

__all__ = [
    "KINDS",
    "CheckpointCorrupt",
    "DeviceOOM",
    "FaultError",
    "FaultPlan",
    "FaultRule",
    "HttpFault",
    "PoisonFault",
    "WatchdogTimeout",
    "XlaError",
    "active",
    "active_plan",
    "atomic_savez",
    "install_plan",
    "load_latest",
    "maybe_fault",
    "normalize_ckpt_path",
    "read_verified",
]
