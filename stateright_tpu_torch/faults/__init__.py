"""Crash-safe checkpoint generations and the chaos plane (the JAX package's
`stateright_tpu/faults/`, the parts the port's engines, check service and
fleet use): `ckptio` writes and reads one generation of an engine
checkpoint, with the JAX package's CRC footer byte for byte, so a file
written by either package is read by the other, and fences a fleet
replica's generations behind its lease; `blobstore` is the store-root seam
(the local file system, the ``blob://`` emulator store and the managed
``s3://`` / ``gs://`` stores, with `creds` their credential chain and
`blobdialect` their emulators); `plan` is the seeded fault-injection plane
(`FaultPlan`, `maybe_fault`); `supervisor` is the self-healing supervisor
(`run_supervised`: checkpointed slices, bounded retry with backoff, the
degrade ladder, the watchdog, the SIGTERM drain) over the frontier,
resident and sharded engines."""

from .ckptio import (
    LEASE_STAMP_KEYS,
    CheckpointCorrupt,
    LeaseRevoked,
    atomic_savez,
    fenced_load_latest,
    latest_generation,
    fenced_savez,
    lease_stamp,
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
    PreemptionFault,
    ReplicaCrash,
    ShardFault,
    SpillIOError,
    WatchdogTimeout,
    XlaError,
    active,
    active_plan,
    install_plan,
    maybe_fault,
)
from .supervisor import (
    RUNGS,
    Supervisor,
    SupervisorConfig,
    SupervisorGaveUp,
    run_supervised,
)

__all__ = [
    "KINDS",
    "LEASE_STAMP_KEYS",
    "CheckpointCorrupt",
    "LeaseRevoked",
    "DeviceOOM",
    "FaultError",
    "FaultPlan",
    "FaultRule",
    "HttpFault",
    "PoisonFault",
    "PreemptionFault",
    "RUNGS",
    "ReplicaCrash",
    "ShardFault",
    "SpillIOError",
    "Supervisor",
    "SupervisorConfig",
    "SupervisorGaveUp",
    "WatchdogTimeout",
    "XlaError",
    "active",
    "active_plan",
    "atomic_savez",
    "fenced_load_latest",
    "fenced_savez",
    "install_plan",
    "latest_generation",
    "lease_stamp",
    "load_latest",
    "maybe_fault",
    "normalize_ckpt_path",
    "read_verified",
    "run_supervised",
]
