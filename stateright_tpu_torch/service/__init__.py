"""The check service and its fleet (the JAX package's
`stateright_tpu/service/`): a continuous-batching scheduler that runs many
check jobs at once against one shared device table, and a router over N
such replicas, in this process or in replica processes of their own.

A standalone engine (`spawn_cuda`, FrontierSearch, ResidentSearch) owns the
card for one check. The service is the serving layer above: one persistent
`CheckService` packs the frontier lanes of many concurrent jobs into shared
fused steps, admitting, retiring and preempting jobs between steps. Every
key is job-salted (tensor/fingerprint.py `salt_keys`), a bijection per job,
so each job's dedup is a standalone run's and unsalting hands back its
discovery fingerprints unchanged.

Pieces:

- `queue`     — the admission queue and each job's frontier, counters and
                salt;
- `scheduler` — the engine: the shared table, one fused step per model
                group through the CUDA insert, waterfilled round-robin
                lane grants, FrontierSearch's bookkeeping per job;
- `api`       — `CheckService.submit(model, ...) -> JobHandle` (poll,
                result, cancel), preemption, timeouts, the step-fault retry
                and quarantine, and the `Checker` behind
                `model.checker().spawn_service(service)`;
- `server`    — the HTTP front end (`serve_service`);
- `metrics`   — per-job queue wait, steps, lanes held, preemptions, spill
                share;
- `tenancy`   — tenant identity, quotas (`QuotaExceeded`, HTTP 429);
- `lease`     — epoch-fenced checkpoint leases (`LeaseStore`, `Lease`,
                `FencedEvents`);
- `router`    — `FleetRouter`: the consistent-hash ring, health probes,
                requeue and resume, work stealing, rejoin, and the HTTP
                front door `serve_fleet`;
- `fleet`     — `Replica` crash-only runners and `ServiceFleet`, with
                its replicas in this process or (`remote=True`) each in a
                `replica_main` process over one shared store root;
- `remote`    — `RemoteReplica`, the router's HTTP stub of a replica
                process, `serve_replica` and `spawn_replica_proc`;
- `replica_main` — the replica process
                (``python -m stateright_tpu_torch.service.replica_main``);
- `discovery` — member records in the store root (`MemberDirectory`);
- `autoscale` — `Autoscaler`: scale-out and scale-in from the status
                plane's signals.
"""

from .api import CheckService, JobHandle, ServiceChecker
from .autoscale import AutoscaleConfig, Autoscaler
from .discovery import MemberDirectory
from .fleet import Replica, ServiceFleet
from .lease import FencedEvents, Lease, LeaseRevoked, LeaseStore
from .metrics import JobMetrics
from .queue import AdmissionQueue, Job, JobResume, JobStatus
from .router import FleetJobHandle, FleetRouter, HashRing, ResumeToken, serve_fleet
from .scheduler import ServiceEngine, ServiceError, StepFault
from .server import ModelRegistry, default_registry, serve_service, status_view
from .tenancy import DEFAULT_TENANT, QuotaExceeded, TenantQuota, TenantQuotas

__all__ = [
    "AdmissionQueue",
    "AutoscaleConfig",
    "Autoscaler",
    "CheckService",
    "DEFAULT_TENANT",
    "FencedEvents",
    "FleetJobHandle",
    "FleetRouter",
    "HashRing",
    "Job",
    "JobHandle",
    "JobMetrics",
    "JobResume",
    "JobStatus",
    "Lease",
    "LeaseRevoked",
    "LeaseStore",
    "MemberDirectory",
    "ModelRegistry",
    "QuotaExceeded",
    "Replica",
    "ResumeToken",
    "ServiceChecker",
    "ServiceEngine",
    "ServiceError",
    "ServiceFleet",
    "StepFault",
    "TenantQuota",
    "TenantQuotas",
    "default_registry",
    "serve_fleet",
    "serve_service",
    "status_view",
]
