"""The check service on one replica (the JAX package's
`stateright_tpu/service/`, without its fleet): a continuous-batching
scheduler that runs many check jobs at once against one shared device
table.

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
- `tenancy`   — tenant identity, quotas (`QuotaExceeded`, HTTP 429).

The fleet (router, leases, remote replicas, autoscaler) is ROADMAP A14's
second half.
"""

from .api import CheckService, JobHandle, ServiceChecker
from .metrics import JobMetrics
from .queue import AdmissionQueue, Job, JobResume, JobStatus
from .scheduler import ServiceEngine, ServiceError, StepFault
from .server import ModelRegistry, default_registry, serve_service, status_view
from .tenancy import DEFAULT_TENANT, QuotaExceeded, TenantQuota, TenantQuotas

__all__ = [
    "AdmissionQueue",
    "CheckService",
    "DEFAULT_TENANT",
    "Job",
    "JobHandle",
    "JobMetrics",
    "JobResume",
    "JobStatus",
    "ModelRegistry",
    "QuotaExceeded",
    "ServiceChecker",
    "ServiceEngine",
    "ServiceError",
    "StepFault",
    "TenantQuota",
    "TenantQuotas",
    "default_registry",
    "serve_service",
    "status_view",
]
