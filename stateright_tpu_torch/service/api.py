"""The client API of the check service (the JAX package's
`service/api.py`, on one replica).

`CheckService` is the persistent front door: `submit(model, ...)` returns a
`JobHandle` at once, and a scheduler thread packs every admitted job's
frontier lanes into shared fused device steps (continuous batching, see
scheduler.py) until each job finishes, is cancelled or times out. All jobs
share one device table through job-salted fingerprints, so a service
outlives any single check the way an inference server outlives a request.

Scheduling policy:

- admission: jobs wait in a priority queue; at most `max_resident` hold
  lanes at once (None = unlimited: continuous batching is then the
  fairness mechanism itself);
- fairness: each step's lanes are waterfilled over a group's runnable jobs
  in a rotation that advances every step;
- preemption: with `preempt_steps=N`, a job that has had N steps since its
  admission while others wait is parked (its frontier spilled to disk when
  `spill_dir` is set) and queued again behind its priority class; its
  visited set stays in the shared table, so it resumes exactly;
- cancellation (`JobHandle.cancel()`) drops the job's frontier at once; its
  lanes are free at the very next step.

`CheckService(background=False)` runs no thread: tests and scripts drive it
deterministically with `pump()` / `drain()`.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Optional

import torch

from ..checker.base import Checker
from ..core.discovery import HasDiscoveries
from ..faults.ckptio import CheckpointCorrupt
from ..faults.plan import active_plan
from ..obs import (
    REGISTRY,
    TERMINAL_EVENT_BY_STATUS,
    EventJournal,
    LogHistogram,
    Tracer,
    as_events,
    as_tracer,
    mint_trace_id,
)
from .queue import AdmissionQueue, Job, JobResume, JobStatus
from .scheduler import ServiceEngine, ServiceError, StepFault
from .tenancy import DEFAULT_TENANT, QuotaExceeded, TenantQuotas


class JobHandle:
    """Client-side handle to a submitted job (the service's counterpart of
    the `Checker` a spawn returns)."""

    def __init__(self, service: "CheckService", job: Job):
        self._service = service
        self._job = job

    @property
    def id(self) -> int:
        return self._job.id

    def status(self) -> str:
        return self._job.status

    def poll(self) -> dict:
        return self._service.poll(self._job.id)

    def result(self, wait: bool = True, timeout: Optional[float] = None):
        """The job's SearchResult. Raises on a cancelled or failed job; with
        wait=False returns None while the job is in flight."""
        return self._service.result(self._job.id, wait=wait, timeout=timeout)

    def cancel(self) -> bool:
        return self._service.cancel(self._job.id)

    def discoveries(self) -> dict:
        """{property name: Path}, reconstructed through the shared table's
        salted parent chain (scheduler.reconstruct_path)."""
        return self._service.discovery_paths(self._job.id)

    def metrics(self) -> dict:
        return self._job.metrics.to_dict(self._job.unique_count)

    def as_checker(self) -> "ServiceChecker":
        return ServiceChecker(self)


class CheckService:
    def __init__(
        self,
        batch_size: int = 1024,
        table_log2: int = 20,
        insert_variant: str = "pallas",
        store: str = "device",
        high_water: float = 0.85,
        low_water: Optional[float] = None,
        summary_log2: int = 20,
        max_resident: Optional[int] = None,
        preempt_steps: Optional[int] = None,
        spill_dir: Optional[str] = None,
        background: bool = True,
        telemetry: bool = True,
        telemetry_log2: int = 12,
        trace_out: Optional[str] = None,
        retry_limit: int = 2,
        events=None,
        events_out: Optional[str] = None,
        corpus_dir: Optional[str] = None,
        quotas: Optional[TenantQuotas] = None,
        quota_gate: bool = True,
        device="cuda",
    ):
        """The shared table lives on `device`: the CUDA card unless
        `device="cpu"` is passed; with no CUDA device the default raises.
        `insert_variant` is the shared table's insert (knobs.INSERT_VARIANTS,
        split layout): "pallas", the CUDA kernel on the card, by default,
        or one of the JAX package's XLA designs (on the tiered store with
        `high_water` 0.5 or less: store/tiered.py).

        `telemetry=True` records one step row per fused step (obs/ring.py;
        `stats()["telemetry"]`, `/.status`, `/metrics`). `trace_out=<path>`
        records the service's life (admission, steps, eviction, preemption,
        finalisation) as Chrome trace-event JSON, saved on `close()`.

        `events` / `events_out=<path>` attach the flight recorder
        (obs/events.py): every job transition and every fused step lands in
        the JSONL journal, keyed by the job's `trace` id, and
        `GET /jobs/<id>/events` tails it. Pass an `EventJournal` to share
        one, or a path to own one.

        `quotas` (tenancy.TenantQuotas) gates submissions of a non-default
        `tenant=` on the tenant's in-flight cap and lane-seconds budget
        (over quota raises QuotaExceeded: HTTP 429), and each step charges
        its lane-seconds to the tenants whose jobs rode in it;
        `quota_gate=False` keeps the charging without the gate.

        `retry_limit` is a group's budget of consecutive step faults: the
        faulted lanes went back to their frontiers, so a retry is exact;
        past the budget each job of the group is probed alone and only the
        jobs whose step fails alone are quarantined.

        `corpus_dir=<path>` turns on the cross-job warm-start corpus
        (store/corpus.py; it needs `store="tiered"`, else ValueError): a job
        that runs to exhaustion publishes its visited set as a
        content-addressed, CRC-checked entry, and a later job with the same
        model definition, lowering and finish policy preloads it and
        replays the result, bit for bit, after re-expanding only its init
        states. An interrupted job publishes a partial entry a successor
        continues from; a one-property edit is served on the "delta" rung
        (store/specdelta.py). Services of a fleet share one directory. A
        corrupt entry or an injected fault only means a cold run."""
        self._trace_out = trace_out
        self._tracer = as_tracer(
            Tracer(annotate=True, out=trace_out) if trace_out else None
        )
        self._events_owned = None
        if events is None and events_out:
            events = self._events_owned = EventJournal(events_out, writer="service")
        self._events = as_events(events)
        self._engine = ServiceEngine(
            batch_size=batch_size, table_log2=table_log2, insert_variant=insert_variant,
            store=store, high_water=high_water, low_water=low_water,
            summary_log2=summary_log2, telemetry=telemetry, telemetry_log2=telemetry_log2,
            tracer=self._tracer if trace_out else None, events=events, quotas=quotas,
            corpus_dir=corpus_dir, device=device,
        )
        self.device = self._engine.device
        # The card the scheduler thread works on: this thread's, unless the
        # device names one.
        self._cuda_index = None
        if self.device.type == "cuda":
            self._cuda_index = (torch.cuda.current_device() if self.device.index is None
                                else self.device.index)
        self.quotas = quotas
        self._quota_gate = bool(quota_gate)
        self._quota_rejected = 0
        # Recent queue waits (seconds), for the p99 admission latency.
        self._queue_waits: deque = deque(maxlen=256)
        # Distributions behind the two signals, as Prometheus histograms.
        self._adm_hist = LogHistogram()
        self._lane_hist = LogHistogram(lo=1.0 / 128, hi=1.0)
        self._metrics_name = REGISTRY.register("service", self.metrics)
        self.max_resident = max_resident
        self.preempt_steps = preempt_steps
        self.spill_dir = spill_dir
        self.retry_limit = retry_limit
        self._adm = AdmissionQueue()
        self._jobs: dict[int, Job] = {}
        # Jobs finished but not yet completed: (job, status, publish payload)
        # whose publish, result, event and wake-up `_drain_finalizers` still
        # owes, off the lock.
        self._finalizing: list = []
        # Partial-publish payloads of cuts (cancel, preemption, shutdown),
        # written off the lock by `_drain_publishes`.
        self._publishing: list = []
        self._next_id = 1
        # Every touch of the table, the staging and the jobs is under this
        # lock: the scheduler's steps and the HTTP threads' polls and path
        # reconstructions alike.
        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        self._idle = threading.Condition(self._lock)
        self._closed = False
        self._failed: Optional[str] = None
        self._thread = None
        if background:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="check-service")
            self._thread.start()

    # -- client surface --------------------------------------------------------

    def submit(
        self,
        model,
        finish_when: HasDiscoveries = HasDiscoveries.ALL,
        target_state_count: Optional[int] = None,
        target_max_depth: Optional[int] = None,
        timeout: Optional[float] = None,
        priority: int = 0,
        journal: bool = False,
        resume=None,
        trace: Optional[str] = None,
        tenant: str = DEFAULT_TENANT,
    ) -> JobHandle:
        """Queue a check job; returns at once. The model must be a
        TensorModel; jobs of the same model instance share a step and its
        batches. `trace` is the flight-recorder correlation id (minted here
        when not given); `tenant` scopes quotas and the two-level waterfill.

        The fleet's requeue plumbing: `journal=True` records the job's
        claimed (key, parent key) pairs on the host so a fleet replica can
        checkpoint it (`Job.fleet_snapshot`); `resume` (a queue.JobResume)
        continues a checkpointed job, its whole visited set re-seeded into
        this service's table under this job's salt.

        With a corpus, the content key (the model's traced definition) and
        the corpus read happen here, on the caller's thread, before the
        service lock is taken: a slow read never stalls another job's
        poll."""
        from ..tensor.model import TensorModel

        if resume is not None and not isinstance(resume, JobResume):
            raise TypeError(f"resume must be a JobResume, got {type(resume).__name__}")
        if not isinstance(model, TensorModel):
            raise TypeError(
                "CheckService.submit requires a stateright_tpu_torch.tensor."
                f"TensorModel; got {type(model).__name__}"
            )
        prefetch: Optional[Job] = None
        if self._engine.has_corpus:
            prefetch = Job(0, model, finish_when=finish_when,
                           target_state_count=target_state_count,
                           target_max_depth=target_max_depth, tenant=tenant)
            try:
                self._engine.prefetch_warm(prefetch)
            except Exception:  # noqa: BLE001 — warm start is an optimisation
                prefetch = None
        with self._work:
            if self._closed:
                # srlint: fault-ok caller-contract guard, not an I/O/device surface
                raise RuntimeError("service is closed")
            if self._failed:
                raise ServiceError(self._failed)
            if self.quotas is not None and self._quota_gate and tenant != DEFAULT_TENANT:
                in_flight = sum(1 for j in self._jobs.values()
                                if j.tenant == tenant and j.status not in JobStatus.FINISHED)
                try:
                    self.quotas.admit(tenant, in_flight)
                except QuotaExceeded:
                    self._quota_rejected += 1
                    self._events.emit("job.quota_rejected", tenant=tenant)
                    raise
            job = Job(
                self._next_id, model, finish_when=finish_when,
                target_state_count=target_state_count, target_max_depth=target_max_depth,
                timeout=timeout, priority=priority,
                # A corpus publishes from the journal: every job keeps one.
                journal=journal or self._engine.has_corpus, resume=resume,
                trace=trace or mint_trace_id(), tenant=tenant,
            )
            if prefetch is not None:
                for attr in ("content_key", "warm_entry", "warm_entry_kind", "warm_checked",
                             "verdict_preloads", "delta_class", "partial_kind",
                             "no_publish"):
                    setattr(job, attr, getattr(prefetch, attr))
            self._next_id += 1
            self._jobs[job.id] = job
            self._adm.push(job)
            self._events.emit("job.submitted", job=job.id, trace=job.trace,
                              resumed=bool(resume) or None)
            self._work.notify_all()
            return JobHandle(self, job)

    def withdraw(self, job_id: int) -> bool:
        """Remove a still-queued job at once: the fleet's work-stealing
        primitive (a queued job has no table state, so moving it is a clean
        cancel here and submit there). Returns False once the job was
        admitted or finished. Journals nothing: the router's `fleet.steal`
        records the move."""
        job = self._get(job_id)
        with self._work:
            if job.status != JobStatus.QUEUED:
                return False
            self._adm.remove(job)
            job.status = JobStatus.CANCELLED
            job.metrics.finished_at = time.monotonic()
            job.event.set()
            self._idle.notify_all()
            return True

    def poll(self, job_id: int) -> dict:
        job = self._get(job_id)
        with self._lock:
            return {
                "id": job.id,
                "status": job.status,
                "trace": job.trace,
                "state_count": job.state_count,
                "unique_state_count": job.unique_count,
                "max_depth": job.max_depth,
                "steps": job.metrics.device_steps,
                "pending_lanes": job.pending_lanes,
                "discoveries": sorted(job.discoveries),
                "error": job.error,
                "quarantined": job.quarantined,
                "metrics": job.metrics.to_dict(job.unique_count),
            }

    def result(self, job_id: int, wait: bool = True, timeout: Optional[float] = None):
        job = self._get(job_id)
        if wait:
            if not job.event.wait(timeout):
                raise TimeoutError(f"job {job_id} still running")
        elif not job.event.is_set():
            return None
        if job.status == JobStatus.CANCELLED:
            # srlint: fault-ok caller-contract guard (cancellation is the caller's own act)
            raise RuntimeError(f"job {job_id} was cancelled")
        if job.status == JobStatus.ERROR:
            raise ServiceError(job.error or f"job {job_id} failed")
        return job.result

    def cancel(self, job_id: int) -> bool:
        """Cancel a job in flight. Its lanes are free at the next round;
        its table entries stay (salted, they shadow nothing). Returns False
        once the job had finished."""
        job = self._get(job_id)
        with self._work:
            if job.status in JobStatus.FINISHED:
                return False
            self._adm.remove(job)
            job.status = JobStatus.CANCELLED
            # Publish the cut's prefix before retire drops the frontier: a
            # successor continues from it.
            self._queue_publish(job)
            self._engine.retire(job)
            job.metrics.finished_at = time.monotonic()
            job.journal = job.state_journal = None  # finished: nothing reads them again
            self._events.emit("job.cancelled", job=job.id, trace=job.trace)
            job.event.set()
            self._work.notify_all()
            self._idle.notify_all()
        self._drain_publishes()
        return True

    def discovery_paths(self, job_id: int) -> dict:
        job = self._get(job_id)
        with self._lock:
            return {name: self._engine.reconstruct_path(job, fp)
                    for name, fp in job.discoveries.items()}

    def job_ids(self) -> list:
        with self._lock:
            return sorted(self._jobs)

    def stats(self) -> dict:
        """Service counters for dashboards and the HTTP `/.status`."""
        with self._lock:
            by_status: dict[str, int] = {}
            for j in self._jobs.values():
                by_status[j.status] = by_status.get(j.status, 0) + 1
            out = {
                "jobs": by_status,
                "queued": len(self._adm),
                "lane_util": round(self._engine.lane_util(), 4),
                "adm_p99_ms": self.admission_p99_ms(),
                "device_steps": self._engine.total_steps,
                "groups": len(self._engine.groups),
                "table_fill": round(self._engine.hot_claims / self._engine.table.size, 4),
                "store": self._engine.store_stats(),
                "telemetry": self._engine.telemetry_summary(),
                "faults": dict(self._engine.fault_counters),
            }
            if self.quotas is not None:
                out["tenants"] = self.quotas.snapshot()
                out["quota_rejected"] = self._quota_rejected
            corpus = self._engine.corpus_stats()
            if corpus is not None:
                out["corpus"] = corpus
            # The calibration join (obs/calib.py), once a chunk has closed.
            calib = self._engine.calib_detail()
            if calib is not None:
                out["calib"] = calib
            return out

    def lane_util(self) -> float:
        """The last fused step's batch occupancy (0..1): a fleet replica's
        lane-utilisation signal."""
        with self._lock:
            return self._engine.lane_util()

    def admission_p99_ms(self) -> float:
        """p99 of the recent queue waits, in milliseconds (0.0 before any
        admission)."""
        with self._lock:
            waits = sorted(self._queue_waits)
        if not waits:
            return 0.0
        return round(waits[min(len(waits) - 1, int(0.99 * len(waits)))] * 1e3, 3)

    def store_stats(self) -> Optional[dict]:
        with self._lock:
            return self._engine.store_stats()

    def telemetry_summary(self) -> Optional[dict]:
        with self._lock:  # a scrape must not race the scheduler's appends
            return self._engine.telemetry_summary()

    def table_fill(self) -> float:
        """The shared table's fill fraction."""
        with self._lock:
            return round(self._engine.hot_claims / self._engine.table.size, 4)

    def drift_ratio(self) -> Optional[float]:
        """The last closed calibration chunk's measured/predicted step cost
        (obs/calib.py), the reporter's `drift=` read (lock-free: one plain
        attribute read)."""
        calib = self._engine._calib
        return calib.drift_ratio() if calib is not None else None

    def metrics(self) -> dict:
        """The "service" metric source (obs/registry.py, `GET /metrics`):
        stats() and the two histograms. Per-job rows stay in `/.status`."""
        out = self.stats()
        out["admission_wait_ms"] = self._adm_hist
        out["lane_util_window"] = self._lane_hist
        return out

    def events_tail(self, job_id: Optional[int] = None, since: int = 0,
                    wait_s: float = 0.0) -> tuple:
        """The flight recorder's tail (`GET /jobs/<id>/events`):
        `(events, next_cursor)`, filtered to `job_id` when given; ([], since)
        with no recorder."""
        return self._events.tail(since=since, job=job_id, wait_s=wait_s)

    # -- scheduling ------------------------------------------------------------

    def _get(self, job_id: int) -> Job:
        with self._lock:
            try:
                return self._jobs[job_id]
            except KeyError:
                raise KeyError(f"no such job {job_id}") from None

    def _resident(self) -> list:
        return [j for j in self._jobs.values() if j.status == JobStatus.RUNNING]

    def _has_work(self) -> bool:
        return bool((len(self._adm) and self._admittable())
                    or any(g.runnable() for g in self._engine.groups.values()))

    def _admittable(self) -> bool:
        return self.max_resident is None or len(self._resident()) < self.max_resident

    def _finalize(self, job: Job, status: str = JobStatus.DONE) -> None:
        """Mark a job finished (under the lock); its publish, result,
        terminal event and wake-up follow in `_drain_finalizers`. The
        publish's gate and journal snapshot happen here, before retire
        drops the frontier."""
        self._tracer.instant("service.finalize", cat="service", job=job.id, status=status,
                             trace=job.trace)
        job.status = status
        job.metrics.finished_at = time.monotonic()
        payload = self._engine.prepare_publish(job)
        self._engine.retire(job)
        self._finalizing.append((job, status, payload))

    def _queue_publish(self, job: Job) -> None:
        """Queue a cut's partial publish (written by `_drain_publishes`)."""
        payload = self._engine.prepare_publish(job)
        if payload is not None:
            self._publishing.append(payload)

    def _drain_publishes(self) -> None:
        """Write the queued partial publishes off the lock. A failed write
        leaves no entry, never a wrong one."""
        while True:
            with self._lock:
                if not self._publishing:
                    return
                payload = self._publishing.pop(0)
            self._engine.publish_payload(payload)  # never raises

    def _drain_finalizers(self) -> None:
        """Complete every deferred finalisation: the corpus publish off the
        lock, then, under it, the result, the terminal event and the
        wake-up (the result after the publish, so that
        `detail["corpus"]["published"]` is true to it)."""
        self._drain_publishes()
        while True:
            with self._lock:
                if not self._finalizing:
                    return
                job, status, payload = self._finalizing.pop(0)
            published = payload is not None and self._engine.publish_payload(payload)
            with self._lock:
                if payload is not None:
                    job.published = published
                job.result = self._engine.build_result(job)
                # A finished job is never checkpointed or resumed: release
                # its journals (16 B a state, and the rows) while the Job
                # stays listed.
                job.journal = job.state_journal = None
                self._events.emit(
                    TERMINAL_EVENT_BY_STATUS[status], job=job.id, trace=job.trace,
                    states=job.state_count, unique=job.unique_count,
                    timed_out=job.timed_out or None,
                )
                job.event.set()
                self._idle.notify_all()

    def _expire_timeouts(self) -> None:
        now = time.monotonic()
        for job in list(self._jobs.values()):
            if job.status in JobStatus.FINISHED or job.deadline is None:
                continue
            if now > job.deadline:
                self._adm.remove(job)
                job.timed_out = True
                self._finalize(job)

    def _fail_job(self, job: Job, error: str) -> None:
        job.status = JobStatus.ERROR
        job.error = error
        job.metrics.finished_at = time.monotonic()
        self._events.emit("job.error", job=job.id, trace=job.trace, error=error)
        job.event.set()
        self._idle.notify_all()

    def _admit_waiting(self) -> None:
        while len(self._adm) and self._admittable():
            job = self._adm.pop_next()
            if job.status == JobStatus.PREEMPTED:
                try:
                    job.load_frontier()
                except CheckpointCorrupt as e:
                    # A torn spill loses this job's frontier only.
                    self._fail_job(job, f"preemption spill unreadable: {e}")
                    continue
                job.status = JobStatus.RUNNING
                job.steps_since_admit = 0
                self._engine.group_of(job).jobs.append(job)
                self._events.emit("replica.admit", job=job.id, trace=job.trace, preempted=True)
                continue
            resumed = job.resume is not None
            try:
                with self._tracer.span("service.admit", cat="service", job=job.id,
                                       trace=job.trace):
                    done = self._engine.admit(job)
            except ServiceError:
                raise
            except Exception as e:  # noqa: BLE001 — a bad model fails its own job
                self._fail_job(job, f"admission failed: {e}")
                continue
            job.metrics.admitted_at = time.monotonic()
            qw = job.metrics.queue_wait()
            if qw is not None:
                self._queue_waits.append(qw)
                self._adm_hist.observe(qw * 1000.0)
            job.status = JobStatus.RUNNING
            job.steps_since_admit = 0
            # A fleet requeue continuing from its checkpoint journals
            # `job.resumed`; the timeline reads crash -> requeue -> resume.
            self._events.emit("job.resumed" if resumed else "replica.admit",
                              job=job.id, trace=job.trace)
            if done is not None:
                self._finalize(job)

    def _preempt_if_due(self) -> None:
        """Park the longest-running over-budget job (at most one a round)
        when waiting jobs cannot be admitted."""
        if self.preempt_steps is None or not len(self._adm) or self._admittable():
            return
        head = self._adm.peek()
        due = [j for j in self._resident()
               if j.steps_since_admit >= self.preempt_steps
               # Never for a lower-priority waiter: the pair would swap
               # back and forth round after round.
               and head.priority >= j.priority]
        if not due:
            return
        job = max(due, key=lambda j: j.steps_since_admit)
        self._tracer.instant("service.preempt", cat="service", job=job.id, trace=job.trace)
        self._events.emit("job.preempted", job=job.id, trace=job.trace)
        g = self._engine.groups.get(id(job.model))
        if g is not None and job in g.jobs:
            g.jobs.remove(job)
        job.status = JobStatus.PREEMPTED
        job.metrics.preemptions += 1
        # Publish the cut (with its frontier) before the spill drops it: if
        # this replica dies while the job is parked, a successor continues
        # from the prefix.
        self._queue_publish(job)
        if self.spill_dir is not None and job.pending_lanes:
            job.spill_frontier(os.path.join(self.spill_dir, f"job{job.id}.frontier.npz"))
        self._adm.push(job)
        self._admit_waiting()

    def _handle_step_fault(self, fault: StepFault) -> None:
        """Retry, then quarantine by solo probe. The faulted lanes are
        already back in their frontiers (step_group's unwind), so within the
        retry budget the next round simply steps the group again; past it
        each runnable job of the group is stepped alone, and a job whose
        step fails alone is the poison and is quarantined. Other groups
        never notice."""
        group = fault.group
        group.fault_count += 1
        if group.fault_count <= self.retry_limit:
            self._engine.fault_counters["retries"] += 1
            self._tracer.instant("service.step_retry", cat="service",
                                 attempt=group.fault_count)
            return
        group.fault_count = 0
        for job in list(group.runnable()):
            try:
                finished = self._engine.step_group(group, only=[job])
            except StepFault as probe:
                self._quarantine(job, probe)
            else:
                for j in finished:
                    self._finalize(j)

    def _quarantine(self, job: Job, fault: StepFault) -> None:
        """Park a poison job as an error, marked quarantined; its table
        entries stay (salted, they shadow nothing)."""
        self._tracer.instant("service.quarantine", cat="service", job=job.id,
                             trace=job.trace)
        job.quarantined = True
        job.status = JobStatus.ERROR
        job.error = f"quarantined after repeated step faults: {fault.cause!r}"
        job.metrics.finished_at = time.monotonic()
        self._engine.retire(job)
        self._engine.fault_counters["quarantined_jobs"] += 1
        self._events.emit("job.quarantined", job=job.id, trace=job.trace, error=job.error)
        job.event.set()
        self._idle.notify_all()

    def _round(self) -> bool:
        """One scheduling round: timeouts, admission, preemption, one fused
        step of the next runnable group. Returns True if a step ran. A
        StepFault is absorbed here by the retry and quarantine policy."""
        plan = active_plan()
        if self._events.enabled and plan is not None and (
                plan.events is None or plan.events.closed):
            # The recorder adopts the active chaos plan: every injected
            # fault is journaled as `fault.injected`.
            plan.events = self._events
        self._expire_timeouts()
        self._admit_waiting()
        self._preempt_if_due()
        group = self._engine.next_group()
        if group is None:
            return False
        try:
            finished = self._engine.step_group(group)
        except StepFault as e:
            self._handle_step_fault(e)
            return True
        self._lane_hist.observe(self._engine.lane_util())
        for job in finished:
            self._finalize(job)
        return True

    def _loop(self) -> None:
        try:
            if self._cuda_index is not None:
                torch.cuda.set_device(self._cuda_index)
            while True:
                with self._work:
                    while not self._closed and not self._has_work() and not self._finalizing:
                        self._work.wait(timeout=0.05)  # doubles as the deadline poll
                        self._expire_timeouts()
                    if self._closed:
                        return
                    self._round()
                self._drain_finalizers()
        except ServiceError as e:
            with self._lock:
                self._failed = str(e)
                self._idle.notify_all()
        except Exception as e:  # noqa: BLE001 — never die silently
            # A scheduler fault outside the StepFault envelope fails every
            # job loudly instead of hanging their clients in result().
            with self._lock:
                self._failed = f"scheduler error: {type(e).__name__}: {e}"
                self._engine._fail_all(self._failed)
                self._idle.notify_all()
        finally:
            self._drain_finalizers()  # error exits still complete waiters

    # -- foreground driving (background=False) ---------------------------------

    def pump(self, rounds: int = 1) -> int:
        """Run up to `rounds` scheduling rounds in the calling thread;
        returns how many ran a step. Finished jobs are completed before it
        returns."""
        ran = 0
        try:
            with self._lock:
                for _ in range(rounds):
                    try:
                        if self._round():
                            ran += 1
                        elif not self._has_work():
                            break
                    except ServiceError as e:
                        self._failed = str(e)
                        raise
        finally:
            self._drain_finalizers()
        return ran

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted job has finished."""
        deadline = None if timeout is None else time.monotonic() + timeout

        def all_done():
            with self._lock:
                return all(j.status in JobStatus.FINISHED and j.event.is_set()
                           for j in self._jobs.values())

        if self._thread is None:
            # Foreground: pump in bursts, without holding the lock across
            # them.
            while not all_done():
                if self._failed:
                    raise ServiceError(self._failed)
                if not self.pump(64):
                    with self._lock:
                        self._expire_timeouts()
                        idle_now = not self._has_work()
                    self._drain_finalizers()
                    if not all_done() and idle_now:
                        time.sleep(0.01)
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError("drain timed out")
            return
        with self._idle:
            while not all_done():
                if self._failed:
                    raise ServiceError(self._failed)
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    raise TimeoutError("drain timed out")
                self._idle.wait(timeout=0.05 if left is None else min(left, 0.05))

    def close(self) -> None:
        """Stop the scheduler thread; queued and running jobs are
        cancelled."""
        with self._work:
            self._closed = True
            for job in list(self._jobs.values()):
                if job.status not in JobStatus.FINISHED:
                    self._adm.remove(job)
                    job.status = JobStatus.CANCELLED
                    # The shutdown cut publishes its prefix (off the lock,
                    # below), so that a fresh process continues warm.
                    self._queue_publish(job)
                    self._engine.retire(job)
                    self._events.emit("job.cancelled", job=job.id, trace=job.trace,
                                      shutdown=True)
                    job.event.set()
            self._work.notify_all()
            self._idle.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self._drain_finalizers()
        self._engine.close()
        REGISTRY.unregister(self._metrics_name)
        if self._trace_out:
            try:
                self._tracer.save(self._trace_out)
            except OSError:
                pass  # tracing must never fail a clean shutdown
        # Release a chaos plan that adopted this recorder.
        plan = active_plan()
        if plan is not None and plan.events is self._events:
            plan.events = None
        if self._events_owned is not None:
            self._events_owned.close()
        else:
            self._events.flush()


class ServiceChecker(Checker):
    """The `Checker` surface over a JobHandle: what `spawn_cuda` gives
    (counts, discoveries, join, assertions), served by a shared
    CheckService. `model.checker().spawn_service(service)` makes one."""

    def __init__(self, handle: JobHandle):
        super().__init__(handle._job.model)
        self._handle = handle

    def state_count(self) -> int:
        return self._handle._job.state_count

    def unique_state_count(self) -> int:
        return self._handle._job.unique_count

    def max_depth(self) -> int:
        return self._handle._job.max_depth

    def discoveries(self) -> dict:
        if not self._handle._job.event.is_set():
            return {}
        return self._handle.discoveries()

    def join(self) -> "ServiceChecker":
        self._handle.result(wait=True)
        return self

    def is_done(self) -> bool:
        return self._handle._job.event.is_set()

    def store_stats(self) -> Optional[dict]:
        return self._handle._service.store_stats()

    def table_fill(self) -> Optional[float]:
        return self._handle._service.table_fill()

    def drift_ratio(self) -> Optional[float]:
        return self._handle._service.drift_ratio()

    def telemetry_summary(self) -> Optional[dict]:
        return self._handle._service.telemetry_summary()
