"""The fleet's front door: consistent-hash routing, health probes,
requeue, work stealing (the JAX package's `service/router.py`).

`FleetRouter` puts N CheckService replicas (service/fleet.py wraps each in
a `Replica` runner) behind one submission surface that survives a
replica's death with no lost job:

- **Consistent hashing** (`HashRing`): a job is placed by a route key, by
  default its model's class name, so jobs of one model land on one replica
  and share its batches. When a replica dies only its keys move.
- **Bounded retry with deterministic backoff**: a submission that faults
  (the ``router.timeout`` chaos point) is retried on the ring's next
  replicas, with the seeded backoff of faults/plan.py.
- **Health probes**: each tick probes every replica; `unhealthy_after`
  failed probes in a row, or a dead runner, declares it dead.
- **Requeue and resume**: a dead replica's unfinished jobs are requeued on
  survivors. Where its runner checkpointed a job, the survivor resumes it
  from the newest intact generation (queue.JobResume re-seeds the job's
  journal into the survivor's table); otherwise the job restarts. BFS
  determinism keeps the results identical either way.
- **Work stealing** (``fleet.steal``): an idle replica pulls still-queued
  jobs from the most loaded one (a queued job has no table state, so the
  move is a withdraw there and a submit here).
- **Epoch-fenced leases** (service/lease.py): the router revokes a dead
  member's lease before requeueing its jobs and re-seals each orphan's
  newest generation under its own lease, so a zombie's later writes are
  provably stale; **rejoin** re-admits a dead member behind probation
  probes.

`serve_fleet` is the HTTP front door (``POST /jobs``, ``GET /jobs/<id>``,
cancel, ``GET /jobs/<id>/events``, the fleet ``/.status`` and Prometheus
``/metrics``). Overload and injected ``service.http`` faults are answered
with a 503 and a ``Retry-After`` header. Every routing decision is
journaled (obs/events.py) under the job's trace id, so
``python -m stateright_tpu_torch.obs.timeline`` reads a job's hops as one
lifecycle.
"""

from __future__ import annotations

import threading
import time
import zlib
from typing import Optional

from ..core.discovery import HasDiscoveries
from ..faults.ckptio import (
    CheckpointCorrupt,
    LEASE_STAMP_KEYS,
    fenced_load_latest,
    fenced_savez,
    latest_generation,
)
from ..faults.plan import (
    FaultError,
    _u01,
    active_plan,
    deterministic_backoff,
    maybe_fault,
)
from ..obs import (
    REGISTRY,
    TERMINAL_EVENT_BY_STATUS,
    as_events,
    as_tracer,
    mint_trace_id,
)
from .queue import JobStatus
from .tenancy import DEFAULT_TENANT, QuotaExceeded


class ReplicaDead(RuntimeError):
    """The targeted replica's runner has stopped (crash, hang past the
    probe policy, or shutdown); the router must place the work elsewhere."""


def lease_member(idx: int) -> str:
    """The one spelling of a replica's lease-member and journal-writer name
    (the fleet's wiring and the timeline's fence key on it)."""
    return f"replica{idx}"


class ResumeToken:
    """A requeued/stolen job's resume pointer: the checkpoint path whose
    newest fenced generation the next replica must resume from. The token,
    not a loaded payload, crosses the replica seam: the replica loads it
    through `ckptio.fenced_load_latest`, so a zombie's stale generation is
    rejected wherever the resume happens."""

    __slots__ = ("path",)

    def __init__(self, path: str):
        self.path = path

    def __repr__(self) -> str:
        return f"ResumeToken({self.path!r})"


class NoHealthyReplica(RuntimeError):
    """Every replica is dead; rendered as a 503 + Retry-After over HTTP."""


class FleetJobStatus:
    ROUTED = "routed"  # bound to a replica (queued or running there)
    DONE = "done"
    CANCELLED = "cancelled"
    ERROR = "error"

    FINISHED = (DONE, CANCELLED, ERROR)


# -- consistent hashing --------------------------------------------------------


class HashRing:
    """crc32 consistent-hash ring with virtual nodes. `lookup(key)` is the
    owner; `preference(key)` is the owner followed by distinct successors —
    the retry/failover order. Removing a member moves ONLY its keys."""

    def __init__(self, members, vnodes: int = 64):
        self.vnodes = vnodes
        self._points: list = []  # sorted [(hash, member)]
        self._members: set = set()
        for m in members:
            self.add(m)

    @staticmethod
    def _hash(s: str) -> int:
        return zlib.crc32(s.encode()) & 0xFFFFFFFF

    def add(self, member) -> None:
        if member in self._members:
            return
        self._members.add(member)
        # Rebind (never mutate in place): concurrent readers snapshot
        # self._points once and must never observe a mid-sort list.
        self._points = sorted(
            self._points
            + [(self._hash(f"{member}#{v}"), member) for v in range(self.vnodes)]
        )

    def remove(self, member) -> None:
        if member not in self._members:
            return
        self._members.discard(member)
        self._points = [(h, m) for h, m in self._points if m != member]

    def members(self) -> list:
        return sorted(self._members)

    def lookup(self, key: str):
        order = self.preference(key)
        return order[0] if order else None

    def preference(self, key: str) -> list:
        """Every member, ordered by ring distance from `key`'s point —
        index 0 is the owner, the rest are the failover walk."""
        points = self._points  # one snapshot: remove() may rebind mid-walk
        if not points:
            return []
        h = self._hash(key)
        # First point at or after h (wrap), then walk clockwise.
        lo, hi = 0, len(points)
        while lo < hi:
            mid = (lo + hi) // 2
            if points[mid][0] < h:
                lo = mid + 1
            else:
                hi = mid
        seen: list = []
        n = len(points)
        for i in range(n):
            m = points[(lo + i) % n][1]
            if m not in seen:
                seen.append(m)
        return seen


# -- fleet jobs ----------------------------------------------------------------


class FleetJob:
    """Router-side record of one submitted job: the spec (enough to
    resubmit it anywhere), its current binding, and its completion state."""

    def __init__(self, fleet_id: int, model, key: str, opts: dict,
                 ckpt_path: Optional[str], model_ref: Optional[tuple] = None):
        self.id = fleet_id
        self.model = model
        # (registry name, args dict) when known: what a replica in another
        # process (ROADMAP A item 3) would submit, since model objects
        # cannot cross a process boundary.
        self.model_ref = model_ref
        self.key = key
        # Flight-recorder trace id: minted HERE (the outermost front door)
        # and carried through every replica the job ever touches, so the
        # timeline CLI reads the whole hop story as one lifecycle.
        self.trace = mint_trace_id()
        self.opts = opts  # finish_when/targets/timeout/priority
        self.ckpt_path = ckpt_path
        self.status = FleetJobStatus.ROUTED
        self.replica: Optional[int] = None
        self.handle = None  # inner JobHandle on the bound replica
        self.requeues = 0
        self.steals = 0
        self.result = None
        self.error: Optional[str] = None
        self.event = threading.Event()
        self.submitted_at = time.monotonic()
        self.finished_at: Optional[float] = None


class FleetJobHandle:
    """Client-side handle (the fleet twin of api.JobHandle). The handle
    survives requeues and steals — it tracks the job, not a replica."""

    def __init__(self, router: "FleetRouter", job: FleetJob):
        self._router = router
        self._job = job

    @property
    def id(self) -> int:
        return self._job.id

    def status(self) -> str:
        return self._job.status

    def poll(self) -> dict:
        return self._router.poll(self._job.id)

    def result(self, wait: bool = True, timeout: Optional[float] = None):
        return self._router.result(self._job.id, wait=wait, timeout=timeout)

    def cancel(self) -> bool:
        return self._router.cancel(self._job.id)

    def discoveries(self) -> dict:
        return self._router.discovery_paths(self._job.id)


# -- the router ----------------------------------------------------------------


class FleetRouter:
    def __init__(
        self,
        replicas,
        seed: int = 0,
        retry_limit: int = 2,
        backoff_base_s: float = 0.02,
        backoff_cap_s: float = 0.5,
        probe_timeout_s: float = 1.0,
        unhealthy_after: int = 3,
        steal: bool = True,
        background: bool = False,
        ckpt_dir: Optional[str] = None,
        tracer=None,
        events=None,
        lease_store=None,
        router_lease=None,
        probe_backoff_base: int = 1,
        probe_backoff_cap: int = 8,
        probation_probes: int = 2,
        quotas=None,
    ):
        """`replicas` are service/fleet.py `Replica` runners (one
        CheckService each). `background=True` makes probes run under a
        deadline thread (a hung replica must not hang the router);
        foreground mode (deterministic tests) probes inline. `ckpt_dir`
        enables the requeue-resume plane (per-job checkpoint generations
        written by the replica runners, restored here on replica death).
        `events` is the router's flight-recorder journal (obs/events.py,
        usually `ServiceFleet(journal_dir=...)`'s `router.jsonl`): every
        routing decision, failover, requeue, and steal is journaled keyed
        by the job's trace id, the fleet `/.status` carries the last-N
        event ring, and `GET /jobs/<id>/events` tails it live.

        `lease_store` + `router_lease` (service/lease.py, wired by
        `ServiceFleet(lease_dir=...)`) turn on epoch
        fencing: this router is the single lease authority — it REVOKES a
        member's lease before requeueing its jobs (so the member's later
        writes are provably stale) and re-seals each orphan's newest
        intact checkpoint generation under its own never-revoked lease.

        `probe_backoff_base` / `probe_backoff_cap` (ticks) are the
        exponential probe backoff for repeatedly-failing members: a
        partitioned replica's probes are deferred (with seeded jitter)
        instead of eating the tick budget every round.

        `probation_probes` is the rejoin quarantine: a dead/fenced member
        re-registered through `rejoin` must answer this many CONSECUTIVE
        health probes before its keys move back (`HashRing.add` — only
        ITS keys, mirroring dead-member removal); until promotion it
        receives no placements and neither steals nor is stolen from.

        `quotas` (service/tenancy.py `TenantQuotas`) turns on the
        fleet-wide admission gate: `submit(tenant=...)` counts the
        tenant's unfinished fleet jobs against its `max_in_flight` and
        its lane-seconds spend against its windowed budget, rejecting
        with `QuotaExceeded` (rendered as HTTP 429 + Retry-After by
        serve_fleet). The default tenant is never gated."""
        self.replicas = {r.idx: r for r in replicas}
        self.ckpt_dir = ckpt_dir
        self.ring = HashRing(list(self.replicas))
        self.seed = seed
        self.retry_limit = retry_limit
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.probe_timeout_s = probe_timeout_s
        self.unhealthy_after = unhealthy_after
        self.steal = steal
        self.background = background
        self._tracer = as_tracer(tracer)
        self._events = as_events(events)
        self.lease_store = lease_store
        self.router_lease = router_lease
        self.quotas = quotas
        self.probe_backoff_base = max(int(probe_backoff_base), 1)
        self.probe_backoff_cap = max(int(probe_backoff_cap), 1)
        self._jobs: dict[int, FleetJob] = {}
        self._next_id = 1
        self._lock = threading.RLock()
        self.probation_probes = max(int(probation_probes), 1)
        self._suspect: dict[int, int] = {r: 0 for r in self.replicas}
        self._dead: set = set()
        self._tick_n = 0
        self._next_probe: dict[int, int] = {}  # idx -> earliest probe tick
        self._probation: dict[int, int] = {}  # idx -> healthy probes still owed
        # Members mid-retirement (autoscale scale-in drain): excluded from
        # placement AND from stealing (as thieves — their backlog is still
        # fair game for others to steal away, which IS the drain).
        self._draining: set = set()
        self.counters = {
            "jobs_routed": 0,
            "router_retries": 0,
            "router_backoff_ms": 0,
            "probe_failures": 0,
            "probe_skipped": 0,
            "replica_crashes": 0,
            "requeued_jobs": 0,
            "restored_jobs": 0,
            "steals": 0,
            "lease_revokes": 0,
            "lease_reseals": 0,
            "rejoins": 0,
            "rejoin_promotions": 0,
            "quota_rejected": 0,
            "scale_outs": 0,
            "scale_ins": 0,
        }
        self._metrics_name = REGISTRY.register("fleet", self.metrics)
        if self.lease_store is not None:
            # The grants happened before the replicas started; journal them
            # here so the lease lifecycle reads whole in the router journal.
            for idx in self.replicas:
                epoch, _state = self.lease_store.state(lease_member(idx))
                if epoch:
                    self._events.emit(
                        "lease.grant", member=lease_member(idx), epoch=epoch
                    )

    # -- client surface --------------------------------------------------------

    def submit(
        self,
        model,
        route_key: Optional[str] = None,
        finish_when: HasDiscoveries = HasDiscoveries.ALL,
        target_state_count: Optional[int] = None,
        target_max_depth: Optional[int] = None,
        timeout: Optional[float] = None,
        priority: int = 0,
        model_ref: Optional[tuple] = None,
        tenant: str = DEFAULT_TENANT,
    ) -> FleetJobHandle:
        """Route one job onto the fleet; returns immediately. `route_key`
        defaults to the model's type name — same-key jobs share a replica
        (and so a compiled step); distinct keys spread over the ring.
        `model_ref=(registry name, args)` names the model for a replica in
        another process (ROADMAP A item 3; serve_fleet fills it in);
        in-process replicas take the model object itself.
        `tenant` is the job's billing identity: it rides in `opts` through
        `_spec` into every replica's `CheckService.submit` (quota
        accounting and tenant-fair admission key on it), and when the
        router was built with `quotas` a
        non-default tenant over its in-flight or lane-seconds budget is
        rejected HERE with `QuotaExceeded` before any replica is
        touched."""
        if self.quotas is not None and tenant != DEFAULT_TENANT:
            with self._lock:
                in_flight = sum(
                    1 for fj in self._jobs.values()
                    if fj.opts.get("tenant") == tenant
                    and fj.status not in FleetJobStatus.FINISHED
                )
            try:
                self.quotas.admit(tenant, in_flight)
            except QuotaExceeded:
                with self._lock:
                    self.counters["quota_rejected"] += 1
                self._events.emit("job.quota_rejected", tenant=tenant)
                raise
        if not self._healthy():
            # One of the satellite 503/Retry-After surfaces: journaled so
            # a forensic pass can see WHY clients were bounced.
            self._events.emit(
                "router.unavailable", reason="no healthy replica"
            )
            self._tracer.instant("router.unavailable", cat="fleet")
            raise NoHealthyReplica(
                "every fleet replica is dead; resubmit after recovery"
            )
        key = route_key if route_key is not None else type(model).__name__
        opts = dict(
            finish_when=finish_when,
            target_state_count=target_state_count,
            target_max_depth=target_max_depth,
            timeout=timeout,
            priority=priority,
            tenant=tenant,
        )
        with self._lock:
            fj = FleetJob(
                self._next_id, model, key, opts,
                self._ckpt_path_for(self._next_id), model_ref=model_ref,
            )
            self._next_id += 1
            self._jobs[fj.id] = fj
        self._events.emit(
            "job.submitted", job=fj.id, trace=fj.trace, key=key
        )
        self._place(fj)
        return FleetJobHandle(self, fj)

    def _ckpt_path_for(self, fleet_id: int) -> Optional[str]:
        if self.ckpt_dir is None:
            return None
        import os

        return os.path.join(self.ckpt_dir, f"fleetjob{fleet_id}.npz")

    def poll(self, job_id: int) -> dict:
        fj = self._get(job_id)
        with self._lock:
            out = {
                "id": fj.id,
                "status": fj.status,
                "trace": fj.trace,
                "replica": fj.replica,
                "requeues": fj.requeues,
                "steals": fj.steals,
                "error": fj.error,
            }
            if fj.handle is not None:
                try:
                    inner = fj.handle.poll()
                except Exception:  # noqa: BLE001 — a dead replica's poll
                    inner = None
                if inner is not None:
                    for k in (
                        "state_count", "unique_state_count", "max_depth",
                        "discoveries",
                    ):
                        out[k] = inner.get(k)
                    out["replica_status"] = inner.get("status")
            return out

    def result(
        self, job_id: int, wait: bool = True, timeout: Optional[float] = None
    ):
        fj = self._get(job_id)
        if wait:
            if not fj.event.wait(timeout):
                raise TimeoutError(f"fleet job {job_id} still running")
        elif not fj.event.is_set():
            return None
        if fj.status == FleetJobStatus.CANCELLED:
            raise RuntimeError(f"fleet job {job_id} was cancelled")
        if fj.status == FleetJobStatus.ERROR:
            raise RuntimeError(fj.error or f"fleet job {job_id} failed")
        return fj.result

    def cancel(self, job_id: int) -> bool:
        fj = self._get(job_id)
        with self._lock:
            if fj.status in FleetJobStatus.FINISHED:
                return False
            if fj.handle is not None:
                try:
                    fj.handle.cancel()
                except Exception:  # noqa: BLE001 — dead replica: job dies here
                    pass
            self._finish(fj, FleetJobStatus.CANCELLED)
            return True

    def discovery_paths(self, job_id: int) -> dict:
        fj = self._get(job_id)
        if fj.handle is None:
            return {}
        return fj.handle.discoveries()

    def job_ids(self) -> list:
        with self._lock:
            return sorted(self._jobs)

    def _get(self, job_id: int) -> FleetJob:
        with self._lock:
            try:
                return self._jobs[job_id]
            except KeyError:
                raise KeyError(f"no such fleet job {job_id}") from None

    # -- placement -------------------------------------------------------------

    def _healthy(self) -> list:
        return [
            r for r in self.replicas.values()
            if r.idx not in self._dead and r.alive
        ]

    def _spec(self, fj: FleetJob, resume=None) -> dict:
        return dict(
            fj.opts,
            model=fj.model,
            model_ref=fj.model_ref,
            journal=fj.ckpt_path is not None,
            resume=resume,  # None | ResumeToken (each replica resolves it)
            trace=fj.trace,  # one timeline across every replica hop
        )

    def _backoff(self, attempt: int) -> None:
        # The seeded backoff of faults/plan.py.
        delay = deterministic_backoff(
            self.seed, "router.backoff", attempt,
            self.backoff_base_s, self.backoff_cap_s,
        )
        if delay <= 0:
            return
        with self._lock:
            self.counters["router_backoff_ms"] += int(delay * 1000)
        time.sleep(delay)

    def _place(self, fj: FleetJob, resume=None) -> bool:
        """Bind `fj` to a replica along its ring preference, retrying
        faults with deterministic backoff. On exhaustion the job is failed
        (never silently dropped). The whole walk is one `router.place`
        span; every failed attempt is a `router.failover` journal event,
        every binding a `router.route`."""
        last: Optional[BaseException] = None
        with self._tracer.span(
            "router.place", cat="fleet", job=fj.id, trace=fj.trace,
            resumed=resume is not None,
        ):
            for attempt in range(self.retry_limit + 1):
                order = [
                    i for i in self.ring.preference(fj.key)
                    if i not in self._dead and i not in self._draining
                    and self.replicas[i].alive
                ]
                if not order:
                    # Ring empty but probation members alive (every live
                    # member is mid-rejoin — e.g. the 1-replica fleet's
                    # only member rejoining): place on them rather than
                    # hard-failing the job. "No placements during
                    # probation" is a load-shedding policy for when ring
                    # members exist, not a reason to turn a 2-tick
                    # quarantine window into a permanent job ERROR.
                    with self._lock:
                        order = sorted(
                            i for i in self._probation
                            if i not in self._dead
                            and i not in self._draining
                            and self.replicas[i].alive
                        )
                if not order:
                    break
                r = self.replicas[order[attempt % len(order)]]
                try:
                    # Chaos-plane boundary: an injected `router.timeout`
                    # fires BEFORE the replica is touched, so the retry is
                    # exact.
                    maybe_fault("router.timeout", replica=r.idx, job=fj.id)
                    handle = r.submit(self._spec(fj, resume), fj.ckpt_path)
                except (FaultError, ReplicaDead) as e:
                    last = e
                    with self._lock:
                        self.counters["router_retries"] += 1
                    self._tracer.instant(
                        "router.failover", cat="fleet", job=fj.id,
                        replica=r.idx, trace=fj.trace,
                    )
                    self._events.emit(
                        "router.failover", job=fj.id, trace=fj.trace,
                        replica=r.idx, error=type(e).__name__,
                    )
                    self._backoff(attempt)
                    continue
                with self._lock:
                    if fj.status in FleetJobStatus.FINISHED:
                        # A cancel raced the (re)placement: reap the copy.
                        try:
                            handle.cancel()
                        except Exception:  # noqa: BLE001 — best-effort reap
                            pass
                        return False
                    if r.idx in self._dead or not r.alive:
                        # The replica died between submit and bind: binding
                        # now would park the job on a corpse forever (the
                        # death handler already scanned for orphans and
                        # missed this still-unbound job). Treat it as a
                        # failed attempt.
                        last = ReplicaDead(
                            f"replica {r.idx} died during placement"
                        )
                        continue
                    fj.replica = r.idx
                    fj.handle = handle
                    self.counters["jobs_routed"] += 1
                self._events.emit(
                    "router.route", job=fj.id, trace=fj.trace,
                    replica=r.idx, resumed=bool(resume) or None,
                    attempt=attempt or None,
                )
                return True
        with self._lock:
            if fj.status in FleetJobStatus.FINISHED:
                return False  # cancelled while no replica would take it
            fj.error = (
                f"no healthy replica accepted fleet job {fj.id}"
                + (f" (last: {type(last).__name__}: {last})" if last else "")
            )
            self._finish(fj, FleetJobStatus.ERROR)
        return False

    def _finish(self, fj: FleetJob, status: str) -> None:
        fj.status = status
        fj.finished_at = time.monotonic()
        # Every fleet job's timeline ends with exactly one router-side
        # terminal event (the timeline CLI's no_terminal anomaly guard).
        self._events.emit(
            TERMINAL_EVENT_BY_STATUS[status], job=fj.id, trace=fj.trace,
            error=fj.error, requeues=fj.requeues or None,
            steals=fj.steals or None,
        )
        fj.event.set()

    # -- replica rejoin --------------------------------------------------------

    def rejoin(self, replica) -> bool:
        """Re-admit a restarted incarnation of a dead/fenced member behind
        the quarantine policy: the new runner replaces the dead one in the
        replica map and is probed like any member, but its keys do NOT
        move back until it answers `probation_probes` consecutive health
        probes — only then does `HashRing.add` re-route ITS keys (and only
        its keys: consistent hashing makes re-add the exact mirror of
        dead-member removal, pinned by the ring unit tests). The caller
        (ServiceFleet.rejoin_replica) granted the member a FRESH lease
        epoch first, so a stale zombie of the old incarnation racing this
        rejoin is fence-rejected on every write — the exact-epoch check
        fails for the old epoch the moment the grant lands.

        The ``fleet.rejoin`` chaos point fires at the TOP of the caller
        (`ServiceFleet.rejoin_replica`) — before the fresh grant, before
        the spawn — so an injected fault aborts the whole rejoin with
        literally nothing changed (not even a burned epoch).

        A brand-new index (an autoscaler's scale-out, ROADMAP A item 3)
        joins through the same door and the same quarantine: it is
        registered and probed like any member but gets no keys (and no
        placements) until `probation_probes` consecutive healthy probes
        promote it — a flapping new member never receives work it would
        immediately orphan. The only differences are the books: the join
        counts as `scale_outs` (not `rejoins`) and journals
        `fleet.scale_out` (not `replica.rejoin`)."""
        with self._lock:
            grown = replica.idx not in self.replicas
            if not grown and replica.idx not in self._dead:
                return False  # alive: nothing to rejoin
            self._dead.discard(replica.idx)
            self._draining.discard(replica.idx)
            self.replicas[replica.idx] = replica
            self._suspect[replica.idx] = 0
            self._next_probe.pop(replica.idx, None)
            self._probation[replica.idx] = self.probation_probes
            if grown:
                self.counters["scale_outs"] += 1
            else:
                self.counters["rejoins"] += 1
        if grown:
            self._tracer.instant(
                "fleet.scale_out", cat="fleet", replica=replica.idx
            )
            self._events.emit(
                "fleet.scale_out", replica=replica.idx,
                probes=self.probation_probes,
            )
            return True
        self._tracer.instant(
            "fleet.rejoin", cat="fleet", replica=replica.idx
        )
        self._events.emit(
            "replica.rejoin", replica=replica.idx, phase="probation",
            probes=self.probation_probes,
        )
        return True

    def _promote(self, idx: int) -> None:
        """Probation served: move the member's keys back (ring re-add)."""
        with self._lock:
            if self._probation.pop(idx, None) is None:
                return
            self.counters["rejoin_promotions"] += 1
        self.ring.add(idx)
        self._events.emit(
            "replica.rejoin", replica=idx, phase="ring"
        )
        self._tracer.instant(
            "fleet.rejoin_promoted", cat="fleet", replica=idx
        )

    # -- replica retire (an autoscaler's scale-in) -----------------------------

    def retire(self, idx: int) -> bool:
        """Gracefully remove a healthy member (an autoscaler's scale-in;
        `ServiceFleet.scale_in` waits for ROADMAP A item 3). The drain is
        loss-free by the same
        argument as the death path, in a safer order:

        1. mark the member DRAINING — no new placements land on it and it
           stops stealing (its own queue stays stealable: steals away from
           it are the drain working);
        2. revoke its lease (persisted) — from here every write the
           still-running member attempts is provably stale, exactly the
           zombie discipline of `_on_replica_death`. A revocation that
           does not durably land aborts the WHOLE retirement (the member
           un-drains and keeps serving; the autoscaler retries next tick);
        3. remove it from the ring, requeue every unfinished job it held
           onto survivors — resumed from the newest intact re-sealed
           checkpoint generation when one exists, restarted fresh
           otherwise. BFS determinism keeps results bit-identical either
           way (the scale-in drain golden test pins this).

        Journals ONE `fleet.scale_in` (and counts `scale_ins`), not
        `replica.crash` — the timeline must read as a decision, not a
        failure. Refuses (False) to retire the last healthy member.
        The ``fleet.autoscale`` chaos point fires in the CALLER before
        anything here runs, so an injected fault changes nothing."""
        with self._lock:
            r = self.replicas.get(idx)
            if r is None or idx in self._dead:
                return False
            survivors = [
                i for i in self.replicas
                if i != idx and i not in self._dead
                and i not in self._draining and self.replicas[i].alive
            ]
            if not survivors:
                return False  # never drain the fleet to zero members
            self._draining.add(idx)
        member = lease_member(idx)
        if self.lease_store is not None:
            try:
                epoch = self.lease_store.revoke(member)
            except (FaultError, OSError):
                # The revocation did not durably land: abort the whole
                # retirement — requeueing before a durable revoke would
                # hand the still-running member a license to corrupt.
                with self._lock:
                    self._draining.discard(idx)
                self._tracer.instant(
                    "lease.revoke_race", cat="fleet", member=member
                )
                return False
            if epoch is not None:
                self.counters["lease_revokes"] += 1
                self._events.emit(
                    "lease.revoke", member=member, epoch=epoch
                )
        with self._lock:
            self._dead.add(idx)
            self._draining.discard(idx)
            self._probation.pop(idx, None)
            orphans = [
                fj for fj in self._jobs.values()
                if fj.replica == idx
                and fj.status not in FleetJobStatus.FINISHED
            ]
            self.counters["scale_ins"] += 1
        self.ring.remove(idx)
        self._tracer.instant(
            "fleet.scale_in", cat="fleet", replica=idx,
            orphans=len(orphans),
        )
        self._events.emit(
            "fleet.scale_in", replica=idx, orphans=len(orphans)
        )
        with self._tracer.span(
            "fleet.drain", cat="fleet", replica=idx, orphans=len(orphans)
        ):
            for fj in orphans:
                with self._lock:
                    fj.requeues += 1
                    fj.replica = None
                    fj.handle = None
                    self.counters["requeued_jobs"] += 1
                resume = self._resume_token(fj, reseal=True)
                if resume is not None:
                    self.counters["restored_jobs"] += 1
                self._events.emit(
                    "job.requeued", job=fj.id, trace=fj.trace, src=idx,
                    reason="scale-in drain", restored=resume is not None,
                )
                self._place(fj, resume=resume)
        return True

    # -- supervision tick ------------------------------------------------------

    def tick(self) -> None:
        """One supervision round: probe health (dead → requeue), harvest
        finished inner jobs, steal for idle replicas. Driven by the fleet's
        router thread (background) or `ServiceFleet.pump` (foreground)."""
        plan = active_plan()
        if (
            plan is not None
            and self._events.enabled
            and (plan.events is None or plan.events.closed)
        ):
            # Flight-recorder adoption of the active chaos plan: every
            # injection anywhere in the process lands in this journal as
            # `fault.injected` — a chaos run is an auditable recording.
            # A closed adoptee (a previous run's journal) is replaced.
            plan.events = self._events
        self._probe_all()
        self._harvest()
        if self.steal:
            self._steal()

    def _probe_all(self) -> None:
        self._tick_n += 1
        for r in list(self.replicas.values()):
            if r.idx in self._dead:
                continue
            if not r.alive:
                self._on_replica_death(r)
                continue
            if self._tick_n < self._next_probe.get(r.idx, 0):
                # Exponential probe backoff: a repeatedly-failing member
                # (partitioned, hung) is probed on a widening jittered
                # cadence instead of eating a probe deadline out of EVERY
                # router tick.
                self.counters["probe_skipped"] += 1
                continue
            ok = self._probe(r)
            if ok is None:
                # The probe worker never got scheduled inside the budget
                # (host starvation — e.g. compile threads hogging a small
                # box): that measures the HOST, not the replica. No
                # evidence either way — neither reset nor grow suspicion.
                continue
            if ok:
                self._suspect[r.idx] = 0
                self._next_probe.pop(r.idx, None)
                owed = self._probation.get(r.idx)
                if owed is not None:
                    # One healthy probation probe served; promotion (ring
                    # re-add) happens only when the full run is CONSECUTIVE.
                    if owed <= 1:
                        self._promote(r.idx)
                    else:
                        self._probation[r.idx] = owed - 1
                continue
            if r.idx in self._probation:
                # A failed probe resets the probation clock: the quarantine
                # demands consecutive health, not eventual health.
                self._probation[r.idx] = self.probation_probes
            self.counters["probe_failures"] += 1
            self._suspect[r.idx] += 1
            backoff = min(
                self.probe_backoff_base * 2 ** (self._suspect[r.idx] - 1),
                self.probe_backoff_cap,
            )
            # Seeded jitter (±25%): N members suspected on the same tick
            # must not re-probe in lockstep forever.
            jitter = 0.75 + 0.5 * _u01(
                self.seed, "router.probe_jitter",
                self._tick_n * 131 + r.idx,
            )
            self._next_probe[r.idx] = self._tick_n + max(
                1, int(round(backoff * jitter))
            )
            # Journal/span only probe FAILURES: healthy probes fire every
            # tick per replica and would drown both planes in no-ops —
            # the suspect counter is the forensic story a failure tells.
            self._tracer.instant(
                "router.probe_failure", cat="fleet", replica=r.idx,
                suspect=self._suspect[r.idx],
            )
            self._events.emit(
                "router.probe", replica=r.idx, ok=0,
                suspect=self._suspect[r.idx],
            )
            if self._suspect[r.idx] >= self.unhealthy_after or not r.alive:
                self._on_replica_death(r)

    def _probe(self, r) -> Optional[bool]:
        """True iff the replica answered its status probe in time; False
        on a failure/timeout; None when the probe WORKER never started
        inside the budget (a starved host scheduler — no evidence about
        the replica at all, so the caller must not move the suspect
        counter either way; counting it as a failure is how a loaded box
        false-positively killed perfectly healthy replicas). In
        background mode the probe runs under a deadline thread — a hung
        replica (injected `fleet.replica_hang` or a real wedge) shows up
        as a timeout, not a hung router."""
        if not self.background:
            try:
                r.probe()
                return True
            except Exception:  # noqa: BLE001 — any probe failure counts
                return False
        box: list = []
        started = threading.Event()

        def work():
            started.set()
            try:
                box.append(("ok", r.probe()))
            except BaseException as e:  # noqa: BLE001 — reported as unhealthy
                box.append(("err", e))

        t = threading.Thread(target=work, daemon=True)
        t.start()
        deadline = time.monotonic() + self.probe_timeout_s
        if not started.wait(self.probe_timeout_s):
            return None  # never scheduled: the box is starved, not the replica
        # The probe itself gets the remaining budget, floored at half —
        # a late-scheduled worker still deserves a real chance (the whole
        # point of the started gate), but total per-probe blocking stays
        # <= 1.5x the timeout so death detection doesn't crawl on a
        # loaded box.
        t.join(
            max(deadline - time.monotonic(), self.probe_timeout_s * 0.5)
        )
        if not box:
            # One short grace re-check: a long GIL hold (jit tracing on a
            # busy service) stalls THIS thread and the worker together,
            # so the deadline can expire with the trivial probe one
            # bytecode-quantum from finishing — when the holder releases,
            # the answer lands instantly. A real hang stays empty here
            # and costs only these extra milliseconds to declare.
            t.join(min(0.1, self.probe_timeout_s / 5))
        return bool(box) and box[0][0] == "ok"

    def _on_replica_death(self, r) -> None:
        """Remove the replica from the ring and requeue every unfinished
        job it held — resumed from its newest intact checkpoint generation
        when one exists, restarted fresh otherwise. Zero lost jobs either
        way.

        With the lease plane on, the member's lease is REVOKED (persisted)
        before anything is requeued, and each orphan's newest intact
        generation is re-sealed under the router's own lease — so if the
        "dead" replica is actually a zombie (hung, partitioned), every
        write it attempts from here on is provably stale: its fenced
        writes refuse themselves, and the one raced write that can slip
        through an already-open fd is rejected at load time by the stamp
        check. An injected `lease.revoke_race` fault aborts the whole
        death handling BEFORE any state changes; the next tick re-detects
        the death and re-runs it — revoke-then-requeue stays atomic."""
        with self._lock:
            if r.idx in self._dead:
                return
        member = lease_member(r.idx)
        if self.lease_store is not None:
            try:
                epoch = self.lease_store.revoke(member)
            except FaultError:
                # Injected lease.revoke_race: nothing was persisted and
                # nothing is requeued — the member stays (suspected)
                # alive until the next tick retries the revocation.
                self._tracer.instant(
                    "lease.revoke_race", cat="fleet", member=member
                )
                return
            except OSError:
                # The revocation did not durably land (store outage /
                # torn writes past the lease store's retries): abort the
                # WHOLE death handling — requeueing before a durable
                # revoke would hand the zombie a license to corrupt.
                # Next tick re-detects the death and retries.
                self._tracer.instant(
                    "lease.revoke_race", cat="fleet", member=member
                )
                return
            if epoch is not None:
                self.counters["lease_revokes"] += 1
                self._events.emit(
                    "lease.revoke", member=member, epoch=epoch
                )
        with self._lock:
            if r.idx in self._dead:
                return
            self._dead.add(r.idx)
            # A member dying DURING probation never made it back into the
            # ring; dropping the probation entry is the whole cleanup.
            self._probation.pop(r.idx, None)
            orphans = [
                fj for fj in self._jobs.values()
                if fj.replica == r.idx
                and fj.status not in FleetJobStatus.FINISHED
            ]
        self.counters["replica_crashes"] += 1
        self.ring.remove(r.idx)
        self._tracer.instant(
            "fleet.replica_dead", cat="fleet", replica=r.idx,
            orphans=len(orphans),
        )
        # The router is the single authority on fleet membership, so it
        # (not the replica runner) writes the one `replica.crash` event —
        # event counts stay consistent with the `replica_crashes` counter.
        self._events.emit(
            "replica.crash", replica=r.idx, error=r.error,
            orphans=len(orphans),
        )
        with self._tracer.span(
            "fleet.requeue", cat="fleet", replica=r.idx,
            orphans=len(orphans),
        ):
            for fj in orphans:
                with self._lock:
                    fj.requeues += 1
                    fj.replica = None
                    fj.handle = None
                    self.counters["requeued_jobs"] += 1
                resume = self._resume_token(fj, reseal=True)
                if resume is not None:
                    self.counters["restored_jobs"] += 1
                self._events.emit(
                    "job.requeued", job=fj.id, trace=fj.trace, src=r.idx,
                    restored=resume is not None,
                )
                self._place(fj, resume=resume)

    def _resume_token(self, fj: FleetJob, reseal: bool = False):
        """Probe the job's newest intact checkpoint generation; return a
        `ResumeToken` for the next replica to resolve, or None (restart
        fresh — still exact). With `reseal=True` (the death path — the
        writer's lease was JUST revoked) the generation is re-written
        under the router's own lease first: the revoked stamp it carries
        is legitimate (written before the revocation, which is exactly why
        this load accepts it with CRC-only validation), but every LATER
        read must be able to tell it from a zombie write — after the
        re-seal, anything still stamped with the revoked epoch is by
        definition post-revocation and gets rejected. The non-reseal paths
        (steal, lost-withdraw requeue — the checkpoint's writer is a LIVE
        member, its stamps valid by construction) use a cheap
        CRC-existence probe instead of parsing the whole npz on the
        supervisor tick thread; the receiving replica is the one that
        loads the bytes (through the fence) anyway."""
        if fj.ckpt_path is None:
            return None
        if reseal and self.router_lease is not None:
            try:
                # CRC-only load: the pre-revocation generation carries the
                # now-revoked stamp by construction.
                data, src = fenced_load_latest(fj.ckpt_path)
                arrays = {
                    k: data[k] for k in data.files
                    if k not in LEASE_STAMP_KEYS
                }
                fenced_savez(fj.ckpt_path, arrays, lease=self.router_lease)
                self.counters["lease_reseals"] += 1
            except (CheckpointCorrupt, FileNotFoundError, OSError):
                return None  # no intact generation: restart fresh
        else:
            src = latest_generation(fj.ckpt_path)
            if src is None:
                return None
        self._tracer.instant(
            "fleet.restore", cat="fleet", job=fj.id, src=src, trace=fj.trace
        )
        return ResumeToken(fj.ckpt_path)

    def _harvest(self) -> None:
        """Fold finished inner jobs into their fleet jobs. ERROR on a DEAD
        replica is left alone — the death handler requeues it; ERROR on a
        live replica (quarantine, bad model) is a real job failure."""
        with self._lock:
            open_jobs = [
                fj for fj in self._jobs.values()
                if fj.status not in FleetJobStatus.FINISHED
                and fj.handle is not None
            ]
        lost_steals: list = []
        for fj in open_jobs:
            inner = fj.handle._job
            if not inner.event.is_set():
                continue
            if fj.replica in self._dead:
                continue
            with self._lock:
                if fj.status in FleetJobStatus.FINISHED:
                    continue
                if inner.status == JobStatus.DONE:
                    fj.result = inner.result
                    self._finish(fj, FleetJobStatus.DONE)
                elif inner.status == JobStatus.ERROR:
                    r = self.replicas.get(fj.replica)
                    if r is not None and not r.alive:
                        continue  # death handler will requeue
                    fj.error = inner.error
                    self._finish(fj, FleetJobStatus.ERROR)
                elif inner.status == JobStatus.CANCELLED:
                    # A still-ROUTED fleet job whose inner copy is
                    # CANCELLED: a withdraw whose response was lost (a
                    # steal across processes, ROADMAP A item 3; in one
                    # process the steal rebinds the handle in the same
                    # tick, and the router's own cancel finishes the fleet
                    # job first). Recover like any orphan: requeue on the
                    # ring, no job lost.
                    src = fj.replica
                    fj.requeues += 1
                    fj.replica = None
                    fj.handle = None
                    self.counters["requeued_jobs"] += 1
                    lost_steals.append((fj, src))
        for fj, src in lost_steals:
            resume = self._resume_token(fj)
            if resume is not None:
                with self._lock:
                    self.counters["restored_jobs"] += 1
            self._events.emit(
                "job.requeued", job=fj.id, trace=fj.trace, src=src,
                reason="withdraw response lost", restored=resume is not None,
            )
            self._place(fj, resume=resume)

    def _steal(self) -> None:
        """Idle replicas pull still-QUEUED jobs from the most-loaded
        replica (the `job_market.rs` split_and_push analogue at fleet
        scale). A queued job has no table state: the move is an atomic
        withdraw + fresh submit, and the `fleet.steal` fault point fires
        BEFORE the withdrawal so an injected fault leaves the job exactly
        where it was."""
        healthy = sorted(
            (
                r for r in self._healthy()
                # Probation members neither steal nor are stolen from:
                # keys (and work) move back only after promotion.
                if r.idx not in self._probation
            ),
            key=lambda r: r.idx,
        )
        if len(healthy) < 2:
            return
        # A draining member (scale-in in progress) must not PULL work —
        # it is leaving — but its queue stays stealable: the steals are
        # part of the drain.
        idle = [
            r for r in healthy
            if r.idle() and r.idx not in self._draining
        ]
        if not idle:
            return
        with self._lock:
            queued_by_replica: dict[int, list] = {}
            for fj in self._jobs.values():
                if (
                    fj.status in FleetJobStatus.FINISHED
                    or fj.handle is None
                    or fj.replica is None
                ):
                    continue
                if fj.handle._job.status == JobStatus.QUEUED:
                    queued_by_replica.setdefault(fj.replica, []).append(fj)
        for thief in idle:
            victims = [
                (len(v), idx) for idx, v in queued_by_replica.items()
                # Never steal from a SUSPECTED victim: its withdraw call
                # would stall the tick loop against a hung/partitioned
                # process, and if it is truly dead the death handler is
                # about to requeue its whole queue anyway.
                if v and idx != thief.idx and not self._suspect.get(idx)
            ]
            if not victims:
                return
            qlen, v_idx = max(victims)
            victim = self.replicas[v_idx]
            pool = queued_by_replica[v_idx]
            want = max(1, qlen // 2)
            moved = 0
            # Steal from the BACK of the queue (newest first) — the front
            # is about to be admitted where it already sits.
            while pool and moved < want:
                fj = pool.pop()
                try:
                    maybe_fault("fleet.steal", src=v_idx, dst=thief.idx)
                except FaultError:
                    return  # injected steal fault: job stays put
                with self._tracer.span(
                    "router.steal", cat="fleet", job=fj.id, src=v_idx,
                    dst=thief.idx, trace=fj.trace,
                ):
                    if not victim.withdraw(fj.handle.id):
                        continue  # admitted meanwhile: not stealable
                    # A stolen job may itself be a requeue carrying
                    # checkpointed progress (queued on the victim behind
                    # max_resident): the thief must resume from the newest
                    # intact generation, not restart the search (None when
                    # no generation exists yet). Count the restore so the
                    # journal's job.resumed events stay equal to the
                    # restored_jobs counter (the flight-recorder
                    # consistency pin).
                    resume = self._resume_token(fj)
                    if resume is not None:
                        with self._lock:
                            self.counters["restored_jobs"] += 1
                    try:
                        handle = thief.submit(
                            self._spec(fj, resume), fj.ckpt_path
                        )
                    except (FaultError, ReplicaDead):
                        # Thief died mid-steal: the job was already
                        # withdrawn, so place it like any orphan (never
                        # lost) — and account it like one too, so the
                        # journal's job.requeued events stay equal to the
                        # requeued_jobs counter.
                        with self._lock:
                            fj.replica = None
                            fj.handle = None
                            fj.requeues += 1
                            self.counters["requeued_jobs"] += 1
                        self._events.emit(
                            "job.requeued", job=fj.id, trace=fj.trace,
                            src=v_idx, reason="thief died mid-steal",
                        )
                        self._place(fj, resume=resume)
                        continue
                with self._lock:
                    if fj.status in FleetJobStatus.FINISHED:
                        # A fleet-level cancel raced the steal: don't leave
                        # the fresh inner copy running orphaned.
                        try:
                            handle.cancel()
                        except Exception:  # noqa: BLE001 — best-effort reap
                            pass
                        continue
                    fj.replica = thief.idx
                    fj.handle = handle
                    fj.steals += 1
                    self.counters["steals"] += 1
                self._tracer.instant(
                    "fleet.steal", cat="fleet", job=fj.id,
                    src=v_idx, dst=thief.idx, trace=fj.trace,
                )
                self._events.emit(
                    "fleet.steal", job=fj.id, trace=fj.trace,
                    src=v_idx, dst=thief.idx,
                )
                moved += 1

    # -- reporting -------------------------------------------------------------

    def all_done(self) -> bool:
        with self._lock:
            return all(
                fj.status in FleetJobStatus.FINISHED
                for fj in self._jobs.values()
            )

    def stats(self) -> dict:
        """Fleet-level counters (obs/schema.py FLEET_COUNTER_KEYS) — the
        router's `/.status` body and `/metrics` source."""
        with self._lock:
            by_status: dict[str, int] = {}
            for fj in self._jobs.values():
                by_status[fj.status] = by_status.get(fj.status, 0) + 1
            per_replica = {
                str(r.idx): r.snapshot_row()
                for r in self.replicas.values()
            }
            return {
                "replicas": len(self.replicas),
                "healthy": len(self._healthy()),
                "jobs": by_status,
                "queued": sum(
                    row.get("queued", 0) for row in per_replica.values()
                ),
                **self.counters,
                # This process's fencing refusals and rejections (the
                # lease store the in-process replicas share).
                "lease_rejected": (
                    self.lease_store.rejected_total()
                    if self.lease_store is not None else 0
                ),
                "per_replica": per_replica,
                # Last-N flight-recorder events — the `/.status` at-a-
                # glance ring ([] when the fleet journals nothing; the
                # registry's flatten drops it from /metrics, where
                # unbounded label text does not belong).
                "events_recent": self._events.recent(16),
            }

    def metrics(self) -> dict:
        return self.stats()

    def events_tail(
        self, job_id: Optional[int] = None, since: int = 0,
        wait_s: float = 0.0,
    ) -> tuple:
        """Flight-recorder tail over the ROUTER journal (fleet-level job
        ids) — the `GET /jobs/<id>/events` long-poll primitive; replica
        journals are merged offline by obs/timeline.py."""
        return self._events.tail(since=since, job=job_id, wait_s=wait_s)

    def close(self) -> None:
        REGISTRY.unregister(self._metrics_name)
        # Release a chaos plan that adopted this router's recorder (the
        # plan may outlive the fleet; see CheckService.close).
        plan = active_plan()
        if plan is not None and plan.events is self._events:
            plan.events = None


# -- HTTP front door -----------------------------------------------------------


def fleet_status_view(router: FleetRouter) -> dict:
    return {
        **router.stats(),
        "job_rows": [router.poll(jid) for jid in router.job_ids()],
    }


def serve_fleet(
    fleet,
    address: str = "localhost:3500",
    registry=None,
    block: bool = False,
):
    """Start the fleet HTTP front door ("host:port"; port 0 picks a free
    one) and return its handle, service/server.py's `ServiceServer`.
    `fleet` is a ServiceFleet (or anything with a `.router`); models are
    named through a ModelRegistry, as on `serve_service`."""
    import json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from ..obs import render_prometheus
    from .server import RETRY_AFTER_S, ModelRegistry, ServiceServer, events_view

    router = fleet.router
    reg = registry if registry is not None else ModelRegistry()
    host, _, port = address.partition(":")

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, obj, code=200, headers=None):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _text(self, body: str, code=200):
            data = body.encode()
            self.send_response(code)
            self.send_header(
                "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
            )
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _503(self, msg: str) -> None:
            self._json(
                {"error": msg}, 503, headers={"Retry-After": RETRY_AFTER_S}
            )

        def _429(self, e: QuotaExceeded) -> None:
            # Quota rejections are retryable by contract: the Retry-After
            # is computed from the tenant's actual refill rate, so a
            # well-behaved client that honors it succeeds on the retry.
            self._json(
                {"error": str(e), "tenant": e.tenant, "reason": e.reason},
                429,
                headers={"Retry-After": str(e.retry_after_s)},
            )

        def _injected_503(self, method: str) -> bool:
            try:
                maybe_fault("service.http", method=method, path=self.path)
            except FaultError as e:
                # The 503 surface is part of the flight recording: the
                # forensic pass can see the front door bouncing clients.
                router._events.emit(
                    "router.unavailable",
                    reason=f"injected http fault ({method})",
                )
                router._tracer.instant(
                    "router.unavailable", cat="fleet", method=method
                )
                self._503(f"injected fault: {e}")
                return True
            return False

        def _job_id(self, suffix: str = "") -> Optional[int]:
            raw = self.path.partition("?")[0][len("/jobs/"):]
            if suffix:
                if not raw.endswith(suffix):
                    return None
                raw = raw[: -len(suffix)]
            try:
                return int(raw.strip("/"))
            except ValueError:
                return None

        def do_GET(self):
            if self._injected_503("GET"):
                return
            path, _, query = self.path.partition("?")
            try:
                if path == "/.status":
                    self._json(fleet_status_view(router))
                    return
                if path == "/metrics":
                    self._text(render_prometheus(REGISTRY.collect()))
                    return
                if path.startswith("/jobs/"):
                    if path.endswith("/events"):
                        jid = self._job_id("/events")
                        if jid is not None:
                            router._get(jid)  # 404 on unknown jobs
                            self._json(events_view(router, jid, query))
                            return
                    jid = self._job_id()
                    if jid is not None:
                        self._json(router.poll(jid))
                        return
                self._json({"error": "not found"}, 404)
            except KeyError as e:
                self._json({"error": str(e)}, 404)

        def do_POST(self):
            if self._injected_503("POST"):
                return
            try:
                if self.path == "/jobs":
                    n = int(self.headers.get("Content-Length") or 0)
                    try:
                        payload = json.loads(self.rfile.read(n) or b"{}")
                    except ValueError:
                        self._json({"error": "bad JSON body"}, 400)
                        return
                    if "model" not in payload:
                        self._json({"error": "missing 'model'"}, 400)
                        return
                    name = payload["model"]
                    args = dict(payload.get("args") or {})
                    opts = dict(payload.get("opts") or {})
                    tenant = payload.get("tenant") or DEFAULT_TENANT
                    fw = opts.pop("finish_when", None)
                    if fw is not None:
                        opts["finish_when"] = {
                            "all": HasDiscoveries.ALL,
                            "any": HasDiscoveries.ANY,
                            "all_failures": HasDiscoveries.ALL_FAILURES,
                            "any_failures": HasDiscoveries.ANY_FAILURES,
                        }[fw]
                    model = reg.get(name, args)
                    # Stable HTTP route key: registry name + args, so
                    # same-config submissions share a replica's compiled
                    # step across unrelated clients.
                    key = name + "".join(
                        f":{k}={v}" for k, v in sorted(args.items())
                    )
                    try:
                        # model_ref rides along for replicas in other
                        # processes; in-process replicas ignore it.
                        h = router.submit(
                            model, route_key=key,
                            model_ref=(name, args), tenant=tenant, **opts,
                        )
                    except NoHealthyReplica as e:
                        self._503(str(e))
                        return
                    except QuotaExceeded as e:
                        self._429(e)
                        return
                    self._json({"job": h.id})
                    return
                if self.path.startswith("/jobs/") and self.path.endswith(
                    "/cancel"
                ):
                    jid = self._job_id("/cancel")
                    if jid is not None:
                        self._json({"cancelled": router.cancel(jid)})
                        return
                self._json({"error": "not found"}, 404)
            except KeyError as e:
                self._json({"error": str(e)}, 404)
            except Exception as e:  # noqa: BLE001 — bad submits must not kill
                self._json({"error": f"{type(e).__name__}: {e}"}, 400)

    httpd = ThreadingHTTPServer(
        (host or "localhost", int(port or 3500)), Handler
    )
    httpd.daemon_threads = True
    if block:
        server = ServiceServer(httpd, fleet, None)
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()
        return server
    thread = threading.Thread(target=httpd.serve_forever, daemon=True, name="fleet-http")
    thread.start()
    return ServiceServer(httpd, fleet, thread)
