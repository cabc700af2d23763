"""Replica runners and the ServiceFleet assembly: a router front door over
N CheckService replicas in one process (the JAX package's
`service/fleet.py`, its in-process half).

A `Replica` wraps one CheckService (one shared device table) in a
crash-only runner: it pumps the service's scheduling rounds, checkpoints
its journaled jobs through the fenced checkpoint plane
(faults/ckptio.py `fenced_savez`: every write leaves a verified ``.prev``
generation), and dies on the first unhandled fault, the injected
``fleet.replica_crash`` included. Recovery is never the replica's
business: the `FleetRouter` (service/router.py) sees the death through its
health probes and requeues the replica's jobs on survivors from their
newest intact checkpoint generation, where each job's journal is re-seeded
into the survivor's table through the insert kernel.

`ServiceFleet` is the assembly: N replicas, one router, and in background
mode one runner thread per replica (each sets its service's card before
its first step) and one router thread. Foreground mode
(`background=False`) runs no thread: tests drive the fleet
deterministically with `pump()` / `drain()`.

    fleet = ServiceFleet(n_replicas=3, service_kwargs=dict(
        batch_size=8192, table_log2=24))
    h = fleet.submit(model, timeout=600)
    r = h.result()          # survives any single replica's death
    serve_fleet(fleet)      # HTTP: POST /jobs, /.status, /metrics

Not ported yet, and refused with `NotImplementedError`: replicas in other
processes (`remote=True`, `store_root=`) and the autoscaler's `scale_out` /
`scale_in` (ROADMAP A item 3), and the warm-start corpus (`corpus_dir=`,
ROADMAP A12).
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Callable, Optional

from ..faults.blobstore import WIRE_ITEM, normalize_root, refuse_wire
from ..faults.ckptio import fenced_savez
from ..faults.plan import FaultError, maybe_fault
from ..obs import EventJournal, as_events, as_tracer
from .api import CheckService
from .lease import FencedEvents, LeaseRevoked, LeaseStore, load_fenced_resume
from .queue import JobResume, JobStatus
from .router import FleetRouter, ReplicaDead, ResumeToken, lease_member, serve_fleet

__all__ = ["Replica", "ServiceFleet", "serve_fleet"]


class Replica:
    """One CheckService behind a crash-only runner. The service runs
    foreground: this object pumps it, so the chaos plane has one seam
    (``fleet.replica_crash``) to kill the whole replica through, and a
    foreground fleet drives it deterministically."""

    def __init__(
        self,
        idx: int,
        service_factory: Callable[[], CheckService],
        ckpt_every_spins: int = 1,
        pump_rounds: int = 4,
        tracer=None,
        events=None,
        lease=None,
    ):
        self.idx = idx
        self.service = service_factory()
        self.ckpt_every_spins = ckpt_every_spins
        self.pump_rounds = pump_rounds
        # The epoch fence (service/lease.py): every checkpoint generation
        # this runner writes is re-validated against and stamped with this
        # lease, so a replica the router fenced out refuses its own writes.
        self.lease = lease
        self.error: Optional[str] = None
        self._dead = False
        self._spins = 0
        self._ckpt_paths: dict[int, str] = {}  # inner job id -> checkpoint path
        self._tracer = as_tracer(tracer)
        # The journal this replica's CheckService shares: the runner adds
        # `ckpt.write` events and flushes it when the replica dies.
        self._events = as_events(events)
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._wake = threading.Condition()

    # -- the router's surface --------------------------------------------------

    @property
    def alive(self) -> bool:
        return not self._dead

    def submit(self, spec: dict, ckpt_path: Optional[str] = None):
        """Submit one job spec (CheckService.submit's keywords) to this
        replica and register its checkpoint path. A `ResumeToken` is
        resolved here, through the fenced loader: a zombie's stale
        generation is rejected and the one before it serves. Raises
        ReplicaDead on a dead replica."""
        if self._dead:
            raise ReplicaDead(f"replica {self.idx} is dead ({self.error})")
        spec = dict(spec)
        spec.pop("model_ref", None)  # in-process: the model object rides along
        if isinstance(spec.get("resume"), ResumeToken):
            spec["resume"] = self._resolve_resume(spec["resume"])
        handle = self.service.submit(**spec)
        if ckpt_path is not None:
            self._ckpt_paths[handle.id] = ckpt_path
        with self._wake:
            self._wake.notify_all()
        return handle

    def _resolve_resume(self, token: ResumeToken) -> Optional[JobResume]:
        """ResumeToken -> JobResume through the fenced loader; None (a
        fresh restart, still exact) when no generation passes."""
        return load_fenced_resume(token.path,
                                  self.lease.store if self.lease is not None else None)

    def withdraw(self, inner_job_id: int) -> bool:
        """Work stealing: remove a still-queued job (CheckService.withdraw)."""
        if self._dead:
            return False
        return self.service.withdraw(inner_job_id)

    def probe(self) -> dict:
        """The health probe: raises on a dead replica, answers cheap live
        counters otherwise. Lock-free, so a busy replica reads healthy; a
        wedged one is caught by the router's probe deadline (the
        ``fleet.replica_hang`` point parks here). ``fleet.partition`` fires
        here too: the router loses this replica while it keeps running,
        the false death the lease fence covers."""
        maybe_fault("fleet.partition", replica=self.idx)
        maybe_fault("fleet.replica_hang", replica=self.idx)
        if self._dead:
            raise ReplicaDead(f"replica {self.idx} is dead ({self.error})")
        failed = self.service._failed
        if failed:
            raise ReplicaDead(f"replica {self.idx} service failed: {failed}")
        return {
            "replica": self.idx,
            "queued": len(self.service._adm),
            "device_steps": self.service._engine.total_steps,
            **self._signal_row(),
        }

    def _signal_row(self) -> dict:
        """Lane utilisation and p99 admission wait, read without the
        service lock; a racy read of the wait deque is an empty sample."""
        svc = self.service
        try:
            waits = sorted(svc._queue_waits)
        except RuntimeError:  # the deque changed under the read
            waits = []
        p99 = 0.0
        if waits:
            p99 = round(waits[min(len(waits) - 1, int(0.99 * len(waits)))] * 1e3, 3)
        return {"lane_util": round(svc._engine.lane_util(), 4), "adm_p99_ms": p99}

    def idle(self) -> bool:
        """True when nothing is queued or runnable here: may this replica
        steal (CheckService._has_work without the lock)."""
        if self._dead:
            return False
        svc = self.service
        if len(svc._adm):
            return False
        try:
            return not any(g.runnable() for g in svc._engine.groups.values())
        except RuntimeError:  # the dict changed under the walk: busy
            return False

    def snapshot_row(self) -> dict:
        """One `/.status` row; a dead replica reports its liveness only."""
        if self._dead:
            return {"alive": 0, "error": self.error}
        svc = self.service
        return {
            "alive": 1,
            "queued": len(svc._adm),
            "jobs": len(svc._jobs),
            "device_steps": svc._engine.total_steps,
            "spins": self._spins,
            **self._signal_row(),
        }

    # -- the crash-only runner -------------------------------------------------

    def spin(self) -> int:
        """One runner turn: the chaos seam, a bounded pump, the checkpoint
        cadence. Returns the rounds that ran a step; any fault kills the
        replica (recovery is the router's)."""
        if self._dead:
            return 0
        try:
            # Before the pump, so the last generation written is a sound
            # resume point.
            maybe_fault("fleet.replica_crash", replica=self.idx)
            ran = self.service.pump(self.pump_rounds)
            self._spins += 1
            if self._spins % self.ckpt_every_spins == 0:
                self._checkpoint_jobs()
            return ran
        except Exception as e:  # noqa: BLE001 — crash-only: die, never limp
            self._die(e)
            return 0

    def _die(self, e: BaseException) -> None:
        self._dead = True
        self.error = f"{type(e).__name__}: {e}"
        self._tracer.instant("fleet.replica_crash", cat="fleet", replica=self.idx,
                             error=type(e).__name__)
        # The journal tail and the partial trace reach the disk now: this
        # runner never runs again. (The `replica.crash` event is the
        # router's, the one authority on membership.)
        self._events.flush()
        self._tracer.flush()

    def _checkpoint_jobs(self) -> None:
        """One fenced generation per running journaled job: the snapshot
        under the service lock, the write outside it."""
        for jid, path in list(self._ckpt_paths.items()):
            job = self.service._jobs.get(jid)
            if job is None or job.status in JobStatus.FINISHED:
                self._ckpt_paths.pop(jid, None)
                continue
            if job.status != JobStatus.RUNNING or job.journal is None:
                continue
            with self.service._lock:
                arrays = job.fleet_snapshot()
            try:
                with self._tracer.span("ckpt.write", cat="fleet", job=jid,
                                       replica=self.idx, trace=job.trace):
                    fenced_savez(path, arrays, lease=self.lease)
            except LeaseRevoked as e:
                # The router fenced this replica out (we are the zombie):
                # record the refusal and die; a fenced replica never writes
                # again.
                self._events.emit(
                    "lease.reject", member=lease_member(self.idx),
                    epoch=self.lease.epoch if self.lease else 0,
                    surface="write", job=jid, trace=job.trace,
                )
                self._die(e)
                return
            self._events.emit("ckpt.write", job=jid, trace=job.trace, replica=self.idx)

    def _drive(self) -> None:
        cuda_index = self.service._cuda_index
        if cuda_index is not None:
            # A new thread starts on card 0: step on the service's card.
            import torch

            torch.cuda.set_device(cuda_index)
        while not self._stop and not self._dead:
            ran = self.spin()
            if not ran and not self._stop:
                with self._wake:
                    self._wake.wait(timeout=0.002)

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._drive, daemon=True,
                                            name=f"fleet-replica{self.idx}")
            self._thread.start()

    def stop(self) -> None:
        self._stop = True
        with self._wake:
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def close(self) -> None:
        self.stop()
        if not self._dead:
            self.service.close()
        else:
            # Crash semantics keep the service's state, but its table and
            # store still hold memory and the store a thread.
            self.service._engine.close()


class ServiceFleet:
    """N CheckService replicas behind one consistent-hash router: replica
    death is routine (requeue and resume from the checkpoint plane),
    imbalance is routine (work stealing), and the fleet reports through
    one `/.status` and `/metrics`."""

    def __init__(
        self,
        n_replicas: int = 2,
        service_kwargs: Optional[dict] = None,
        router_kwargs: Optional[dict] = None,
        ckpt_dir: Optional[str] = None,
        ckpt_every_spins: int = 1,
        pump_rounds: int = 4,
        max_resident: Optional[int] = 8,
        background: bool = True,
        tracer=None,
        journal_dir: Optional[str] = None,
        corpus_dir: Optional[str] = None,
        lease_dir: Optional[str] = None,
        remote: bool = False,
        store_root: Optional[str] = None,
        quotas=None,
    ):
        """`service_kwargs` configure every replica's CheckService
        (batch_size, table_log2, store, device, ...); with no `device` the
        services run on the CUDA card, and raise without one.
        `max_resident` bounds each replica's admitted jobs, so overload
        shows as queue depth, which work stealing feeds on. `ckpt_dir`
        (default: a managed temporary directory) holds the per-job
        requeue generations; `ckpt_every_spins` is the runner's
        checkpoint cadence in spins of `pump_rounds` rounds.

        `journal_dir` turns on the flight recorder: the router journals to
        `<journal_dir>/router.jsonl` and each replica to
        `<journal_dir>/replica<i>.jsonl`, keyed by the trace id the router
        mints — the input of ``python -m stateright_tpu_torch.obs.timeline``.

        `lease_dir` turns on the epoch-fenced lease plane: the router grants
        a lease per replica, revokes it before requeueing a dead replica's
        jobs, and every replica write re-validates its lease.

        `quotas` (service/tenancy.py `TenantQuotas`) gates submissions at
        the router; the replicas share the ledger for charging, ungated.

        `remote=True` and `store_root=` (replicas in other processes) raise
        `NotImplementedError` naming ROADMAP A item 3, `corpus_dir=` naming
        A12. The dirs are local paths: a wire-store URI raises too."""
        if remote or store_root is not None:
            raise NotImplementedError(
                f"fleet replicas in other processes (remote=True, store_root=) are {WIRE_ITEM}")
        if corpus_dir is not None:
            raise NotImplementedError(
                "the warm-start corpus (corpus_dir=) is not ported yet (ROADMAP A12)")
        if n_replicas < 1:
            raise ValueError("a fleet needs at least one replica")
        ckpt_dir, journal_dir, lease_dir = (
            normalize_root(d) for d in (ckpt_dir, journal_dir, lease_dir))
        for what, d in (("ckpt_dir", ckpt_dir), ("journal_dir", journal_dir),
                        ("lease_dir", lease_dir)):
            if d is not None:
                refuse_wire(d, what)
        self._tracer = as_tracer(tracer)
        self._tracer_raw = tracer
        self._tmpdir = None
        if ckpt_dir is None:
            self._tmpdir = tempfile.TemporaryDirectory(prefix="srtpu-fleet-")
            ckpt_dir = self._tmpdir.name
        os.makedirs(ckpt_dir, exist_ok=True)
        self.journal_dir = journal_dir
        self._journals: list = []
        router_journal = None
        if journal_dir is not None:
            os.makedirs(journal_dir, exist_ok=True)
            router_journal = EventJournal(os.path.join(journal_dir, "router.jsonl"),
                                          writer="router")
            self._journals.append(router_journal)
        # The lease plane: every grant happens here, before a replica runs.
        self.lease_store = None
        router_lease = None
        if lease_dir is not None:
            self.lease_store = LeaseStore(lease_dir)
            router_lease = self.lease_store.grant("router")
        kw = dict(service_kwargs or {})
        kw.setdefault("max_resident", max_resident)
        self.quotas = quotas
        if quotas is not None:
            # One lane-seconds ledger for every replica, charging only: the
            # router is the admission gate (a requeued job must not bounce
            # off a budget its first admission passed).
            kw["quotas"] = quotas
            kw["quota_gate"] = False
        kw["background"] = False  # the Replica runner pumps
        self._service_kw = kw
        self._ckpt_every_spins = ckpt_every_spins
        self._pump_rounds = pump_rounds
        self._retired: list = []  # dead incarnations replaced by rejoins
        self._incarnations: dict = {}  # idx -> rejoin count (lease-less)
        # Serialises rejoin_replica whole: a second grant for one member
        # would revoke the first incarnation's epoch and fence the winner.
        self._rejoin_lock = threading.Lock()
        self.replicas = [self._make_replica(i) for i in range(n_replicas)]
        self.router = FleetRouter(
            self.replicas,
            background=background,
            ckpt_dir=ckpt_dir,
            tracer=tracer,
            events=router_journal,
            lease_store=self.lease_store,
            router_lease=router_lease,
            quotas=quotas,
            **(router_kwargs or {}),
        )
        self.background = background
        self._closed = False
        self._router_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        if background:
            for r in self.replicas:
                r.start()
            self._router_thread = threading.Thread(target=self._supervise, daemon=True,
                                                   name="fleet-router")
            self._router_thread.start()

    def _make_replica(self, i: int, rejoin: bool = False) -> Replica:
        """One Replica runner (a fresh service and lease epoch). A rejoined
        incarnation journals to a file of its own under the writer name
        ``replica<i>@e<epoch>``: each writer's seq order stays monotonic
        across the restart, and the timeline's fence tells the fenced old
        incarnation from this one by epoch."""
        member = lease_member(i)
        lease = self.lease_store.grant(member) if self.lease_store is not None else None
        writer, fname = member, f"replica{i}.jsonl"
        if rejoin:
            n = lease.epoch if lease is not None else self._incarnations.get(i, 1) + 1
            self._incarnations[i] = n
            writer, fname = f"{member}@e{n}", f"replica{i}.e{n}.jsonl"
        journal = None
        if self.journal_dir is not None:
            journal = EventJournal(os.path.join(self.journal_dir, fname), writer=writer)
            self._journals.append(journal)
            if lease is not None:
                # A fenced-out replica can no longer journal admissions or
                # verdicts the timeline would trust.
                journal = FencedEvents(journal, lease)
        return Replica(
            i,
            lambda: CheckService(events=journal, **self._service_kw),
            ckpt_every_spins=self._ckpt_every_spins,
            pump_rounds=self._pump_rounds,
            tracer=self._tracer_raw,
            events=journal,
            lease=lease,
        )

    # -- rejoin ------------------------------------------------------------------

    def rejoin_replica(self, idx: int) -> bool:
        """Re-admit a dead or fenced member as a fresh incarnation: a fresh
        lease epoch, a fresh runner and service, handed to
        `FleetRouter.rejoin`, which holds it in probation until it answers
        its probes, then moves its keys back. Returns False when the member
        is not dead, or when the ``fleet.rejoin`` chaos point aborted the
        rejoin (before the grant: nothing changed)."""
        with self._rejoin_lock:
            old = self.replicas[idx]
            if idx not in self.router._dead:
                return False  # only a member the router declared dead rejoins
            try:
                maybe_fault("fleet.rejoin", replica=idx)
            except FaultError:
                return False
            new = self._make_replica(idx, rejoin=True)
            if not self.router.rejoin(new):
                new.close()
                return False
            self.replicas[idx] = new
            self._retired.append(old)
            if self.background:
                new.start()
            if self.lease_store is not None:
                member = lease_member(idx)
                epoch, _state = self.lease_store.state(member)
                self.router._events.emit("lease.grant", member=member, epoch=epoch)
            return True

    def scale_out(self) -> Optional[int]:
        """The autoscaler's grow: ROADMAP A item 3, not ported yet."""
        raise NotImplementedError(f"fleet autoscaling (scale_out) is {WIRE_ITEM}")

    def scale_in(self, idx: Optional[int] = None) -> Optional[int]:
        """The autoscaler's shrink: ROADMAP A item 3, not ported yet."""
        raise NotImplementedError(f"fleet autoscaling (scale_in) is {WIRE_ITEM}")

    # -- the client surface --------------------------------------------------------

    def submit(self, model, **opts):
        return self.router.submit(model, **opts)

    def stats(self) -> dict:
        return self.router.stats()

    def store_stats(self) -> Optional[dict]:
        rows = [r.service.store_stats() for r in self.replicas if r.alive]
        rows = [s for s in rows if s]
        return rows[0] if len(rows) == 1 else (rows or None)

    # -- foreground driving ------------------------------------------------------

    def pump(self, rounds: int = 1) -> int:
        """Foreground mode: spin every live replica, then one router tick,
        per round; returns how many spins ran a step."""
        ran = 0
        for _ in range(rounds):
            for r in self.replicas:
                if r.alive:
                    ran += 1 if r.spin() else 0
            self.router.tick()
        return ran

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every fleet job has finished (requeues included)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self.router.all_done():
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("fleet drain timed out")
            if self.background:
                time.sleep(0.005)  # the router and replica threads work
            else:
                self.pump(4)

    def _supervise(self) -> None:
        while not self._stop.is_set():
            self.router.tick()
            self._stop.wait(timeout=0.01)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        if self._router_thread is not None:
            self._router_thread.join(timeout=5.0)
            self._router_thread = None
        for r in list(self.replicas) + self._retired:
            r.close()
        self.router.close()
        for j in self._journals:
            j.close()
        if self.lease_store is not None:
            self.lease_store.close()
        if self._tmpdir is not None:
            self._tmpdir.cleanup()
            self._tmpdir = None
