"""Replica runners and the ServiceFleet assembly: a router front door over
N CheckService replicas, in this process or each in a process of its own
(the JAX package's `service/fleet.py`).

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

`corpus_dir=` gives every replica the warm-start corpus over one shared
directory (store/corpus.py): the first replica to finish a content key
publishes it, and every replica warm-starts from that one generation; a
requeued job looks in the corpus again on its survivor.

`remote=True` runs each replica as a `replica_main` process
(service/replica_main.py) over one shared store root, a directory or a
wire-store URI, behind `RemoteReplica` stubs (service/remote.py): a kill -9
of one process is a replica death the router recovers like any other.
`scale_out` / `scale_in` grow and shrink either kind of fleet (the
autoscaler's actions, service/autoscale.py).
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Callable, Optional

from ..faults.blobstore import is_blob_uri, normalize_root
from ..faults.ckptio import fenced_savez
from ..faults.plan import FaultError, maybe_fault
from ..obs import EventJournal, as_events, as_tracer
from .api import CheckService
from .lease import FencedEvents, LeaseRevoked, LeaseStore, load_fenced_resume
from .queue import JobResume, JobStatus
from .router import (
    FleetJobStatus,
    FleetRouter,
    ReplicaDead,
    ResumeToken,
    lease_member,
    serve_fleet,
)

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
        if lease is not None:
            corpus = getattr(self.service._engine, "_corpus", None)
            if corpus is not None:
                # The corpus's publishes are fenced by the same lease: a
                # fenced-out replica never publishes, and an entry stamped by
                # a revoked epoch is never read.
                corpus.set_lease(lease)
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

    def retire_runner(self) -> None:
        """The local teardown after the router's scale-in drain
        (`FleetRouter.retire` already revoked the lease and requeued every
        fleet job): stop pumping, close the service, and read as not alive
        from here on, without `_die`'s crash record: a retirement is a
        decision, not a failure."""
        self.stop()
        if self._dead:
            return
        try:
            self.service.close()
        except Exception:  # noqa: BLE001 — best-effort teardown
            pass
        self._dead = True
        self.error = "retired (scale-in)"


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
        spawn_timeout_s: float = 180.0,
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

        `corpus_dir` turns on the warm-start corpus on every replica over
        the one shared directory (store/corpus.py; the replicas' services
        need `store="tiered"`, which the fleet sets unless `service_kwargs`
        names a store); with a lease plane, each replica's publishes are
        fenced by its lease.

        `remote=True` runs every replica as a process of its own: N
        `replica_main` processes, each an HTTP server over a `Replica`
        runner, sharing `store_root` (checkpoints, journals, leases, member
        records, the corpus; a managed temporary directory when None) and
        driven through `RemoteReplica` stubs behind the same router. The
        lease plane and the journals are always on in a remote fleet: they
        are what make a death declared across processes sound. A remote
        fleet runs in the background only. Submissions name their model by
        `model_ref=(registry name, args)` (serve_fleet fills it in), since
        model objects cannot cross a process boundary. The device in
        `service_kwargs` must be a string ("cuda", "cpu"); a child with no
        device runs on the card. `spawn_timeout_s` bounds one child's boot.

        `store_root` and every *_dir may be a wire-store URI (``blob://``,
        ``s3://``, ``gs://``, faults/blobstore.py): the durable state then
        lives in the object store, and the root URI is all the processes
        share. Journals are written locally, in a scratch directory that
        also holds the children's logs, and mirrored to the root at flush
        boundaries."""
        if n_replicas < 1:
            raise ValueError("a fleet needs at least one replica")
        self._tracer = as_tracer(tracer)
        self._tracer_raw = tracer
        self._tmpdir = None
        self._scratch_tmp = None
        self.remote = bool(remote)
        store_root, ckpt_dir, journal_dir, lease_dir, corpus_dir = (
            normalize_root(d) for d in (store_root, ckpt_dir, journal_dir, lease_dir, corpus_dir))
        self.store_root = store_root
        self.scratch_dir: Optional[str] = None
        if remote:
            if not background:
                raise ValueError("a remote fleet runs in the background only (replica "
                                 "processes cannot be pumped from here)")
            if store_root is None:
                self._tmpdir = tempfile.TemporaryDirectory(prefix="srtpu-fleet-root-")
                self.store_root = store_root = self._tmpdir.name
            if is_blob_uri(store_root):
                # The wire root holds the shared state; the children's logs
                # and the local halves of the journals need a directory here.
                self._scratch_tmp = tempfile.TemporaryDirectory(prefix="srtpu-fleet-scratch-")
                self.scratch_dir = self._scratch_tmp.name
            else:
                os.makedirs(store_root, exist_ok=True)
                self.scratch_dir = store_root
            ckpt_dir = ckpt_dir or os.path.join(store_root, "ckpt")
            journal_dir = journal_dir or os.path.join(store_root, "journal")
            lease_dir = lease_dir or os.path.join(store_root, "leases")
            if corpus_dir is None and "corpus_dir" in (service_kwargs or {}):
                corpus_dir = normalize_root((service_kwargs or {}).get("corpus_dir"))
        if ckpt_dir is None:
            self._tmpdir = tempfile.TemporaryDirectory(prefix="srtpu-fleet-")
            ckpt_dir = self._tmpdir.name
        if not is_blob_uri(ckpt_dir):
            os.makedirs(ckpt_dir, exist_ok=True)
        self.journal_dir = journal_dir
        self._journals: list = []
        router_journal = None
        if journal_dir is not None:
            jpath, jsync = self._journal_path("router.jsonl")
            router_journal = EventJournal(jpath, writer="router", sync_uri=jsync)
            self._journals.append(router_journal)
        # The lease plane: every grant happens here, before a replica runs.
        self.lease_store = None
        router_lease = None
        if lease_dir is not None:
            self.lease_store = LeaseStore(lease_dir)
            router_lease = self.lease_store.grant("router")
        kw = dict(service_kwargs or {})
        kw.setdefault("max_resident", max_resident)
        if remote:
            from .remote import check_service_kwargs

            check_service_kwargs(kw)  # the device crosses as a string
        self.quotas = quotas
        if quotas is not None and not remote:
            # One lane-seconds ledger for every replica, charging only: the
            # router is the admission gate (a requeued job must not bounce
            # off a budget its first admission passed).
            kw["quotas"] = quotas
            kw["quota_gate"] = False
        if corpus_dir is not None:
            if not is_blob_uri(corpus_dir):
                os.makedirs(corpus_dir, exist_ok=True)
            kw["corpus_dir"] = corpus_dir
            kw.setdefault("store", "tiered")
        self.corpus_dir = corpus_dir
        kw["background"] = False  # the Replica runner pumps
        self._service_kw = kw
        self._ckpt_every_spins = ckpt_every_spins
        self._pump_rounds = pump_rounds
        self._spawn_timeout_s = spawn_timeout_s
        self._retired: list = []  # dead incarnations replaced by rejoins
        self._incarnations: dict = {}  # idx -> rejoin count (lease-less)
        # Serialises rejoin_replica, scale_out and scale_in whole: a second
        # grant for one member would revoke the first incarnation's epoch
        # and fence the winner.
        self._rejoin_lock = threading.Lock()
        self._procs: list = []
        if remote:
            self.replicas = []
            try:
                # Every child boots at once, and their member records are
                # watched together.
                started = [self._start_remote(i) for i in range(n_replicas)]
                self.replicas = self._await_remote(started)
            except BaseException:
                # Nobody calls close() on a constructor that raised: stop
                # the children that did come up.
                self._kill_procs()
                for j in self._journals:
                    j.close()
                self.lease_store.close()
                for tmp in (self._scratch_tmp, self._tmpdir):
                    if tmp is not None:
                        tmp.cleanup()
                raise
        else:
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

    def _journal_path(self, name: str) -> tuple:
        """(local path, wire sync URI or None) of one journal: journals are
        written locally (an emit never waits on the network); on a wire
        journal root the file lives in the scratch directory and is
        mirrored to the root at flush boundaries."""
        jd = self.journal_dir
        if not is_blob_uri(jd):
            os.makedirs(jd, exist_ok=True)
            return os.path.join(jd, name), None
        if self.scratch_dir is None:
            self._scratch_tmp = tempfile.TemporaryDirectory(prefix="srtpu-fleet-scratch-")
            self.scratch_dir = self._scratch_tmp.name
        local_dir = os.path.join(self.scratch_dir, "journal")
        os.makedirs(local_dir, exist_ok=True)
        return os.path.join(local_dir, name), os.path.join(jd, name)

    def _spawn_remote(self, i: int, rejoin: bool = False):
        """Grant member `i` a fresh lease, start its replica process and
        wait for its member record: the router's `RemoteReplica` stub. A
        rejoined incarnation journals under its fresh epoch."""
        return self._await_remote([self._start_remote(i, rejoin)])[0]

    def _start_remote(self, i: int, rejoin: bool = False) -> tuple:
        from .remote import start_replica_proc

        lease = self.lease_store.grant(lease_member(i))
        t0 = time.monotonic()
        proc, log_path = start_replica_proc(
            i, self.store_root, self._service_kw, scratch=self.scratch_dir,
            incarnation=lease.epoch if rejoin else None)
        self._procs.append(proc)
        return i, proc, log_path, t0

    def _await_remote(self, started: list) -> list:
        """The `RemoteReplica` of each started process, once each has
        published its member record (all are watched at once, so children
        that boot side by side are ready side by side). Each stub's
        `boot_s` is its process's seconds from start to record."""
        from .discovery import MemberDirectory
        from .remote import RemoteReplica, poll_replica_proc

        directory = MemberDirectory(self.store_root)
        urls: dict = {}
        deadline = time.monotonic() + self._spawn_timeout_s
        while len(urls) < len(started):
            for i, proc, log_path, t0 in started:
                if i not in urls:
                    url = poll_replica_proc(i, directory, proc, log_path)
                    if url is not None:
                        urls[i] = (url, time.monotonic() - t0)
            if len(urls) < len(started):
                if time.monotonic() > deadline:
                    late = [i for i, *_ in started if i not in urls]
                    raise TimeoutError(f"replicas {late} published no member record "
                                       f"within {self._spawn_timeout_s:.0f}s")
                time.sleep(0.05)
        out = []
        for i, proc, _log, _t0 in started:
            rr = RemoteReplica(i, urls[i][0], proc=proc, tracer=self._tracer_raw,
                               store_root=self.store_root)
            rr.boot_s = urls[i][1]
            out.append(rr)
        return out

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
            path, sync = self._journal_path(fname)
            journal = EventJournal(path, writer=writer, sync_uri=sync)
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
        lease epoch and a fresh runner and service (in a remote fleet, a
        fresh process, which publishes a fresh member record, journaling
        under ``replica<i>@e<epoch>``), handed to `FleetRouter.rejoin`,
        which holds it in probation until it answers its probes, then moves
        its keys back. The old incarnation may still run (a zombie): the
        fresh epoch fences its writes. Returns False when the member is not
        dead, or when the ``fleet.rejoin`` chaos point aborted the rejoin
        (before the grant: nothing changed)."""
        with self._rejoin_lock:
            old = self.replicas[idx]
            if idx not in self.router._dead:
                return False  # only a member the router declared dead rejoins
            try:
                maybe_fault("fleet.rejoin", replica=idx)
            except FaultError:
                return False
            if self.remote:
                new = self._spawn_remote(idx, rejoin=True)
            else:
                new = self._make_replica(idx, rejoin=True)
            if not self.router.rejoin(new):
                self._discard(new)
                return False
            self.replicas[idx] = new
            self._retired.append(old)
            self._granted(idx, new)
            return True

    def _discard(self, new) -> None:
        """Tear down an incarnation the router refused: nothing leaks."""
        proc = getattr(new, "proc", None)
        if proc is not None:
            self._kill_one(proc)
        else:
            new.close()

    def _granted(self, idx: int, new) -> None:
        """Start a member the router took, and journal its grant."""
        if self.background:
            new.start()
        if self.lease_store is not None:
            member = lease_member(idx)
            epoch, _state = self.lease_store.state(member)
            self.router._events.emit("lease.grant", member=member, epoch=epoch)

    # -- autoscaling (service/autoscale.py drives these) -------------------------

    def scale_out(self) -> Optional[int]:
        """Grow the fleet by one replica at the next free index. The new
        member enters through `FleetRouter.rejoin`'s door for a brand-new
        index: registered, leased and probed, but held in probation like a
        rejoined one. Journals `fleet.scale_out`, counts `scale_outs`.
        Returns the new index, or None when the ``fleet.autoscale`` chaos
        point aborted the grow; it fires first, before the grant and the
        spawn, so a fault changes nothing."""
        with self._rejoin_lock:
            try:
                maybe_fault("fleet.autoscale", action="scale_out")
            except FaultError:
                return None
            idx = len(self.replicas)
            new = self._spawn_remote(idx) if self.remote else self._make_replica(idx)
            if not self.router.rejoin(new):
                self._discard(new)
                return None
            self.replicas.append(new)
            self._granted(idx, new)
            return idx

    def scale_in(self, idx: Optional[int] = None) -> Optional[int]:
        """Retire one replica, by default the least-loaded healthy member
        (a tie retires the newest index). Loss-free: an in-process
        replica's running journaled jobs get one last checkpoint generation
        (a replica process writes one every spin), then `FleetRouter.retire`
        revokes the lease and drains the backlog onto the survivors,
        resumed where a generation exists, and only then is the runner or
        process stopped. Journals `fleet.scale_in`, counts `scale_ins`.
        Returns the retired index, or None when no member is eligible (the
        last healthy one never is) or the ``fleet.autoscale`` chaos point
        aborted it (first, so a fault changes nothing). The slot stays in
        `replicas`, reported dead: a later scale_out grows at the next
        index, and `rejoin_replica` can bring this one back."""
        with self._rejoin_lock:
            try:
                maybe_fault("fleet.autoscale", action="scale_in")
            except FaultError:
                return None
            if idx is None:
                idx = self._scale_in_candidate()
            if idx is None or not (0 <= idx < len(self.replicas)):
                return None
            r = self.replicas[idx]
            if not self.remote and r.alive:
                # The last flush comes before the revoke inside retire():
                # after it this runner's writes refuse themselves, and the
                # drain would restart its jobs instead of resuming them.
                try:
                    r._checkpoint_jobs()
                except Exception:  # noqa: BLE001 — best-effort flush
                    pass
            if not self.router.retire(idx):
                return None
            if self.remote:
                r.stop()  # the completion mirror: its handles were requeued
                if r.proc is not None:
                    self._kill_one(r.proc)
            else:
                r.retire_runner()
            return idx

    def _scale_in_candidate(self) -> Optional[int]:
        """The least-loaded healthy member by unfinished fleet jobs; members
        in probation or draining are mid-transition and ineligible, and the
        last healthy member is never a candidate."""
        router = self.router
        with router._lock:
            live = [i for i in router.replicas
                    if i not in router._dead and i not in router._draining
                    and i not in router._probation and router.replicas[i].alive]
            if len(live) <= 1:
                return None
            load: dict[int, int] = {}
            for fj in router._jobs.values():
                if fj.status not in FleetJobStatus.FINISHED and fj.replica is not None:
                    load[fj.replica] = load.get(fj.replica, 0) + 1
        return min(live, key=lambda i: (load.get(i, 0), -i))

    # -- the client surface --------------------------------------------------------

    def submit(self, model, **opts):
        return self.router.submit(model, **opts)

    def stats(self) -> dict:
        return self.router.stats()

    def store_stats(self) -> Optional[dict]:
        rows = [r.service.store_stats() for r in self.replicas
                if r.alive and getattr(r, "service", None) is not None]
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

    @staticmethod
    def _kill_one(p) -> None:
        """SIGTERM first (the child drains and flushes its journal), then
        the hard kill: teardown never hangs on a wedged child."""
        try:
            if p.poll() is None:
                p.terminate()
                p.wait(timeout=10.0)
        except Exception:  # noqa: BLE001 — best-effort teardown
            pass
        try:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=5.0)
        except Exception:  # noqa: BLE001 — best-effort teardown
            pass

    def _kill_procs(self) -> None:
        """Stop every replica process, rejoined incarnations included."""
        for p in self._procs:
            self._kill_one(p)

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
        self._kill_procs()
        for j in self._journals:
            j.close()
        if self.lease_store is not None:
            self.lease_store.close()
        for attr in ("_scratch_tmp", "_tmpdir"):
            tmp = getattr(self, attr)
            if tmp is not None:
                tmp.cleanup()
                setattr(self, attr, None)
